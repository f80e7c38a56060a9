"""Distributed pieces of the port: the serving mesh's replica groups
(``collectives``) and sharded groups (``sharding``), replica fault handling
(``fault_tolerance``) and checkpoints (``checkpoint``)."""
