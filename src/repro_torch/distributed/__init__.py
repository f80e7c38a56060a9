"""Distributed pieces of the port: replica fault handling
(``fault_tolerance``) for the serving scheduler."""
