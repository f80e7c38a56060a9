"""SMOL core on torch: the DAG optimizer, cost model, placement and planner
(numpy copies of ``repro.core``), the device compiler and the pipelined
engine (torch)."""
