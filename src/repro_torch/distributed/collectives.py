"""Replica groups of the serving mesh.

The training mesh's collectives (the reference's ``ring_allreduce`` and
``psum_in_chunks``) are not ported yet.
"""

from __future__ import annotations


def replica_groups(devices, num_replicas: int):
    """Partition ``devices`` into ``num_replicas`` contiguous equal groups.

    The serving mesh's layout: replica r owns ``devices[r*g:(r+1)*g]``
    (g = len(devices) // num_replicas).  A group of one device holds a
    plain replicated program; a larger group shards one program across its
    members.  Surplus devices past ``num_replicas * g`` stay unused.
    """
    if num_replicas < 1:
        raise ValueError(f"num_replicas must be >= 1, got {num_replicas}")
    devices = list(devices)
    if len(devices) < num_replicas:
        raise ValueError(
            f"{len(devices)} device(s) cannot host {num_replicas} replicas"
        )
    group = len(devices) // num_replicas
    return [devices[r * group : (r + 1) * group] for r in range(num_replicas)]
