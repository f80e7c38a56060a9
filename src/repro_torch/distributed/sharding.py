"""The serving half of the reference's sharding rules: a replica group's
batch split across its logical devices.

The runtime's sharded mode (``MeshConfig.sharded``) gives a replica group
more than one device.  Its program runs one member program per device, on
that device's stream, over an equal contiguous part of the batch's leading
dim, and joins the rows in order.  The logical-axis rules and
``param_pspecs`` belong to the training mesh and are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.device import LogicalDevice


def serving_mesh(devices) -> tuple[LogicalDevice, ...]:
    """The devices of one serving replica group, in order: the batch axis
    of its 1-D mesh."""
    devices = tuple(devices)
    if not devices:
        raise ValueError("a serving mesh needs at least one device")
    return devices


@dataclasses.dataclass(frozen=True, eq=False)
class BatchSharding:
    """A batch's leading dim split into equal contiguous parts, one per
    device of ``devices``, in order."""

    devices: tuple[LogicalDevice, ...]

    @property
    def device_set(self) -> frozenset:
        return frozenset(self.devices)

    def split(self, batch: Any) -> list:
        """``batch``'s parts, device by device (views, not copies)."""
        g = len(self.devices)
        n = batch.shape[0]
        if n % g:
            raise ValueError(f"a batch of {n} rows does not split over {g} devices")
        if torch.is_tensor(batch):
            return list(batch.split(n // g))
        return np.split(np.asarray(batch), g)

    def scope(self):
        """The first member's scope: the group's rows are joined on its
        stream."""
        return self.devices[0].scope()


def batch_sharding(devices) -> BatchSharding:
    """:class:`BatchSharding` splitting a batch's leading dim across
    ``devices``: a sharded replica group's staged batches go through it
    before its member programs run."""
    return BatchSharding(serving_mesh(devices))
