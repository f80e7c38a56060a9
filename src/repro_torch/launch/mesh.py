"""Meshes of the port: ``repro.launch.mesh``.

A :class:`Mesh` is a named grid of logical devices
(``device.mesh_devices``: each card, or the CPU, split into
``REPRO_TORCH_FORCE_DEVICE_COUNT`` parts, one CUDA stream a part), driven
from one process, as the reference's single-controller SPMD programs are.
``with mesh:`` makes it the calling thread's current mesh
(``sharding.current_mesh``, kept with the rules),
the counterpart of ``jax.set_mesh``; MoE's expert-parallel branch and the
training mesh (``make_train_step(grad_pspecs=...)``) read it.  A FUNCTION builds each
mesh, so importing this module touches no device.
"""

from __future__ import annotations

import collections
import math

import numpy as np

from repro_torch.device import mesh_devices
from repro_torch.distributed.sharding import MULTI_POD_RULES, SINGLE_POD_RULES, pop_mesh, push_mesh

CHIPS_PER_POD = 256
# indices of each axis a RoleMesh keeps: a group's first, middle and last member
ROLE_SPAN = 3


class Mesh:
    """``devices``, an ndarray of logical devices, with one name per axis.

    ``shape`` is the ordered {axis: size} JAX gives; :meth:`model_groups`
    lists the devices a collective over "model" runs among."""

    def __init__(self, devices: np.ndarray, axis_names):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError(f"{devices.ndim}-d device grid for axes {self.axis_names}")

    @property
    def shape(self) -> collections.OrderedDict:
        return collections.OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def flat(self) -> list:
        """The devices in row-major order (a device's position in it is
        its index in the lists the training mesh keeps per device)."""
        return list(self.devices.flat)

    def coords(self, pos: int) -> dict:
        """{axis: index} of the device at flat position ``pos``."""
        return dict(zip(self.axis_names, np.unravel_index(pos, self.devices.shape)))

    def index(self, pos: int, axes) -> int:
        """The flat position's index along ``axes`` taken together
        (row-major over them; 0 for none)."""
        coords, out = self.coords(pos), 0
        for a in axes:
            out = out * self.shape[a] + int(coords[a])
        return out

    def stands_for(self, pos: int, beside: int) -> int:
        """How many devices of the mesh the one at flat position ``pos``
        stands for, as a receiver of the one at ``beside``: itself (a
        :class:`RoleMesh` device may stand for more)."""
        return 1

    def model_groups(self, data_axes) -> list[list]:
        """Per index along ``data_axes`` (a name or names, row-major over
        them), the devices along "model" (one device if the mesh has no
        "model"), in order: the groups a collective over "model" runs
        among.  Any other axis is taken at index 0 (a replica axis computes
        the same)."""
        data_axes = [a for a in ((data_axes,) if isinstance(data_axes, str) else data_axes) if a in self.shape]
        out: dict = {}
        for pos, dev in enumerate(self.flat):
            c = self.coords(pos)
            if any(c[a] for a in self.axis_names if a not in data_axes and a != "model"):
                continue
            out.setdefault(self.index(pos, data_axes), []).append((int(c.get("model", 0)), dev))
        return [[dev for _, dev in sorted(out[i], key=lambda md: md[0])] for i in sorted(out)]

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)}, {[d.label for d in self.flat]})"

    def __enter__(self):
        push_mesh(self)
        return self

    def __exit__(self, *exc):
        pop_mesh()


def make_mesh(shape, axes, devices=None) -> Mesh:
    """A mesh of ``shape`` over the first ``prod(shape)`` of ``devices``
    (default: the card's logical devices, ``mesh_devices()``); raises, as
    ``jax.make_mesh`` does, when there are fewer."""
    devices = mesh_devices() if devices is None else list(devices)
    n = math.prod(shape)
    if len(devices) < n:
        raise ValueError(f"Number of devices {len(devices)} must be >= the product of mesh_shape {tuple(shape)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices[:n]
    return Mesh(grid.reshape(tuple(shape)), axes)


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """16x16 (data, model) single pod; 2x16x16 (pod, data, model) for two
    pods — 512 devices (of ``devices``, default the card's)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)


def rules_for(multi_pod: bool) -> dict:
    return MULTI_POD_RULES if multi_pod else SINGLE_POD_RULES


def make_host_mesh(devices=None) -> Mesh:
    """Degenerate 1x1 mesh for single-device tests/examples."""
    return make_mesh((1, 1), ("data", "model"), devices)


class RoleMesh(Mesh):
    """``mesh``'s devices at the first :data:`ROLE_SPAN` indices of each
    axis, standing for the whole mesh: ``shape`` is ``mesh``'s, so each of
    these devices gets the data shard, ZeRO slice and expert slice it has
    on ``mesh``, and each group a collective runs over keeps its first,
    middle and last roles.  A trace of the training mesh's step on it
    counts per device what the whole mesh does, with 9 devices standing
    for 256: every data shard's lead alike, every model device alike.
    Where a count grows with an axis, the axis' last device here stands
    for the devices the span leaves out and its share counts for theirs
    too (``_build.counted``): a shard's lead adds up each model device's
    gradients on its own stream over microbatches
    (``train_loop._mesh_train_step``); under FSDP a stored feature slice
    receives a scatter of the gradient from each data shard's gather
    (``sharding.DataShards``, ``collectives.all_gather(alone=True)``); a
    gather of attention partials over a whole axis holds a slice for each
    of its devices (``all_gather(slices=...)``, ``models/decode.py``); a
    serving lead's send of a recurrent state to a holder counts for each
    holder the receiver stands for (:meth:`stands_for`).  The autograd
    engine's sums of a stored slice's scatters run outside
    any such block and are not scaled (a trace's traffic).  A layer
    stored whole on a data index the span leaves out is gathered from a
    stand-in (``zero.Layout.owner``), so each device sends as many layers
    as an owner does on the whole mesh."""

    def __init__(self, mesh: Mesh):
        super().__init__(mesh.devices[tuple(slice(0, ROLE_SPAN) for _ in mesh.devices.shape)], mesh.axis_names)
        self._full = mesh.shape

    @property
    def shape(self) -> collections.OrderedDict:
        return self._full

    def stands_for(self, pos: int, beside: int) -> int:
        """The whole mesh's devices the one at ``pos`` stands for as a
        receiver of the one at ``beside``: along each axis the span cuts,
        its last index stands for the indices left out as well, but along
        an axis where it shares the sender's index (a sender whose receivers
        lie on its own data index) for itself alone."""
        n, mine = 1, self.coords(beside)
        for axis, index in self.coords(pos).items():
            if self._full[axis] > ROLE_SPAN and index == ROLE_SPAN - 1 and mine[axis] != index:
                n *= self._full[axis] - ROLE_SPAN + 1
        return n
