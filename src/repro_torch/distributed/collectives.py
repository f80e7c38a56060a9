"""Collectives of the port's meshes, and the serving mesh's replica groups.

The reference runs its collectives inside ``shard_map``/``vmap`` over a
named axis.  Here one process drives every logical device of a mesh
(``device.mesh_devices``), so a collective is a function over a list of
per-device tensors, ``parts[i]`` on ``devices[i]``:

* ``ring_allreduce`` — the reference's reduce-scatter + all-gather in
  2(P-1) ring steps over 1/P-sized chunks, each step the reference's one
  f32 add (own chunk + received chunk) in its order, so the result is the
  reference's bit for bit and the same bits on every device;
* ``psum_in_chunks`` — a gradient tree reduced in size-balanced buckets,
  each bucket one flat ring;
* ``copy_leaves`` — tensors copied to every device of a group;
* ``all_gather_`` — ZeRO-1's updated slices copied into every device's
  copy of the parameters, in place;
* ``broadcast`` and ``ring_sum`` — a tensor copied to every device of a
  group, and a group's parts summed with the ring, as autograd Functions
  that are each other's backward (Megatron's f and g: the tensor-parallel
  layers' input and output, MoE's expert-parallel branch);
* ``all_gather`` — a leaf's slices joined on each receiving device, as an
  autograd Function whose backward is the reduce-scatter of the
  receivers' gradients back to the slices (a "model"-split leaf that the
  compute cannot use as its slice, gathered before use; an FSDP leaf's
  feature slices, over its data column);
* ``send`` — a tensor copied from one device to another, its gradient
  sent back (an FSDP layer copied from the data index that owns it; a
  recurrent state from a serving shard's lead to each device holding it).

On a card each step's work is enqueued on the receiving device's stream
after a barrier of events over the group's streams: a receiver reads its
sender's chunk only after the sender's last write to it, and a sender
overwrites a chunk only after its reader is done.  A received chunk is
read in place by the receiver's add (on one card, device memory; across
cards it would be a peer read), and the all-gather's chunks are
device-to-device copies.  Every collective starts with each device's
stream waiting on the caller's current stream and ends with the caller's
stream waiting on every device, so its inputs and outputs are ordered for
the caller; ``record_stream`` tells the caching allocator of each
cross-stream use.  No step returns to the host.  On the CPU (logical
devices without streams) the same steps run in order.

An open trace (``launch/hlo_analysis.py``) counts each collective as one
op, as the reference's analysis counts an XLA collective: its result
bytes at each device, as collective bytes by type and as traffic — an
all-reduce's buffer, an all-gather's gathered leaves, the leaves a copy
brings ("collective-permute") — and none of the ring's steps inside it.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels import _build
from repro_torch.tree import tree_leaves, tree_unflatten


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


# ------------------------------------------------------------ stream order
def _on_card(devices) -> bool:
    return devices[0].stream is not None


def barrier(devices) -> None:
    """Each device's stream waits for what every other device's stream
    has been given so far (events; the host does not wait)."""
    if not _on_card(devices):
        return
    events = []
    for dev in devices:
        ev = torch.cuda.Event()
        ev.record(dev.stream)
        events.append(ev)
    for dev in devices:
        for other, ev in zip(devices, events):
            if other.stream != dev.stream:
                dev.stream.wait_event(ev)


def _enter(devices):
    """The caller's current stream, which every device's stream now waits
    on (None on the CPU)."""
    if not _on_card(devices):
        return None
    caller = torch.cuda.current_stream(devices[0].device)
    for dev in devices:
        if dev.stream != caller:
            dev.stream.wait_stream(caller)
    return caller


def _leave(devices, caller, outs) -> None:
    """The caller's stream waits on every device's; ``outs`` are marked as
    used on it."""
    if caller is None:
        return
    for dev in devices:
        if dev.stream != caller:
            caller.wait_stream(dev.stream)
    for t in outs:
        t.record_stream(caller)


def _used_on(t: torch.Tensor, dev) -> None:
    if dev.stream is not None:
        t.record_stream(dev.stream)


def _collective(kind: str, tensors, devices):
    """A context: the block is one collective of ``kind`` whose result at
    each of ``devices`` is ``tensors``' bytes, for an open trace (none
    open: nothing)."""
    if not _build.tracing():
        return contextlib.nullcontext()
    return _build.trace_collective(kind, sum(t.numel() * t.element_size() for t in tensors), devices)


# -------------------------------------------------------------------- ring
def _ring_chunks(flat: torch.Tensor, p: int) -> list:
    """``flat``'s P chunks in the reference's schedule, which pads it to a
    multiple of P: ceil(n / P) elements each, the last ones cut short (or
    empty) where the reference's hold its zeros, which add nothing."""
    n = flat.numel()
    w = -(-n // p)
    return [flat[min(i * w, n):min((i + 1) * w, n)] for i in range(p)]


def ring_allreduce_(flats: list, devices) -> list:
    """The ring over ``flats`` in place: ``flats[i]`` a contiguous 1-d
    tensor on ``devices[i]``, all of one length, chunked as the reference
    chunks it padded (:func:`_ring_chunks`; no padding is stored, so a
    ring over a ``RoleMesh``'s group of roles holds the same bytes as over
    the whole axis).  Afterwards each holds the sum, the same bits
    everywhere.  The caller orders the flats' writes before the call and
    its reads after it (``_enter`` / ``_leave``, as
    :func:`ring_allreduce` does)."""
    p = len(devices)
    if p == 1:
        return flats
    parts = [_ring_chunks(f, p) for f in flats]
    for me, f in enumerate(flats):
        _used_on(f, devices[(me + 1) % p])  # its chunks are read by the next device
    # reduce-scatter: after P-1 steps, device r holds the full sum of
    # chunk (r + 1) mod P
    for i in range(p - 1):
        barrier(devices)
        for me in range(p):
            recv = (me + 1) % p
            with devices[recv].scope():
                parts[recv][(recv - i - 1) % p].add_(parts[me][(me - i) % p])
    # all-gather the reduced chunks around the ring
    for i in range(p - 1):
        barrier(devices)
        for me in range(p):
            recv = (me + 1) % p
            with devices[recv].scope():
                parts[recv][(recv - i) % p].copy_(parts[me][(me + 1 - i) % p])
    barrier(devices)
    return flats


def ring_allreduce(parts: list, devices) -> list:
    """Ring all-reduce of ``parts`` (one tensor per device, equal shapes)
    -> the sums, one per device (new tensors; the inputs are unchanged).

    The reference's schedule: flatten, P - 1 reduce-scatter steps and
    P - 1 all-gather steps over the chunks of the flat padded to a multiple
    of P (the padding is not stored: :func:`_ring_chunks`)."""
    p = len(devices)
    if len(parts) != p:
        raise ValueError(f"{len(parts)} parts for {p} devices")
    if p == 1:
        return [parts[0]]
    shape, n = parts[0].shape, parts[0].numel()
    with _collective("all-reduce", parts[:1], devices):
        caller = _enter(devices)
        flats = []
        for part, dev in zip(parts, devices):
            with dev.scope():
                _used_on(part, dev)
                flats.append(torch.empty(n, dtype=part.dtype, device=part.device).copy_(part.reshape(-1)))
        ring_allreduce_(flats, devices)
        outs = [f.view(shape) for f in flats]
        _leave(devices, caller, outs)
    return outs


def bucket_leaves(sizes: list[int], num_buckets: int) -> list[list[int]]:
    """The reference's greedy size balancing: leaves by size, largest
    first (ties in leaf order), each into the lightest bucket so far."""
    buckets: list[list[int]] = [[] for _ in range(num_buckets)]
    totals = [0] * num_buckets
    for i in sorted(range(len(sizes)), key=lambda i: -sizes[i]):
        b = totals.index(min(totals))
        buckets[b].append(i)
        totals[b] += sizes[i]
    return buckets


def psum_in_chunks(trees: list, devices, num_buckets: int = 4) -> list:
    """Reduce a gradient tree over ``devices`` (``trees[i]`` on
    ``devices[i]``, equal structures) in ``num_buckets`` buckets
    (:func:`bucket_leaves`), each bucket's leaves concatenated into one
    flat ring -> one reduced tree per device, its leaves views of the
    bucket buffers."""
    p = len(devices)
    if len(trees) != p:
        raise ValueError(f"{len(trees)} trees for {p} devices")
    if p == 1:
        return list(trees)
    leaves = [tree_leaves(t) for t in trees]
    sizes = [leaf.numel() for leaf in leaves[0]]
    out = [[None] * len(sizes) for _ in trees]
    with _collective("all-reduce", leaves[0], devices):
        caller = _enter(devices)
        for bucket in bucket_leaves(sizes, num_buckets):
            if not bucket:
                continue
            flats = []
            for ls, dev in zip(leaves, devices):
                with dev.scope():
                    for i in bucket:
                        _used_on(ls[i], dev)
                    flats.append(torch.cat([ls[i].reshape(-1) for i in bucket]))
            ring_allreduce_(flats, devices)
            for k, flat in enumerate(flats):
                offset = 0
                for i in bucket:
                    leaf = leaves[k][i]
                    out[k][i] = flat[offset:offset + sizes[i]].view(leaf.shape).to(leaf.dtype)
                    offset += sizes[i]
        _leave(devices, caller, [t for o in out for t in o])
    return [tree_unflatten(tree, o) for tree, o in zip(trees, out)]


# ---------------------------------------------------------------- autograd
def copy_leaves(leaves: list, devices) -> list:
    """One copy of each of ``leaves`` per device, made on that device's
    stream -> a list of copies per device."""
    with _collective("collective-permute", leaves, devices):
        caller = _enter(devices)
        outs = []
        for dev in devices:
            with dev.scope():
                mine = []
                for x in leaves:
                    _used_on(x, dev)
                    mine.append(torch.empty_like(x).copy_(x))
                outs.append(mine)
        _leave(devices, caller, [t for mine in outs for t in mine])
    return outs


def all_gather_(leaves: list[dict], devices, groups: list[list[int]], owned) -> None:
    """ZeRO-1's all-gather, in place: for each device q, each other member
    s of ``groups[q]`` (positions in ``devices``) and each leaf ``name`` of
    ``leaves[q]`` (device q's copies, by name), the part device s owns —
    ``owned(name, s, t)``, that part of ``t`` or None — is copied from
    s's leaf into q's, on q's stream, between two barriers."""
    barrier(devices)
    with torch.no_grad():
        for q, dev in enumerate(devices):
            with _collective("all-gather", leaves[q].values(), [dev] if len(groups[q]) > 1 else []), dev.scope():
                for s in groups[q]:
                    if s == q:
                        continue
                    for name, mine in leaves[q].items():
                        part = owned(name, s, mine)
                        if part is not None:
                            part.copy_(owned(name, s, leaves[s][name]))
    barrier(devices)


def _copy_to(x: torch.Tensor, devices) -> list:
    """One copy of ``x`` per device, each made on that device's stream."""
    return [mine[0] for mine in copy_leaves([x], devices)]


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, devices, x):
        ctx.devices = devices
        return tuple(_copy_to(x, devices))

    @staticmethod
    def backward(ctx, *dys):
        ref = next(d for d in dys if d is not None)
        dys = [torch.zeros_like(ref) if d is None else d for d in dys]
        return None, ring_allreduce(dys, ctx.devices)[0]


class _RingSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, devices, *parts):
        ctx.devices = devices
        return ring_allreduce(list(parts), devices)[0]

    @staticmethod
    def backward(ctx, dy):
        return (None, *_copy_to(dy.contiguous(), ctx.devices))


def broadcast(x: torch.Tensor, devices) -> list:
    """``x`` copied to each of ``devices``; under autograd the copies'
    gradients are summed back over the devices with the ring."""
    return list(_Broadcast.apply(tuple(devices), x))


def ring_sum(parts: list, devices) -> torch.Tensor:
    """The ring's sum of ``parts`` (``parts[i]`` on ``devices[i]``), the
    first device's copy; under autograd its gradient is broadcast back to
    every part."""
    return _RingSum.apply(tuple(devices), *parts)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, devices, dim, at, slices, alone, *parts):
        ctx.devices, ctx.dim, ctx.at, ctx.width = devices, dim, at, parts[0].shape[dim]
        p = len(parts)
        # each of the whole axis' ``slices`` devices gathers alone: the last one here stands for those absent
        ctx.times = slices - p + 1 if alone and at[-1] == p - 1 else 1
        shape = list(parts[0].shape)
        shape[dim] *= slices
        outs = []
        for r in at:
            with devices[r].scope():
                outs.append(torch.empty(shape, dtype=parts[0].dtype, device=parts[0].device))
        with _collective("all-gather", outs[:1], [devices[r] for r in at]):
            caller = _enter(devices)
            barrier(devices)  # each part's last write, on whichever stream made it
            for r, out in zip(at, outs):
                with devices[r].scope():
                    for i in range(slices):
                        _used_on(parts[i % p], devices[r])
                        out.narrow(dim, i * ctx.width, ctx.width).copy_(parts[i % p])
            _leave(devices, caller, outs)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        devices, dim, k = ctx.devices, ctx.dim, ctx.width
        got = [(r, g) for r, g in zip(ctx.at, grads) if g is not None]
        outs = []
        with _build.counted(ctx.times), \
                _collective("reduce-scatter", [got[0][1].narrow(dim, 0, k)] if got else [], devices):
            caller = _enter(devices)
            for s, dev in enumerate(devices):
                with dev.scope():
                    acc = None
                    for _, g in got:  # the receivers' gradients of slice s, in order
                        _used_on(g, dev)
                        piece = g.narrow(dim, s * k, k)
                        acc = piece.clone(memory_format=torch.contiguous_format) if acc is None else acc.add_(piece)
                    outs.append(acc)
            _leave(devices, caller, [t for t in outs if t is not None])
        return (None, None, None, None, None, *outs)


def all_gather(parts: list, devices, dim: int, at=None, slices: int | None = None, alone: bool = False) -> list:
    """``parts`` (``parts[i]`` on ``devices[i]``, equal shapes) joined along
    ``dim`` in order, one whole tensor on each device at the positions
    ``at`` (default: every device), each made on its receiver's stream.
    Under autograd each part's gradient is the sum, over the receivers in
    order, of their gradients' slice of it (a reduce-scatter; with one
    receiver, a scatter).

    ``slices`` (default ``len(parts)``) is the number of slices the whole
    holds: a trace on a :class:`~repro_torch.launch.mesh.RoleMesh`, whose
    group keeps fewer devices than the "model" axis has, fills the whole's
    shape by cycling through the parts it has.  ``alone``: each device of
    the whole axis gathers the parts in a call of its own (FSDP's data
    column), so each part receives a scatter from ``slices`` such calls;
    on a RoleMesh, whose last device of the axis stands for the devices it
    leaves out, a trace counts that device's scatter ``slices -
    len(parts) + 1`` times."""
    at = tuple(range(len(devices))) if at is None else tuple(at)
    slices = len(parts) if slices is None else slices
    return list(_AllGather.apply(tuple(devices), dim, at, slices, alone, *parts))


class _Send(torch.autograd.Function):
    @staticmethod
    def forward(ctx, devices, src, dst, fanout, x):
        ctx.devices, ctx.src = devices, src
        with devices[dst].scope():
            out = torch.empty_like(x, memory_format=torch.contiguous_format)
        with _collective("all-gather", [out], [devices[dst]]):
            caller = _enter(devices)
            barrier(devices)  # the source's last write, on whichever stream made it
            with devices[dst].scope():
                _used_on(x, devices[dst])
                out.copy_(x)
            _leave(devices, caller, [out])
        if fanout and _build.tracing():
            with _build.counted(fanout), _collective("send", [out], [devices[src]]):
                pass
        return out

    @staticmethod
    def backward(ctx, g):
        devices, src = ctx.devices, ctx.src
        with _collective("reduce-scatter", [g], [devices[src]]):
            caller = _enter(devices)
            with devices[src].scope():
                _used_on(g, devices[src])
                out = g.clone(memory_format=torch.contiguous_format)
            _leave(devices, caller, [out])
        return None, None, None, None, out


def send(x: torch.Tensor, devices, src: int, dst: int, fanout: int | None = None) -> torch.Tensor:
    """``x`` (on ``devices[src]``) copied to ``devices[dst]``, made on its
    stream; under autograd its gradient is copied back to ``devices[src]``
    on that device's stream.  An open trace counts the bytes at the
    receiver; with ``fanout`` also at the source, as "send", for that many
    receivers of the whole mesh (a :class:`~repro_torch.launch.mesh.RoleMesh`
    device standing for those the span leaves out: ``Mesh.stands_for``)."""
    return _Send.apply(tuple(devices), src, dst, fanout, x)
