"""ZeRO-1 optimizer-state sharding: the port of ``repro.distributed.zero``.

Adam's moments double the f32 parameter footprint.  ZeRO-1 shards them
over the DATA axes: a moment's spec is its parameter's with the first
still-unsharded, data-divisible dimension given to the data axes.  The
training mesh (``make_train_step(grad_pspecs=...)``) keeps on each device
only its slice of ``m`` and ``v`` on that dimension, updates its slice of
each parameter, and all-gathers the updated slices into every copy.

Specs are over the reference's layout (each layer group stacked under a
leading layer axis), so a stacked leaf's first free dimension may be the
layer axis: a device then owns whole layers of it.

Above the reference's threshold (``launch/specs.py``
``maybe_fsdp_pspecs``) the parameters' specs are these same ZeRO specs:
FSDP.  Each device then stores only its moments' part of each parameter
(:class:`Layout`), each layer gathers its leaves before use
(``sharding.DataShards``) and AdamW updates the stored parts in place,
with no all-gather after it.

Serving on a mesh places the weights alone, under the serving specs
(:func:`place_params`, :func:`gather_params`: the same :class:`Layout`
with no moments).
"""

from __future__ import annotations

import functools

from repro_torch.distributed.sharding import P, data_axes_and_size


def zero_spec_for(spec: P, shape: tuple[int, ...], data_axes, data_size: int) -> P:
    """Extend a param spec with data-axis sharding on one free dim."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for i, (axis, dim) in enumerate(zip(parts, shape)):
        if axis is None and dim % data_size == 0 and dim >= data_size:
            parts[i] = data_axes
            return P(*parts)
    return P(*parts)  # nothing divisible: stay replicated


def _shapes(params) -> dict:
    """A reference-layout tree of leaf shapes: ``params`` itself (leaves
    with ``.shape``), or a ``TransformerLM``'s parameters stacked by layer
    group (shapes only: ``meta`` tensors)."""
    if isinstance(params, dict):
        return params
    import torch

    from repro_torch.models.transformer import stack_jax_layout

    return stack_jax_layout((name, torch.empty(w.shape, device="meta")) for name, w in params.named_parameters())


def zero_pspecs(params, param_specs: dict, mesh) -> dict:
    """Tree of optimizer-moment specs for ``params`` (a ``TransformerLM``
    or a reference-layout tree), matching ``param_specs``
    (``sharding.param_pspecs``), over the current rules' batch axes."""
    data_axes, size = data_axes_and_size(mesh)

    def one(shapes, specs):
        if isinstance(specs, dict):
            return {key: one(shapes[key], specs[key]) for key in specs}
        return zero_spec_for(specs, tuple(shapes.shape), data_axes, size)

    return one(_shapes(params), param_specs)


# --------------------------------------------------------- state on a mesh
def take(t, sl):
    """``t``'s part ``sl``: (dim, start, stop), or the whole of ``t`` for
    a dim of None."""
    dim, start, stop = sl
    return t if dim is None else t.narrow(dim, start, stop - start)


WHOLE = (None, 0, 0)


class Layout:
    """Where a ``TransformerLM``'s parameters and AdamW moments live on
    ``mesh`` under ``specs`` (a reference-layout tree of moment specs,
    ``zero_pspecs``; they carry the parameter specs' "model" entries) and
    ``param_specs`` (the parameters' tree; default: ``specs`` without
    their data axes).

    Each device holds, of every parameter whose spec has "model" on a
    dim, its slice of that dim (the reference's layout: attention's heads,
    the MLP's columns and rows, the vocabulary, an expert stack's
    experts, ...), and a copy of every other parameter.  Each device holds
    and updates its ZeRO slice of ``m`` and ``v``: on the spec's data
    dimension, the device's part along the data axes (for a layer group's
    leading layer axis, whole layers).

    FSDP: a parameter whose spec in ``param_specs`` names the data axes
    (``maybe_fsdp_pspecs``' tree, equal to ``specs``) is stored as that
    same part of its "model" slice, its moments' part (``fsdp_dim``: the
    dim of the layer's leaf, or -1 for whole layers; a device that owns
    none of a layer holds an empty tensor for it), and gathered before
    use (``sharding.DataShards``)."""

    def __init__(self, model, mesh, specs: dict, rules=None, param_specs: dict | None = None):
        from repro_torch.distributed.sharding import spec_at
        from repro_torch.models.transformer import _jax_path

        self.mesh, self.cfg = mesh, model.cfg
        self.data_axes, self.data_size = data_axes_and_size(mesh, rules)
        axes = self.data_axes if isinstance(self.data_axes, tuple) else (self.data_axes,)
        self.data_axis_names = tuple(a for a in axes if a in mesh.shape)
        self.tp = mesh.shape.get("model", 1)
        self.data_index = [mesh.index(pos, self.data_axis_names) for pos in range(mesh.size)]
        self.model_index = [int(mesh.coords(pos).get("model", 0)) for pos in range(mesh.size)]
        named = list(model.named_parameters())
        n_layers: dict = {}
        for name, _ in named:
            path = _jax_path(name)[0]
            n_layers[path] = n_layers.get(path, 0) + 1
        self.names = [name for name, _ in named]
        self.model_dim, self.zero_dim, self.fsdp_dim, self.layer = {}, {}, {}, {}
        for name, _ in named:
            path, index = _jax_path(name)
            stacked = int(index is not None)
            spec = tuple(spec_at(specs, name))
            md = next((j for j, a in enumerate(spec) if a == "model"), None)
            self.model_dim[name] = md - stacked if md is not None and self.tp > 1 else None
            zd = next((j for j, a in enumerate(spec) if a == self.data_axes), None)
            self.zero_dim[name] = None if zd is None or self.data_size == 1 else zd - stacked  # -1: layers
            pd = None
            if param_specs is not None:
                pspec = tuple(spec_at(param_specs, name))
                pd = next((j for j, a in enumerate(pspec) if a == self.data_axes), None)
                if pd is not None and pd != zd:
                    raise ValueError(f"{name}: parameter spec {pspec} splits another dim over the data axes "
                                     f"than its moments' {spec}")
            self.fsdp_dim[name] = None if pd is None or self.data_size == 1 else pd - stacked
            self.layer[name] = (index, n_layers[path]) if stacked else None

    def param_slice(self, name: str, pos: int, full_shape) -> tuple:
        """The "model" slice of the full parameter the device at ``pos``
        holds (or holds a data part of, under FSDP); raises when its
        "model" dim does not split evenly (as placing the reference's
        sharding would)."""
        md = self.model_dim[name]
        if md is None:
            return WHOLE
        if full_shape[md] % self.tp:
            raise ValueError(f"{name}: dim {md} of {tuple(full_shape)} does not split over {self.tp} model devices")
        n = full_shape[md] // self.tp
        m = self.model_index[pos]
        return (md, m * n, (m + 1) * n)

    @functools.cached_property
    def shape(self) -> dict:
        """Each leaf's whole shape (the placed copies hold parts of it)."""
        import torch

        from repro_torch.models.transformer import TransformerLM

        return {name: tuple(w.shape) for name, w in TransformerLM(self.cfg, "meta", torch.float32).named_parameters()}

    def model_shape(self, name: str) -> tuple:
        """The shape of a device's "model" slice of ``name``."""
        shape = list(self.shape[name])
        if self.model_dim[name] is not None:
            shape[self.model_dim[name]] //= self.tp
        return tuple(shape)

    def data_slice(self, name: str, pos: int, model_shape) -> tuple | None:
        """The part of the device's "model" slice (of ``model_shape``) on
        the data axes: whose moments it keeps and updates, and under FSDP
        what it stores (None: no part of it)."""
        zd, ds, dd = self.zero_dim[name], self.data_size, self.data_index[pos]
        if zd is None:
            return WHOLE
        if zd == -1:
            return WHOLE if self.layer_owner(name) == dd else None
        n = model_shape[zd] // ds
        return (zd, dd * n, (dd + 1) * n)

    def moment_slice(self, name: str, pos: int, local_shape) -> tuple | None:
        """The part of the device's parameter (of ``local_shape``) whose
        moments it keeps and updates (None: no part of it); under FSDP the
        whole stored part."""
        if self.fsdp_dim[name] is not None:
            return WHOLE if self.holds(name, pos) else None
        return self.data_slice(name, pos, local_shape)

    def holds(self, name: str, pos: int) -> bool:
        """The device at ``pos`` stores some of ``name`` (under FSDP, a
        layer it does not own: none)."""
        return self.fsdp_dim[name] != -1 or self.layer_owner(name) == self.data_index[pos]

    def layer_owner(self, name: str) -> int:
        """The data index that owns layer leaf ``name``: the layers split
        in equal contiguous runs over the data axes."""
        index, n_layers = self.layer[name]
        return index // (n_layers // self.data_size)

    def owner(self, name: str, pos: int) -> tuple[int, str]:
        """(the position in ``pos``'s data column that stores the layer leaf
        ``name``, FSDP over whole layers, and that leaf's name).  On a
        :class:`~repro_torch.launch.mesh.RoleMesh`, which keeps the first
        data indices only, an absent owner has a stand-in: the column's
        device at (``pos``'s data index + the owner's) modulo the column's
        length, so that each device stands in as often as an owner is sent
        to on the whole mesh, and its own layer at the same offset in its
        run of layers (the same shape)."""
        want, column = self.layer_owner(name), self.column(pos)
        q = next((q for q in column if self.data_index[q] == want), None)
        if q is not None:
            return q, name
        q = column[(self.data_index[pos] + want) % len(column)]
        index, n_layers = self.layer[name]
        per = n_layers // self.data_size
        return q, name.replace(f".{index}.", f".{self.data_index[q] * per + index % per}.", 1)

    def column(self, pos: int) -> list[int]:
        """The positions that hold the same part of every parameter as
        ``pos`` (its model index), in data order: an all-gather's group."""
        return sorted((q for q in range(self.mesh.size) if self.model_index[q] == self.model_index[pos]),
                      key=lambda q: self.data_index[q])


def _place_leaf(copy, name: str, w, layout: Layout, pos: int, dev) -> tuple:
    """Put the device at ``pos``'s part of parameter ``name`` (``w``, the
    whole leaf) into ``copy``, made on ``dev`` (the caller is in its scope):
    its "model" slice, under FSDP that slice's data part (an empty tensor
    for a layer another data index owns), else a copy.  Returns (the
    "model" slice, its data part: ``Layout.param_slice``,
    ``Layout.data_slice``)."""
    import torch
    from torch import nn

    from repro_torch.distributed import collectives as C

    psl = layout.param_slice(name, pos, w.shape)
    part = take(w.detach(), psl)
    sl = layout.data_slice(name, pos, part.shape)
    C._used_on(w, dev)
    if layout.fsdp_dim[name] is None:
        mine = torch.empty(part.shape, dtype=w.dtype, device=dev.device).copy_(part)
    elif sl is None:  # a layer another data index owns
        mine = torch.empty((0, *part.shape[1:]), dtype=w.dtype, device=dev.device)
    else:
        mine = take(part, sl).clone()
    owner, leaf = name.rsplit(".", 1) if "." in name else ("", name)
    setattr(copy.get_submodule(owner), leaf, nn.Parameter(mine, requires_grad=w.requires_grad))
    return psl, sl


def place_train_state(state: dict, mesh, specs: dict, param_specs: dict | None = None) -> dict:
    """A single-device training state (``train_loop.init_train_state``'s)
    placed on ``mesh`` under ``specs`` (``zero_pspecs``; the counterpart of
    ``jax.device_put(state, named(mesh, specs))``) and ``param_specs`` (the
    parameters' tree: FSDP where it names the data axes): per device, in
    ``mesh.flat`` order, its parameters (a ``TransformerLM`` holding
    each "model"-split leaf's slice and each FSDP leaf's data part,
    :class:`Layout`), its ``m``/``v`` slices ({name: tensor}, only the
    parts it keeps), ``count`` and ``step``.  Each device's tensors are made
    on its stream; the caller's stream waits for them.  The data axes are
    the current rules'."""
    import torch

    from repro_torch.distributed import collectives as C
    from repro_torch.models.transformer import TransformerLM

    src = state["params"]
    layout = Layout(src, mesh, specs, param_specs=param_specs)
    devices = mesh.flat
    caller = C._enter(devices)
    params, ms, vs, counts, steps = [], [], [], [], []
    for pos, dev in enumerate(devices):
        with dev.scope(), torch.no_grad():
            copy = TransformerLM(src.cfg, "meta", torch.float32)
            m, v = {}, {}
            for name, w in src.named_parameters():
                psl, sl = _place_leaf(copy, name, w, layout, pos, dev)
                if sl is not None:
                    for key, out in (("m", m), ("v", v)):
                        full = state["opt"][key][name]
                        C._used_on(full, dev)
                        out[name] = take(take(full, psl), sl).clone()
            params.append(copy)
            ms.append(m)
            vs.append(v)
            counts.append(state["opt"]["count"].clone())
            steps.append(state["step"].clone())
    C._leave(devices, caller, [])
    return {"params": params, "opt": {"m": ms, "v": vs, "count": counts}, "step": steps}


def place_params(model, mesh, pspecs: dict) -> list:
    """A single-device model (the serving weights, in their dtypes) placed
    on ``mesh`` under ``pspecs``, as :func:`place_train_state` places a
    state's parameters: per device, in ``mesh.flat`` order, a
    ``TransformerLM`` holding its slice of every leaf whose spec has
    "model" on a dim (under FSDP, a tree naming the data axes, that
    slice's data part) and a copy of every other leaf, made on its stream;
    the caller's stream waits for them.  The data axes are the current
    rules'."""
    import torch

    from repro_torch.distributed import collectives as C
    from repro_torch.models.transformer import TransformerLM

    layout = Layout(model, mesh, pspecs, param_specs=pspecs)
    devices = mesh.flat
    caller = C._enter(devices)
    copies = []
    for pos, dev in enumerate(devices):
        with dev.scope(), torch.no_grad():
            copy = TransformerLM(model.cfg, "meta", torch.float32)
            for name, w in model.named_parameters():
                _place_leaf(copy, name, w, layout, pos, dev)
            copies.append(copy)
    C._leave(devices, caller, [])
    return copies


def _join_leaf(named: list, name: str, layout: Layout, mesh, dev, caller):
    """Parameter ``name`` whole on torch device ``dev``, joined from every
    device's part (``named``: each device's {name: tensor}); each part read
    is marked as used on ``caller``'s stream (None on the CPU)."""
    import torch

    full_shape = layout.shape[name]
    w = named[0][name]
    full = torch.empty(full_shape, dtype=w.dtype, device=dev)
    for pos in range(mesh.size):
        psl = layout.param_slice(name, pos, full_shape)
        sl = layout.data_slice(name, pos, layout.model_shape(name))
        if layout.fsdp_dim[name] is None:
            take(full, psl).copy_(named[pos][name])
        elif sl is not None:
            take(take(full, psl), sl).copy_(named[pos][name])
        if caller is not None:
            named[pos][name].record_stream(caller)
    return full


def gather_train_state(placed: dict, mesh, specs: dict, param_specs: dict | None = None) -> dict:
    """The inverse of :func:`place_train_state`: one state on the first
    device's torch device, every "model"-split leaf joined from its slices,
    every FSDP leaf and the moments over the data axes; ``count`` and
    ``step`` the first device's."""
    import torch
    from torch import nn

    from repro_torch.distributed import collectives as C
    from repro_torch.models.transformer import TransformerLM

    copies = placed["params"]
    layout = Layout(copies[0], mesh, specs, param_specs=param_specs)
    devices = mesh.flat
    dev = devices[0].device
    caller = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
    C._leave(devices, caller, [])  # the caller's stream reads after every device's writes
    named = [dict(c.named_parameters()) for c in copies]
    model = TransformerLM(copies[0].cfg, "meta", torch.float32)
    out = {"m": {}, "v": {}}
    with torch.no_grad():
        for name, w in named[0].items():
            full = _join_leaf(named, name, layout, mesh, dev, caller)
            full_shape = layout.shape[name]
            moments = {key: torch.empty(full_shape, dtype=torch.float32, device=dev) for key in out}
            for pos in range(mesh.size):
                psl = layout.param_slice(name, pos, full_shape)
                sl = layout.data_slice(name, pos, layout.model_shape(name))
                if sl is not None:
                    for key in out:
                        got = placed["opt"][key][pos][name]
                        take(take(moments[key], psl), sl).copy_(got)
                        if caller is not None:
                            got.record_stream(caller)
            owner, leaf = name.rsplit(".", 1) if "." in name else ("", name)
            setattr(model.get_submodule(owner), leaf, nn.Parameter(full, requires_grad=w.requires_grad))
            for key in out:
                out[key][name] = moments[key]
    return {"params": model, "opt": {"m": out["m"], "v": out["v"],
                                     "count": placed["opt"]["count"][0].to(dev)},
            "step": placed["step"][0].to(dev)}


def gather_params(copies: list, mesh, pspecs: dict):
    """The inverse of :func:`place_params`: one model on the first
    device's torch device, every "model"-split leaf joined from its
    slices."""
    import torch
    from torch import nn

    from repro_torch.distributed import collectives as C
    from repro_torch.models.transformer import TransformerLM

    layout = Layout(copies[0], mesh, pspecs, param_specs=pspecs)
    devices = mesh.flat
    dev = devices[0].device
    caller = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
    C._leave(devices, caller, [])  # the caller's stream reads after every device's writes
    named = [dict(c.named_parameters()) for c in copies]
    model = TransformerLM(copies[0].cfg, "meta", torch.float32)
    with torch.no_grad():
        for name, w in named[0].items():
            owner, leaf = name.rsplit(".", 1) if "." in name else ("", name)
            full = _join_leaf(named, name, layout, mesh, dev, caller)
            setattr(model.get_submodule(owner), leaf, nn.Parameter(full, requires_grad=w.requires_grad))
    return model
