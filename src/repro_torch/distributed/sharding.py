"""Sharding rules of the port: the reference's logical-axis rules and
parameter specs (the training mesh), and a replica group's batch split
(the serving mesh).

Training: model code names activations by *logical* axes ("batch",
"seq", "heads", ...); :func:`use_rules` installs a mapping from logical
names to mesh axes.  :func:`shard` is the identity, as the reference's is
outside a mesh and as GSPMD's constraint is in value.  Parameter specs
come from leaf paths by rule (:func:`param_pspecs`, the reference's
``_PARAM_RULES``): each parameter of the port's
:class:`~repro_torch.models.transformer.TransformerLM` is matched by its
path in the reference's pytree, and a layer's parameter counts the
leading layer axis its reference leaf is stacked under.  :class:`P` is
``PartitionSpec``'s counterpart.  The calling thread's current mesh
(``with mesh:``, ``launch/mesh.py``) and the training mesh's data shard
being computed (:func:`expert_shard`, :func:`tensor_shard`: its model
group and their "model"-split parameters; :func:`data_shards`: under
FSDP each device's stored data part of every leaf, which
:func:`gathered` joins around each layer) are kept here with the rules,
where the layers read them.

Serving: the runtime's sharded mode (``MeshConfig.sharded``) gives a
replica group more than one device.  Its program runs one member program
per device, on that device's stream, over an equal contiguous part of the
batch's leading dim, and joins the rows in order.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
import threading
from types import SimpleNamespace
from typing import Any

import numpy as np
import torch

from repro_torch.device import LogicalDevice, current_logical

_ctx = threading.local()


class P(tuple):
    """``PartitionSpec``'s counterpart: one entry per dimension, each a
    mesh-axis name, a tuple of names (the dim split over their product) or
    None (not split); equal as tuples."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P({', '.join(map(repr, self))})"


# Logical-axis defaults for the production meshes.
SINGLE_POD_RULES: dict[str, Any] = {
    "batch": "data",
    "seq": None,
    "seq_shard": "data",  # sequence sharding for small-batch decode (SP)
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "expert_cap": None,
}
MULTI_POD_RULES = dict(SINGLE_POD_RULES)
MULTI_POD_RULES["batch"] = ("pod", "data")
MULTI_POD_RULES["seq_shard"] = ("pod", "data")


def set_rules(rules: dict[str, Any] | None) -> None:
    _ctx.rules = rules


def get_rules() -> dict[str, Any] | None:
    return getattr(_ctx, "rules", None)


class use_rules:
    """Context manager installing logical->mesh axis rules (per thread)."""

    def __init__(self, rules: dict[str, Any] | None):
        self.rules = rules

    def __enter__(self):
        self.prev = get_rules()
        set_rules(self.rules)
        return self

    def __exit__(self, *exc):
        set_rules(self.prev)


def logical_to_pspec(names: tuple[str | None, ...]) -> P:
    rules = get_rules()
    if rules is None:
        return P()
    return P(*[rules.get(n) if n is not None else None for n in names])


def shard(x, *names: str | None):
    """Annotate ``x`` with logical axis names: the identity (the port
    places data explicitly; a constraint changes no value)."""
    return x


# ------------------------------------------------- the current mesh and shard
def push_mesh(mesh) -> None:
    """Make ``mesh`` the calling thread's current mesh (``with mesh:``)."""
    _ctx.__dict__.setdefault("meshes", []).append(mesh)


def pop_mesh() -> None:
    _ctx.meshes.pop()


def current_mesh():
    """The calling thread's current mesh (innermost ``with mesh:``), or
    None."""
    meshes = getattr(_ctx, "meshes", None)
    return meshes[-1] if meshes else None


def data_axes_and_size(mesh, rules=None) -> tuple:
    """(the rules' batch axes — a name, or a tuple of names — and the
    product of their sizes on ``mesh``); ``rules`` default: the current
    ones."""
    rules = (rules if rules is not None else get_rules()) or {}
    data_axes = rules.get("batch", "data")
    if isinstance(data_axes, (tuple, list)):
        size = 1
        for a in data_axes:
            size *= mesh.shape.get(a, 1)
        return tuple(data_axes), size
    return data_axes, mesh.shape.get(data_axes, 1)


def splits_over_data(pspecs, mesh, rules=None) -> bool:
    """Some leaf of the spec tree ``pspecs`` is split over the data axes of
    ``mesh``, and they have more than one index (FSDP:
    ``maybe_fsdp_pspecs``' tree above its threshold); ``rules`` default:
    the current ones."""
    data_axes, size = data_axes_and_size(mesh, rules)

    def names(specs) -> bool:
        if isinstance(specs, dict):
            return any(names(v) for v in specs.values())
        return any(a == data_axes for a in specs)

    return size > 1 and names(pspecs)


@contextlib.contextmanager
def expert_shard(groups: dict | None):
    """For the block, MoE layers compute one data shard of the training
    mesh's batch: ``groups`` maps each of the shard's MoE modules to its
    model devices' (device, MoE module), in model order."""
    prev = current_expert_shard()
    _ctx.expert_groups = groups
    try:
        yield
    finally:
        _ctx.expert_groups = prev


def current_expert_shard() -> dict | None:
    """The groups of the :func:`expert_shard` block being run, or None."""
    return getattr(_ctx, "expert_groups", None)


class TensorShard:
    """One data shard's model group on the training mesh: its ``devices``
    in model order and each one's copy of the parameters (``copies``, the
    first the lead's, whose modules the forward runs on), where each leaf
    of ``model_dims`` ({name: dim or None}) not None is stored as its
    slice of that dim, one of ``tp`` (the "model" axis; a
    :class:`~repro_torch.launch.mesh.RoleMesh` group may hold fewer
    devices than that).

    Layers ask it for a module's counterpart on each device
    (:meth:`members`) and gather a split leaf before use (:meth:`gather`,
    :meth:`whole`)."""

    def __init__(self, devices, copies, model_dims: dict, tp: int):
        self.devices, self.tp = list(devices), tp
        lead = copies[0]
        self._members = {id(mod): [c.get_submodule(name) for c in copies] for name, mod in lead.named_modules()}
        named = [dict(c.named_parameters()) for c in copies]
        self._parts = {id(named[0][n]): (dim, [ns[n] for ns in named])
                       for n, dim in model_dims.items() if dim is not None}

    def members(self, module) -> list:
        """``module`` (the lead's) on each device of the group, in order."""
        return self._members[id(module)]

    def is_split(self, p) -> bool:
        """``p`` (a leaf, or a module: any of its leaves) is stored split."""
        if isinstance(p, torch.Tensor):
            return id(p) in self._parts
        return id(p) in self._members and any(id(w) in self._parts for w in p.parameters())

    def gather(self, w, at=None) -> list:
        """The split leaf ``w`` (the lead's slice) whole on the group's
        devices at positions ``at`` (default: all), one tensor each; its
        gradient is reduce-scattered back to the slices."""
        from repro_torch.distributed import collectives as C

        dim, parts = self._parts[id(w)]
        return C.all_gather(parts, self.devices, dim, at, self.tp)

    def substitute(self, stored, parts):
        """For the block being run, ``parts`` (the split leaf ``stored``'s
        slices gathered over the data axes, one a device of the group, the
        lead's first) are that leaf (FSDP, :func:`gathered`); returns a
        function that ends it."""
        key, prev = id(parts[0]), self._parts.get(id(parts[0]))  # the lead's own layer: the stored leaf
        self._parts[key] = (self._parts[id(stored)][0], parts)
        return lambda: self._parts.__setitem__(key, prev) if prev is not None else self._parts.pop(key)

    def whole(self, module):
        """``module`` with every split leaf gathered whole on the lead (a
        namespace of its leaves and submodules), or ``module`` itself when
        none is split: what a layer that cannot use the slices computes
        with."""
        if not self.is_split(module):
            return module
        leaves = {name: None if w is None else (self.gather(w, (0,))[0] if self.is_split(w) else w)
                  for name, w in module._parameters.items()}
        subs = {name: None if m is None else self.whole(m) for name, m in module._modules.items()}
        # attributes that are neither leaf nor submodule (a MoE's ``shared = None``)
        plain = {k: v for k, v in vars(module).items() if not k.startswith("_") and k != "training"}
        return SimpleNamespace(**plain, **leaves, **subs)


@contextlib.contextmanager
def tensor_shard(shard: TensorShard | None):
    """For the block, layers compute one data shard of the training mesh
    over its model group (``shard``), the "model"-split leaves as their
    slices."""
    prev = current_tensor_shard()
    _ctx.tensor_shard = shard
    try:
        yield
    finally:
        _ctx.tensor_shard = prev


def current_tensor_shard() -> TensorShard | None:
    """The :class:`TensorShard` of the :func:`tensor_shard` block being
    run, or None."""
    return getattr(_ctx, "tensor_shard", None)


def whole(module):
    """``module`` with its split leaves gathered on the lead inside a
    :func:`tensor_shard` block (:meth:`TensorShard.whole`); else
    ``module``."""
    shard = current_tensor_shard()
    return module if shard is None else shard.whole(module)


class DataShards:
    """The training mesh's FSDP leaves for one step: each device's stored
    part of every data-split leaf (``copies``, one ``TransformerLM`` a
    device) and where each part lives (``layout``, a ``zero.Layout``:
    ``fsdp_dim``, ``column``, ``owner``).  :func:`gathered` reads it."""

    def __init__(self, devices, copies, layout):
        self.devices, self.layout = list(devices), layout
        self.named = [dict(c.named_parameters()) for c in copies]
        self._where = {id(mod): (q, name) for q, c in enumerate(copies) for name, mod in c.named_modules()}

    def gather(self, name: str, q: int) -> torch.Tensor:
        """Leaf ``name``'s "model" slice whole on device ``q``: a feature
        dim's parts all-gathered over ``q``'s data column (each part's
        gradient the scatter of ``q``'s), or a layer copied from the data
        index that owns it (its gradient sent back; the stored tensor
        itself when ``q`` owns it)."""
        from repro_torch.distributed import collectives as C

        lay, devs = self.layout, self.devices
        dim = lay.fsdp_dim[name]
        if dim == -1:
            owner, held = lay.owner(name, q)  # held: a RoleMesh's stand-in layer where the owner is absent
            if (owner, held) == (q, name):
                return self.named[q][name]
            pair = [devs[owner], devs[q]] if owner != q else [devs[q]]
            return C.send(self.named[owner][held], pair, 0, len(pair) - 1)
        col = lay.column(q)
        return C.all_gather([self.named[s][name] for s in col], [devs[s] for s in col], dim,
                            (col.index(q),), lay.data_size, alone=True)[0]


@contextlib.contextmanager
def data_shards(shards: DataShards | None):
    """For the block, the training mesh's step keeps ``shards``' FSDP
    leaves: :func:`gathered` gathers them."""
    prev = current_data_shards()
    _ctx.data_shards = shards
    try:
        yield
    finally:
        _ctx.data_shards = prev


def current_data_shards() -> DataShards | None:
    return getattr(_ctx, "data_shards", None)


@contextlib.contextmanager
def gathered(*modules, leaves=None):
    """For the block, under :func:`data_shards`, every data-split leaf of
    ``modules`` (the lead's; with ``leaves``, only those of each module's
    own leaves) is its "model" slice gathered over the data axes, in each
    device's module of the current tensor shard (or the lead's alone); the
    tensor shard's :meth:`TensorShard.gather` and :meth:`TensorShard.whole`
    then join those slices.  Afterwards the stored parts are back and the
    gathered ones free.  Outside a :func:`data_shards` block: nothing."""
    fsdp = current_data_shards()
    if fsdp is None:
        yield
        return
    shard = current_tensor_shard()
    undo = []
    try:
        for mod in modules:
            members = shard.members(mod) if shard is not None else [mod]
            where = [fsdp._where[id(m)] for m in members]
            subs = leaves if leaves is not None else [n for n, _ in mod.named_parameters()]
            for sub in subs:
                owner, _, leaf = sub.rpartition(".")
                name = f"{where[0][1]}.{sub}" if where[0][1] else sub
                if fsdp.layout.fsdp_dim[name] is None:
                    continue
                parts = [fsdp.gather(name, q) for q, _ in where]
                for m, part in zip(members, parts):
                    holder = m.get_submodule(owner)
                    undo.append(lambda h=holder, k=leaf, old=holder._parameters[leaf]: h._parameters.__setitem__(k, old))
                    holder._parameters[leaf] = part
                if shard is not None and shard.is_split(fsdp.named[where[0][0]][name]):
                    undo.append(shard.substitute(fsdp.named[where[0][0]][name], parts))
        yield
    finally:
        for fn in reversed(undo):
            fn()


def remat_kwargs() -> dict:
    """``torch.utils.checkpoint`` keywords that recompute a layer under the
    rules, mesh, expert shard, tensor shard and data shards current at its
    forward, in its logical device's scope (the backward may recompute on
    another thread, the autograd engine's, on another device's stream);
    none when none is set."""
    rules, mesh, groups = get_rules(), current_mesh(), current_expert_shard()
    shard, fsdp, dev = current_tensor_shard(), current_data_shards(), current_logical()
    if rules is None and mesh is None and groups is None and shard is None and fsdp is None and dev is None:
        return {}

    @contextlib.contextmanager
    def recompute():
        with (use_rules(rules), mesh or contextlib.nullcontext(), expert_shard(groups), tensor_shard(shard),
              data_shards(fsdp), dev.scope() if dev is not None else contextlib.nullcontext()):
            yield

    return {"context_fn": lambda: (contextlib.nullcontext(), recompute())}


# ------------------------------------------------------------------ params

# Path-pattern -> logical names per dimension.  First match wins.  Patterns
# are matched against "/".join(path keys) of the reference's pytree.
_PARAM_RULES: list[tuple[str, tuple[str | None, ...]]] = [
    (r"embed", ("vocab", None)),
    (r"lm_head", (None, "vocab")),
    (r"(wq_b|wq)$", (None, "heads")),
    (r"(wk|wv)$", (None, "kv_heads")),
    (r"wo$", ("heads", None)),
    (r"wkv_b$", (None, "heads")),
    (r"(wq_a|wkv_a)$", (None, None)),
    # EP and TP share the "model" mesh axis: experts shard on it, so the
    # per-expert FFN dims must stay unsharded (pure expert parallelism).
    (r"experts/.*(w_gate|w_up)$", ("experts", None, None)),
    (r"experts/.*w_down$", ("experts", None, None)),
    (r"(w_gate|w_up)$", (None, "mlp")),
    (r"w_down$", ("mlp", None)),
    (r"router$", (None, "experts")),
    (r"(conv_w|conv_kernel)", (None, None, None)),
    # SSM / xLSTM projections
    (r"(in_proj|up_proj|o_gate|w_in|w_rec)$", (None, "mlp")),
    (r"(out_proj|down_proj)$", ("mlp", None)),
]


def _path_str(path) -> str:
    """A leaf path (its keys in the reference's pytree) as "a/b/c"."""
    return "/".join(str(k) for k in path)


def spec_for_leaf(name: str, leaf) -> P:
    """PartitionSpec of the port's parameter ``name`` by path rules, in the
    reference's layout: a layer's parameter is a slice of a leaf stacked
    under a leading layer axis, so its rule is left-padded with None to
    that leaf's rank (``transformer.jax_ndim``)."""
    from repro_torch.models.transformer import _jax_path, jax_ndim

    rules = get_rules() or SINGLE_POD_RULES
    ps = _path_str(_jax_path(name)[0])
    for pat, names in _PARAM_RULES:
        if re.search(pat, ps):
            axes = [rules.get(n) if n is not None else None for n in names]
            pad = jax_ndim(name, leaf) - len(axes)
            if pad < 0:  # rule arity exceeds leaf ndim: replicate
                return P()
            return P(*([None] * pad + axes))
    return P()  # norms, biases, scalars: replicated


def param_pspecs(model) -> dict:
    """The specs of ``model``'s parameters (a ``TransformerLM``) as the
    reference's pytree: nested dicts keyed as ``init_lm``'s, one spec per
    leaf (a layer group's one, for its stacked leaf)."""
    from repro_torch.models.transformer import _jax_path

    tree: dict = {}
    for name, w in model.named_parameters():
        path = _jax_path(name)[0]
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = spec_for_leaf(name, w)
    return tree


def spec_at(tree: dict, name: str):
    """The entry of a reference-layout tree (specs, shapes) for the port's
    parameter ``name``."""
    from repro_torch.models.transformer import _jax_path

    node = tree
    for part in _jax_path(name)[0]:
        node = node[part]
    return node


# ----------------------------------------------------------------- serving


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
