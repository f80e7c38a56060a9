"""The encoder-decoder on the serving mesh in the port against the
reference on the CPU: whisper-large-v3's encoder run on each data shard's
model group, its cross K/V cache placed under the reference's cache specs
(``launch/specs.py`` ``cache_structs_and_specs``: ``("layers", "batch",
"enc_seq", "kv_heads", "head")``, the rows over the data axes, the heads
over "model" where the policy splits the self-attention cache's heads,
the encoder's sequence never split) beside the self-attention cache.

Two layouts (``choose_cache_policy``): (H) on (1, 2), (2, 1) and (2, 2)
the smoke config's 4 heads split over "model", the self cache by heads and
rows, the cross cache by heads and rows, each model device projecting the
K/V of its heads (``layers.gqa_tp_kv(kv_x=)``) and running K3 / K4 on
them; (Q) on (1, 8) and (2, 8) the heads split no group, the self cache
splits by sequence and the cross cache is whole on each model device: each
projects the encoder's output with its stored columns of ``wk`` / ``wv``,
the columns gathered into every replica, and the lead runs K3 / K4 over
its own replica.

Meshes of logical CPU devices (``REPRO_TORCH_FORCE_DEVICE_COUNT``); the
smoke configuration (4 heads of 16, 2 encoder + 2 decoder layers, 16
frames) with the reference's weights (``from_jax_params``), tokens and
frames drawn with numpy from seeds.  Tolerances: logits against the
reference's single-device ``prefill(encoder_frames=)`` / ``decode_step``
(JAX, f32) within ``test_torch_lm.py``'s ``RTOL`` (1e-4 of the largest
|logit|); each device's self and cross cache slices against the port's own
single-device cache within ``test_torch_serve_mesh.py``'s ``CACHE_RTOL``
(1e-5 of the largest |entry|: the encoder's and the MLP's partial sums
precede the writes); replicas and placement bitwise.
"""

import collections
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import decode as RD  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.shapes import SHAPES, InputShape  # noqa: E402
from repro_torch.device import current_logical  # noqa: E402
from repro_torch.distributed import sharding as S  # noqa: E402
from repro_torch.distributed import zero as Z  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import hlo_analysis as H  # noqa: E402
from repro_torch.launch import specs as TS  # noqa: E402
from repro_torch.launch.mesh import make_mesh, make_production_mesh  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.serving.kv_cache import CachePolicy, choose_cache_policy  # noqa: E402

from test_torch_lm import RTOL, _close  # noqa: E402
from test_torch_serve_mesh import CACHE_RTOL, N_PRE, STEPS, _setup  # noqa: E402
from test_torch_tensor_parallel import _spec_slice  # noqa: E402
from test_torch_train_mesh import _mesh  # noqa: E402

ARCH = "whisper-large-v3"
# 32 keys: 4 a device where the sequence splits over 8, 2 over 16; no self slice is as long as the 16 frames, so
# a K4 launch over the cross cache is told by its key length
MAX_LEN = 32
# mesh -> (shape, layout): (H) the heads split over "model", (Q) the self cache split by sequence
MESHES = {"1x2": ((1, 2), "H"), "2x1": ((2, 1), "H"), "2x2": ((2, 2), "H"), "1x8": ((1, 8), "Q"),
          "2x8": ((2, 8), "Q")}
_REF: dict = {}


def _frames(cfg, rows: int) -> np.ndarray:
    return np.random.default_rng(5).normal(size=(4, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)[:rows]


def _reference(rows: int) -> list:
    """The reference's single-device logits over the first ``rows`` rows:
    prefill of N_PRE tokens over the frames into a MAX_LEN cache, then
    STEPS decode steps (cached)."""
    if rows not in _REF:
        ref_cfg, cfg, params, _, toks, _ = _setup(ARCH)
        jp = jax.tree.map(jnp.asarray, params)
        lg, cache, lens = RD.prefill(jp, ref_cfg, jnp.asarray(toks[:rows, :N_PRE]), max_len=MAX_LEN,
                                     cache_dtype=jnp.float32, encoder_frames=jnp.asarray(_frames(cfg, rows)))
        out = [np.asarray(lg)]
        for t in range(STEPS):
            lg, cache, lens = RD.decode_step(jp, ref_cfg, jnp.asarray(toks[:rows, N_PRE + t]), cache, lens)
            out.append(np.asarray(lg))
        _REF[rows] = out
    return _REF[rows]


def _single_run(cfg, model, toks, policy, rows: int) -> dict:
    """The port's single-device cache after prefill and STEPS decode steps
    of the first ``rows`` rows."""
    _, single, lens = D.prefill(model, cfg, torch.from_numpy(toks[:rows, :N_PRE]), max_len=MAX_LEN,
                                kv_repeat=policy.kv_repeat, cache_dtype=torch.float32,
                                encoder_frames=torch.from_numpy(_frames(cfg, rows)))
    for t in range(STEPS):
        _, single, lens = D.decode_step(model, cfg, torch.from_numpy(toks[:rows, N_PRE + t]), single, lens,
                                        kv_repeat=policy.kv_repeat)
    return single


def _serve(cfg, model, mesh, toks, rows: int):
    """Place ``model`` on ``mesh`` under the serving specs, prefill N_PRE
    tokens of each row over its frames into a MAX_LEN cache (at a batch
    below the data size the mesh's prefill raises, and the port's
    single-device prefill cache is placed with ``place_cache``), then STEPS
    decode steps -> (logits per call, the placed cache, the policy)."""
    with S.use_rules(S.SINGLE_POD_RULES):
        policy = choose_cache_policy(cfg, mesh.shape["model"], rows, mesh.shape["data"])
        pspecs = S.param_pspecs(model)
        placed = Z.place_params(model, mesh, pspecs)
        prefill = D.make_mesh_prefill(cfg, mesh, pspecs, policy)
        step = D.make_mesh_decode_step(cfg, mesh, pspecs, policy)
    prompt, frames = torch.from_numpy(toks[:rows, :N_PRE]), torch.from_numpy(_frames(cfg, rows))
    if policy.shard_batch:
        with pytest.raises(ValueError, match="encoder_frames"):
            prefill(placed, prompt, max_len=MAX_LEN, cache_dtype=torch.float32)
        lg, cache, lens = prefill(placed, prompt, max_len=MAX_LEN, cache_dtype=torch.float32, encoder_frames=frames)
    else:
        with pytest.raises(ValueError, match="does not split over"):
            prefill(placed, prompt, max_len=MAX_LEN, cache_dtype=torch.float32, encoder_frames=frames)
        lg, single, lens = D.prefill(model, cfg, prompt, max_len=MAX_LEN, kv_repeat=policy.kv_repeat,
                                     cache_dtype=torch.float32, encoder_frames=frames)
        with S.use_rules(S.SINGLE_POD_RULES):
            cache = D.place_cache(single, mesh, policy)
    out = [lg]
    for t in range(STEPS):
        lg, cache2, lens = step(placed, torch.from_numpy(toks[:rows, N_PRE + t]), cache, lens)
        assert cache2 is cache and lg.device == mesh.flat[0].device
        out.append(lg)
    assert lens.tolist() == [N_PRE + STEPS] * rows
    return out, cache, policy


def _spied(monkeypatch, cfg) -> dict:
    """K3's and K4's calls by (logical device, what they attend): K3 over
    the encoder's frames ("encoder"), the prompt ("self") or the frames
    from the prompt ("cross"); K4 over a self cache slice or the cross
    cache (its keys as many as the frames).  A call outside any logical
    device, the single-device prefill at batch 1, is not recorded."""
    seen = {"k3": collections.Counter(), "k4": collections.Counter()}

    def k3(fn):
        def wrapped(q, k, v, *args, **kw):
            what = "cross" if q.shape[1] != k.shape[1] else "encoder" if k.shape[1] == cfg.encoder_seq_len else "self"
            if current_logical() is not None:
                seen["k3"][current_logical().label, what] += 1
            return fn(q, k, v, *args, **kw)
        return wrapped

    def k4(fn):
        def wrapped(q, k, v, *args, **kw):
            if current_logical() is not None:
                seen["k4"][current_logical().label, "cross" if k.shape[1] == cfg.encoder_seq_len else "self"] += 1
            return fn(q, k, v, *args, **kw)
        return wrapped

    monkeypatch.setattr(L, "attention_scores_blockwise", k3(L.attention_scores_blockwise))
    monkeypatch.setattr(da_ops, "decode_attention_cache", k4(da_ops.decode_attention_cache))
    return seen


def _expected_launches(cfg, mesh, layout: str, rows: int) -> dict:
    """Where the design runs K3 and K4: (H) on every model device of every
    data shard (the encoder's attention, self and cross attention
    head-parallel; a group of one device computes whole); (Q) K3 on each
    shard's lead alone, K4 over the self cache on every device holding its
    keys (all of them) and over the cross cache on each shard's lead; at a
    batch below the data size the first shard alone computes and prefill
    is the single device's."""
    n, labels = cfg.num_layers, [dev.label for dev in mesh.flat]
    shards = mesh.shape["data"] if rows >= mesh.shape["data"] else 1
    leads = [labels[i * mesh.shape["model"]] for i in range(shards)]
    k3, k4 = collections.Counter(), collections.Counter()
    for label in (labels if layout == "H" else leads if rows >= mesh.shape["data"] else []):
        for what in ("encoder", "self", "cross"):
            k3[label, what] = (cfg.encoder_layers if what == "encoder" else n)
    for label in labels:
        k4[label, "self"] = n * STEPS
    for label in (labels if layout == "H" else leads):
        k4[label, "cross"] = n * STEPS
    return {"k3": k3, "k4": k4}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_encdec_logits_against_reference(mesh, monkeypatch):
    """Prefill's last-token logits and STEPS decode steps' within RTOL of
    the reference's single-device run, every row on the mesh's first
    device; prefill without frames raises; the policy is the layout's, and
    K3 / K4 ran where the design says (:func:`_expected_launches`)."""
    shape, layout = MESHES[mesh]
    _, cfg, _, model, toks, _ = _setup(ARCH)
    want = _reference(4)
    m = _mesh(shape, monkeypatch)
    seen = _spied(monkeypatch, cfg)
    got, _, policy = _serve(cfg, model, m, toks, 4)
    for g, w in zip(got, want):
        assert g.shape == (4, cfg.padded_vocab_size)
        _close(g, w, RTOL, cfg.vocab_size)
    assert (policy.shard_heads, policy.seq_axes) == ((True, ()) if layout == "H" else (False, ("model",)))
    assert seen == _expected_launches(cfg, m, layout, 4), (mesh, seen)


def _hold_slices(cache, single, policy, m) -> dict:
    """Each device's slice of every leaf (self k, v and cross k, v) is the
    same slice of the single-device cache within CACHE_RTOL; returns the
    devices' slices by (leaf, the mesh indices its spec splits over)."""
    with S.use_rules(S.SINGLE_POD_RULES):
        specs = D.cache_pspecs(single, policy, m)
    held: dict = {}
    for q, mine in enumerate(cache):
        assert set(mine) == set(single) == {"k", "v", "cross_k", "cross_v"}
        for key, whole in single.items():
            want = _spec_slice(whole.numpy(), specs[key], m, q)
            got = mine[key].numpy()
            assert got.shape == want.shape and got.dtype == want.dtype, (key, q)
            assert np.abs(got - want).max() <= CACHE_RTOL * np.abs(want).max(), (key, q)
            where = tuple(int(m.coords(q)[a]) for a in ("data", "model")
                          if any(a in (ax if isinstance(ax, tuple) else (ax,)) for ax in specs[key] if ax))
            held.setdefault((key, where), []).append(mine[key])
    return held


@pytest.mark.parametrize("mesh", list(MESHES))
def test_encdec_cache_slices_are_the_single_device_caches(mesh, monkeypatch):
    """After prefill and the decode steps every device holds its slice of
    the self cache (its rows and heads in (H), its rows and keys in (Q))
    and of the cross cache (its rows and heads in (H); its rows, every
    head, in (Q)) of the port's single-device cache after the same calls,
    within CACHE_RTOL; the replicas of the cross cache (each model device's
    in (Q)) are bitwise equal; ``gather_cache`` joins the slices back."""
    shape, layout = MESHES[mesh]
    _, cfg, _, model, toks, _ = _setup(ARCH)
    m = _mesh(shape, monkeypatch)
    _, cache, policy = _serve(cfg, model, m, toks, 4)
    single = _single_run(cfg, model, toks, policy, 4)
    held = _hold_slices(cache, single, policy, m)
    for (key, where), parts in held.items():
        assert all(torch.equal(t, parts[0]) for t in parts[1:]), (key, where)
    tp, rows = shape[1], 4 // shape[0]
    heads = cfg.num_kv_heads // tp if layout == "H" else cfg.num_kv_heads
    assert cache[0]["cross_k"].shape == (cfg.num_layers, rows, cfg.encoder_seq_len, heads, cfg.resolved_head_dim)
    assert cache[0]["k"].shape[2] == (MAX_LEN if layout == "H" else MAX_LEN // tp)
    assert max(len(parts) for (key, _), parts in held.items() if key == "cross_k") == (tp if layout == "Q" else 1)
    with S.use_rules(S.SINGLE_POD_RULES):
        back = D.gather_cache(cache, m, policy)
    assert {k: v.shape for k, v in back.items()} == {k: v.shape for k, v in single.items()}
    for k in back:
        assert (back[k] - single[k]).abs().max() <= CACHE_RTOL * single[k].abs().max(), k


def test_encdec_decode_at_batch_one(monkeypatch):
    """Batch 1 on (2, 8): ``choose_cache_policy`` splits the self cache's
    sequence over ("data", "model"), 2 keys a device, and the cross cache
    is whole on all 16 devices.  The mesh's prefill of one row raises (the
    rows do not split over the data axes); the port's single-device prefill
    cache placed with ``place_cache``, then STEPS decode steps: logits
    within RTOL of the reference's, the layers on the first data index's
    lead (its cross attention over its own replica), K4 over the self cache
    on all 16 devices, and each device's slices the single-device cache's,
    the 16 cross replicas bitwise equal."""
    _, cfg, _, model, toks, _ = _setup(ARCH)
    want = _reference(1)
    m = _mesh((2, 8), monkeypatch)
    seen = _spied(monkeypatch, cfg)
    got, cache, policy = _serve(cfg, model, m, toks, 1)
    assert policy == CachePolicy(1, False, False, ("data", "model"))
    for g, w in zip(got, want):
        _close(g, w, RTOL, cfg.vocab_size)
    assert seen == _expected_launches(cfg, m, "Q", 1), seen
    held = _hold_slices(cache, _single_run(cfg, model, toks, policy, 1), policy, m)
    assert len(held["cross_k", ()]) == 16 and cache[0]["k"].shape[2] == MAX_LEN // 16
    for (key, where), parts in held.items():
        assert all(torch.equal(t, parts[0]) for t in parts[1:]), (key, where)


@pytest.mark.parametrize("mesh", ["2x2", "1x8"])
def test_placed_cross_cache_is_the_reference_specs_slices(mesh, monkeypatch):
    """A seeded single-device cache (self and cross leaves) placed with
    ``place_cache`` is, on each device, the numpy slice of the reference's
    cache specs (the cross cache's heads over "model" on (2, 2), whole on
    each of (1, 8)'s 8); ``gather_cache`` joins it back bitwise;
    ``init_mesh_cache`` makes the same shapes, the cross leaves in the
    dtype it is given."""
    shape, _ = MESHES[mesh]
    cfg = configs.get_smoke_config(ARCH)
    m = _mesh(shape, monkeypatch)
    rng = np.random.default_rng(3)
    with S.use_rules(S.SINGLE_POD_RULES):
        policy = choose_cache_policy(cfg, shape[1], 4, shape[0])
        cache = {k: torch.from_numpy(rng.normal(size=v.shape).astype(np.float32))
                 for k, v in D.init_cache(cfg, 4, 16, policy.kv_repeat, torch.float32, "cpu").items()}
        placed = D.place_cache(cache, m, policy)
        specs = D.cache_pspecs(cache, policy, m)
        back = D.gather_cache(placed, m, policy)
        zeros = D.init_mesh_cache(cfg, m, policy, 4, 16, torch.float32, cross_dtype=torch.bfloat16)
    assert specs["cross_k"] == S.P(None, "data", None, "model" if shape[1] == 2 else None, None)
    for q, mine in enumerate(placed):
        for key, whole in cache.items():
            assert np.array_equal(mine[key].numpy(), _spec_slice(whole.numpy(), specs[key], m, q)), (key, q)
            assert zeros[q][key].shape == mine[key].shape and not zeros[q][key].any()
            assert zeros[q][key].dtype == (torch.bfloat16 if key.startswith("cross_") else torch.float32)
    assert all(torch.equal(back[k], cache[k]) for k in cache)


@pytest.mark.parametrize("mesh", ["2x2", "1x8"])
def test_init_mesh_cache_makes_no_whole_cache_in_a_trace(mesh):
    """Inside a trace (meta tensors, ``hlo_analysis.analyze``), as a mesh
    prefill runs it, ``init_mesh_cache`` makes only each device's slices:
    the peak of live bytes is the busiest device's slices (self and cross
    leaves), not the whole cache (``decode.cache_leaves`` gives the shapes
    and allocates nothing)."""
    shape, _ = MESHES[mesh]
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH), head_dim=64)
    m = make_mesh(shape, ("data", "model"), H.trace_devices(shape[0] * shape[1]))
    with S.use_rules(S.SINGLE_POD_RULES):
        policy = choose_cache_policy(cfg, shape[1], 4, shape[0])
        parts, summary, _ = H.analyze(lambda: D.init_mesh_cache(cfg, m, policy, 4, 64))
    mine = [sum(t.numel() * t.element_size() for t in p.values()) for p in parts]
    whole = sum(math.prod(shp) * dt.itemsize for shp, dt in D.cache_leaves(cfg, 4, 64, policy.kv_repeat).values())
    assert summary.temp_bytes == max(mine) < whole


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_production_cells_place_the_reference_layout(shape, multi_pod):
    """whisper-large-v3 at full size on the 16x16 and 2x16x16 meshes (their
    RoleMesh, meta tensors): its 20 heads split no group over 16, so the
    self cache splits by sequence and the cross cache is whole on each
    model device.  The cells are served, not skipped, and the busiest
    device's argument bytes equal the spec trees' (the weights at 2 bytes,
    the cache, cross leaves included, at the reference's bf16, the inputs
    over the data axes) plus 2 bytes for each element of the f32 norm
    scales.  A decode_32k device holds its 8 rows (4 on 2x16x16) x 2048
    of the 32,768 keys x 20 heads, and the cross cache of its rows whole:
    1,966,080,000 B on 16x16."""
    cfg = configs.get_config(ARCH)
    mesh = make_production_mesh(multi_pod=multi_pod, devices=H.trace_devices(512 if multi_pod else 256))
    rules = S.MULTI_POD_RULES if multi_pod else S.SINGLE_POD_RULES
    with S.use_rules(rules):
        spec = TS.build_cell(cfg, SHAPES[shape], mesh)
    assert spec.skip is None
    placed = spec.args[0]
    wide = {name: w for name, w in placed[0].named_parameters() if w.element_size() > 2}
    assert wide and all(w.dtype == torch.float32 and "norm" in name for name, w in wide.items())
    assert spec.dtype_surplus_bytes == 2 * sum(w.numel() for w in wide.values())
    assert spec.argument_bytes == spec.reference_argument_bytes + spec.dtype_surplus_bytes
    assert len(placed) == len(spec.device_args) == (18 if multi_pod else 9)
    if SHAPES[shape].kind != "decode":
        assert set(spec.args[2]) == {"encoder_frames"}
        return
    cache, cell, data = spec.args[2][0], SHAPES[shape], 32 if multi_pod else 16
    rows, n, hd = cell.global_batch // data, cfg.num_layers, cfg.resolved_head_dim
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} == {
        "k": ((n, rows, 2048, 20, hd), torch.bfloat16), "v": ((n, rows, 2048, 20, hd), torch.bfloat16),
        "cross_k": ((n, rows, 1500, 20, hd), torch.bfloat16), "cross_v": ((n, rows, 1500, 20, hd), torch.bfloat16)}
    cross = sum(cache[k].numel() * cache[k].element_size() for k in ("cross_k", "cross_v"))
    assert cross == 1_966_080_000 // (2 if multi_pod else 1)
    with S.use_rules(rules):
        whole, specs = TS.cache_structs_and_specs(cfg, cell, choose_cache_policy(cfg, 16, cell.global_batch, data),
                                                  mesh)
    assert sum(t.numel() * t.element_size() for t in cache.values()) == TS._cache_spec_bytes(whole, specs, mesh)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("shape", [(2, 4), (2, 8)], ids=["heads-2x4", "sequence-2x8"])
def test_role_mesh_trace_equals_a_full_trace_of_an_encdec_cell(kind, shape, monkeypatch):
    """The smoke whisper-large-v3 at head width 64 (which the kernels take)
    in a 64-token cell at batch 4: on (2, 4) its 4 heads split (layout H),
    on (2, 8) they do not (layout Q).  A trace on the mesh's RoleMesh (3
    indices an axis) counts what a trace of every device counts, per
    device: the encoder's and the cross attention's collectives (the
    column gathers of the cross K/V into each replica in Q), the ring sums
    (whose flats hold no padding for the group of roles), the launches (K3
    2 encoder + 2 self + 2 cross a prefill, K4 2 self + 2 cross a step on
    the busiest device), FLOPs, traffic and bytes."""
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH), head_dim=64)
    cell = InputShape("c", kind, 64, 4)
    mesh = make_mesh(shape, ("data", "model"), H.trace_devices(shape[0] * shape[1]))
    short = dryrun.run_cell(cfg, cell, mesh)
    monkeypatch.setattr(TS, "RoleMesh", lambda m: m)
    full = dryrun.run_cell(cfg, cell, mesh)
    assert short["hlo"] == full["hlo"] and short["memory"] == full["memory"]
    want = ({"flash_attention": cfg.encoder_layers + 2 * cfg.num_layers} if kind == "prefill"
            else {"decode_attention": 2 * cfg.num_layers})
    assert short["hlo"]["launches"] == want
    assert short["hlo"]["collective_bytes"]["all-reduce" if shape[1] == 4 else "all-gather"] > 0
