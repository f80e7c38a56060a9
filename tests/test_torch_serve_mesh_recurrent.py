"""The recurrent states on the serving mesh in the port against the
reference on the CPU: xlstm-125m's mLSTM and sLSTM states and hymba-1.5b's
Mamba states (beside its attention cache, split by sequence) placed under
the reference's cache specs (``launch/specs.py`` ``cache_structs_and_specs``:
a state's heads and channels over "model" where they split evenly, else
whole on every model device; its rows over the data axes where the batch
splits, else whole on every data index).

``decode.make_mesh_prefill`` / ``make_mesh_decode_step`` run each layer's
recurrent branch on its data shard's lead over the branch's leaves gathered
there, the state gathered from the shard's model group in decode, and send
every device holding the rows its slice of the new state, or the whole.

Meshes of logical CPU devices (``REPRO_TORCH_FORCE_DEVICE_COUNT``): xlstm on
(2, 2) (2 mLSTM heads and 16 channels a device), (1, 8) (4 heads over 8:
whole on each device, 4 channels a device: 16x16's layout) and (2, 2) at
batch 1 (the rows whole on both data indices); hymba on (2, 2), (1, 4) and
(2, 2) at batch 1 (its 5 KV heads split no group: the sequence over
"model", over ("data", "model") at batch 1).  The smoke configurations
with the reference's weights (``from_jax_params``).  Tolerances: logits
against the reference's single-device ``prefill`` / ``decode_step`` (JAX,
f32) within ``test_torch_lm.py``'s ``RTOL`` (1e-4 of the largest |logit|);
each device's cache slice against the port's own single-device cache
within ``test_torch_serve_mesh.py``'s ``CACHE_RTOL`` (1e-5 of the largest
|entry|: the MLP's and the vocabulary's partial sums precede later layers);
the devices holding the same slice bitwise equal to each other.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import configs  # noqa: E402
from repro_torch.configs.shapes import SHAPES, InputShape  # noqa: E402
from repro_torch.device import current_logical  # noqa: E402
from repro_torch.distributed import sharding as S  # noqa: E402
from repro_torch.distributed import zero as Z  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.selective_scan import ops as scan_ops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import hlo_analysis as H  # noqa: E402
from repro_torch.launch import specs as TS  # noqa: E402
from repro_torch.launch.mesh import make_mesh, make_production_mesh  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving.kv_cache import choose_cache_policy  # noqa: E402

from test_torch_lm import RTOL, _close  # noqa: E402
from test_torch_serve_mesh import CACHE_RTOL, N_PRE, STEPS, _reference_run, _setup, _single_run  # noqa: E402
from test_torch_tensor_parallel import _spec_slice  # noqa: E402
from test_torch_train_mesh import _mesh  # noqa: E402

MAX_LEN = N_PRE + STEPS + 3  # 16 keys: 8, 4 a device where the sequence splits over 2, 4
# (arch, mesh shape, batch)
CASES = {
    "xlstm-2x2-b4": ("xlstm-125m", (2, 2), 4),
    "xlstm-1x8-b4": ("xlstm-125m", (1, 8), 4),
    "xlstm-2x2-b1": ("xlstm-125m", (2, 2), 1),
    "hymba-2x2-b4": ("hymba-1.5b", (2, 2), 4),
    "hymba-1x4-b4": ("hymba-1.5b", (1, 4), 4),
    "hymba-2x2-b1": ("hymba-1.5b", (2, 2), 1),
}


def _serve(cfg, model, mesh, toks):
    """Place ``model`` on ``mesh`` under the serving specs, prefill N_PRE
    tokens of each row into a MAX_LEN cache (at a batch below the data size
    the mesh's prefill raises, as the reference's cannot split the rows: the
    port's single-device prefill cache is placed with ``place_cache``), then
    STEPS decode steps -> (logits per call, the placed cache, the policy)."""
    rows = toks.shape[0]
    with S.use_rules(S.SINGLE_POD_RULES):
        policy = choose_cache_policy(cfg, mesh.shape["model"], rows, mesh.shape["data"])
        pspecs = S.param_pspecs(model)
        placed = Z.place_params(model, mesh, pspecs)
        prefill = D.make_mesh_prefill(cfg, mesh, pspecs, policy)
        step = D.make_mesh_decode_step(cfg, mesh, pspecs, policy)
    prompt = torch.from_numpy(toks[:, :N_PRE])
    if policy.shard_batch:
        lg, cache, lens = prefill(placed, prompt, max_len=MAX_LEN, cache_dtype=torch.float32)
    else:
        with pytest.raises(ValueError, match="does not split over"):
            prefill(placed, prompt, max_len=MAX_LEN, cache_dtype=torch.float32)
        lg, single, lens = D.prefill(model, cfg, prompt, max_len=MAX_LEN, kv_repeat=policy.kv_repeat,
                                     cache_dtype=torch.float32)
        with S.use_rules(S.SINGLE_POD_RULES):
            cache = D.place_cache(single, mesh, policy)
    out = [lg]
    for t in range(STEPS):
        lg, cache2, lens = step(placed, torch.from_numpy(toks[:, N_PRE + t]), cache, lens)
        assert cache2 is cache and lg.device == mesh.flat[0].device
        out.append(lg)
    assert lens.tolist() == [N_PRE + STEPS] * rows
    return out, cache, policy


def _spied(monkeypatch) -> dict:
    """The logical devices K3's, K4's and K6's plain versions run on (a
    call outside any, the single-device prefill at batch 1, is not
    recorded)."""
    seen = {"k3": set(), "k4": set(), "k6": set()}

    def spy(key, fn):
        def wrapped(*args, **kw):
            if current_logical() is not None:
                seen[key].add(current_logical().label)
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(L, "attention_scores_blockwise", spy("k3", L.attention_scores_blockwise))
    monkeypatch.setattr(da_ops, "decode_attention_cache", spy("k4", da_ops.decode_attention_cache))
    monkeypatch.setattr(scan_ops, "selective_scan", spy("k6", scan_ops.selective_scan))
    return seen


@pytest.mark.parametrize("case", list(CASES))
def test_recurrent_logits_against_reference(case, monkeypatch):
    """Prefill's last-token logits (the single device's where the rows do
    not split) and STEPS decode steps' within RTOL of the reference's
    single-device run, every row on the mesh's first device.  The
    recurrent branches ran on the data shards' leads (K6 there for hymba),
    hymba's prefill attention whole on the leads and K4 on every device
    holding keys (every device: the sequence splits over "model", and over
    the data axes too at batch 1); the xLSTM launches no kernel."""
    arch, shape, rows = CASES[case]
    _, cfg, _, model, toks, _ = _setup(arch)
    want = _reference_run(arch, rows, MAX_LEN)
    m = _mesh(shape, monkeypatch)
    seen = _spied(monkeypatch)
    got, _, policy = _serve(cfg, model, m, toks[:rows])
    for g, w in zip(got, want):
        assert g.shape == (rows, cfg.padded_vocab_size)
        _close(g, w, RTOL, cfg.vocab_size)
    leads = {m.flat[i * shape[1]].label for i in range(shape[0] if policy.shard_batch else 1)}
    if arch == "xlstm-125m":
        assert seen == {"k3": set(), "k4": set(), "k6": set()}
    else:
        assert policy.seq_axes == (("model",) if rows >= shape[0] else ("data", "model"))
        assert seen == {"k3": leads if policy.shard_batch else set(), "k4": {dev.label for dev in m.flat},
                        "k6": leads}, (case, seen)


@pytest.mark.parametrize("case", list(CASES))
def test_recurrent_cache_slices_are_the_single_device_caches(case, monkeypatch):
    """After prefill and the decode steps every device holds its slice of
    every leaf (:func:`decode.cache_pspecs`: its rows, its keys, its heads
    and channels of a state where they split, else the whole) of the port's
    single-device cache after the same calls, within CACHE_RTOL; the
    devices holding the same slice (a state whole on each model device, or
    on each data index at batch 1) are bitwise equal; ``gather_cache``
    joins the slices back given the config, and raises without it."""
    arch, shape, rows = CASES[case]
    _, cfg, _, model, toks, _ = _setup(arch)
    m = _mesh(shape, monkeypatch)
    _, cache, policy = _serve(cfg, model, m, toks[:rows])
    single = _single_run(cfg, model, toks, MAX_LEN, policy, rows)
    with S.use_rules(S.SINGLE_POD_RULES):
        specs = D.cache_pspecs(single, policy, m)
    replicas: dict = {}
    for q, mine in enumerate(cache):
        assert set(mine) == set(single)
        for key, whole in single.items():
            want = _spec_slice(whole.numpy(), specs[key], m, q)
            got = mine[key].numpy()
            assert got.shape == want.shape and got.dtype == want.dtype, (key, q)
            assert np.abs(got - want).max() <= CACHE_RTOL * np.abs(want).max(), (key, q)
            where = tuple(int(m.coords(q)[a]) for a in ("data", "model")
                          if any(a in (ax if isinstance(ax, tuple) else (ax,)) for ax in specs[key] if ax))
            replicas.setdefault((key, where), []).append(mine[key])
    # replicas: xlstm's 4 mLSTM heads over 8 model devices, and every state at a batch below the data size
    assert any(len(held) > 1 for held in replicas.values()) == (shape[1] == 8 or rows < shape[0])
    for (key, where), held in replicas.items():
        assert all(torch.equal(t, held[0]) for t in held[1:]), (key, where)
    if arch == "xlstm-125m":
        want_heads = 4 if shape[1] == 8 else 4 // shape[1]  # 4 heads over 8 model devices stay whole
        assert cache[0]["mlstm_c"].shape[2] == want_heads and cache[0]["slstm_h"].shape[2] == 32 // shape[1]
    else:
        assert cache[0]["ssm"].shape[2] == 80 // shape[1] and cache[0]["conv"].shape[3] == 80 // shape[1]
    with S.use_rules(S.SINGLE_POD_RULES):
        with pytest.raises(ValueError, match="cfg="):
            D.gather_cache(cache, m, policy)
        back = D.gather_cache(cache, m, policy, cfg)
    assert {k: v.shape for k, v in back.items()} == {k: v.shape for k, v in single.items()}
    for k in back:
        assert (back[k] - single[k]).abs().max() <= CACHE_RTOL * single[k].abs().max(), k


# ------------------------------------------------------------------ dry run
def _sent(cfg, mesh, policy, batch: int, max_len: int) -> int:
    """The bytes a decode step's busiest lead sends: each layer's new state,
    the leaves of the layer's own kind, to every other device holding its
    rows (its model group where the rows split, else the whole mesh), each
    that device's slice or the whole."""
    with S.use_rules(S.SINGLE_POD_RULES):
        held = D.init_mesh_cache(cfg, mesh, policy, batch, max_len)
    holders = range(1, mesh.size if not policy.shard_batch else mesh.shape["model"])
    kinds = T.layer_flags(cfg).get("is_slstm")
    writes = {"ssm": cfg.num_layers, "conv": cfg.num_layers} if kinds is None else {
        **dict.fromkeys(("mlstm_c", "mlstm_n"), int((~kinds).sum())),
        **dict.fromkeys(D.ssm.SLSTM_STATE, int(kinds.sum()))}
    return sum(held[q][k][0].numel() * held[q][k].element_size() * n for q in holders for k, n in writes.items())


# (arch, mesh shape, batch): hymba's 40-channel residual stream comes out of the embedding's ring sum over a group
# of 3 roles standing for 8 on (2, 8), whose flats hold no padding (``collectives._ring_chunks``)
ROLE_CASES = [("xlstm-125m", (4, 8), 1), ("xlstm-125m", (4, 8), 4), ("hymba-1.5b", (8, 2), 1),
              ("hymba-1.5b", (2, 8), 1)]


@pytest.mark.parametrize("arch,shape,batch", ROLE_CASES)
def test_role_mesh_trace_equals_a_full_trace_of_a_recurrent_cell(arch, shape, batch, monkeypatch):
    """A decode cell with a 64-key cache (hymba at head width 64, which the
    kernels take) traced on the mesh's RoleMesh (3 indices an axis) counts
    what a trace of every device counts, per device: the lead's sends of
    each layer's state to the holders, which on the RoleMesh stand for the
    devices the span leaves out (``Mesh.stands_for``) — to its 7 model
    peers at batch 4, to all 31 other devices at batch 1 (the xLSTM's
    mLSTM state whole on each, its sLSTM channels 4 a device), hymba's
    Mamba slices to all 15 at batch 1 (the data groups hold the rows too)
    — the weights and states gathered on the lead, the launches (K4 and K6
    once a layer, none for the xLSTM), FLOPs, traffic and bytes, the peak
    included: the ring's flats are as long over the group of roles as
    over the whole axis."""
    cfg = configs.get_smoke_config(arch)
    if arch == "hymba-1.5b":
        cfg = dataclasses.replace(cfg, head_dim=64)
    cell = InputShape("c", "decode", 64, batch)
    mesh = make_mesh(shape, ("data", "model"), H.trace_devices(shape[0] * shape[1]))
    short = dryrun.run_cell(cfg, cell, mesh)
    monkeypatch.setattr(TS, "RoleMesh", lambda m: m)
    full = dryrun.run_cell(cfg, cell, mesh)
    assert short["hlo"] == full["hlo"] and short["memory"] == full["memory"]
    want = {} if arch == "xlstm-125m" else {"decode_attention": cfg.num_layers, "selective_scan": cfg.num_layers}
    assert short["hlo"]["launches"] == want
    with S.use_rules(S.SINGLE_POD_RULES):
        policy = choose_cache_policy(cfg, shape[1], batch, shape[0])
    assert short["hlo"]["collective_bytes"]["send"] == _sent(cfg, mesh, policy, batch, 64) > 0


RECURRENT_CELLS = [(arch, shape) for arch in ("xlstm-125m", "hymba-1.5b")
                   for shape in ("prefill_32k", "decode_32k", "long_500k")]


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch,shape", RECURRENT_CELLS)
def test_production_cells_place_the_reference_layout(arch, shape, multi_pod):
    """At full size on the 16x16 and 2x16x16 meshes (their RoleMesh, meta
    tensors) the cells are served, not skipped, and the busiest device's
    argument bytes equal the spec trees': the weights under
    ``param_pspecs`` at 2 bytes, for decode the cache under
    ``cache_structs_and_specs`` at each leaf's dtype in the reference's
    ``init_cache`` (the KV cache and the conv window bf16, the recurrent
    states f32), and the inputs, plus 2 bytes for each element of the
    leaves the port keeps in f32 (norm scales, Mamba's conv, dt, A and D).
    A decode device holds its rows (8 of decode_32k's 128 on 16x16, 4 on
    2x16x16, 1 of long_500k's 1), xlstm's 4 mLSTM heads whole (4 over 16
    do not split) and 768 / 16 = 48 sLSTM channels, hymba's 3200 / 16 =
    200 Mamba channels and its keys (2048 of decode_32k's; of long_500k's
    524,288, split over data too, 2048 or 1024)."""
    cfg = configs.get_config(arch)
    mesh = make_production_mesh(multi_pod=multi_pod, devices=H.trace_devices(512 if multi_pod else 256))
    rules = S.MULTI_POD_RULES if multi_pod else S.SINGLE_POD_RULES
    with S.use_rules(rules):
        spec = TS.build_cell(cfg, SHAPES[shape], mesh)
    assert spec.skip is None
    placed = spec.args[0]
    wide = {name: w for name, w in placed[0].named_parameters() if w.element_size() > 2}
    mamba_f32 = ("conv_w", "dt_bias", "a_log", "d_skip")
    assert wide and all(w.dtype == torch.float32 and ("norm" in name or name.endswith(mamba_f32))
                        for name, w in wide.items())
    assert spec.dtype_surplus_bytes == 2 * sum(w.numel() for w in wide.values())
    assert spec.argument_bytes == spec.reference_argument_bytes + spec.dtype_surplus_bytes
    assert len(placed) == len(spec.device_args) == (18 if multi_pod else 9)
    if SHAPES[shape].kind != "decode":
        return
    cache, cell, data = spec.args[2][0], SHAPES[shape], 32 if multi_pod else 16
    rows = cell.global_batch // data if cell.global_batch >= data else 1
    n = cfg.num_layers
    if arch == "xlstm-125m":
        assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} == {
            "mlstm_c": ((n, rows, 4, 384, 384), torch.float32), "mlstm_n": ((n, rows, 4, 384), torch.float32),
            **{k: ((n, rows, 48), torch.float32) for k in D.ssm.SLSTM_STATE}}
    else:
        keys = cell.seq_len // (16 if cell.global_batch >= data else 16 * data)
        assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} == {
            "k": ((n, rows, keys, 5, 64), torch.bfloat16), "v": ((n, rows, keys, 5, 64), torch.bfloat16),
            "ssm": ((n, rows, 200, 16), torch.float32), "conv": ((n, rows, 3, 200), torch.bfloat16)}
    with S.use_rules(rules):
        whole, specs = TS.cache_structs_and_specs(cfg, cell, choose_cache_policy(cfg, 16, cell.global_batch, data),
                                                  mesh)
    assert sum(t.numel() * t.element_size() for t in cache.values()) == TS._cache_spec_bytes(whole, specs, mesh)
