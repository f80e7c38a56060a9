"""MLA on the serving mesh in the port against the reference on the CPU:
deepseek-v2-236b's latent cache (``c_kv`` / ``k_rope`` over the main layers,
``prefix_c_kv`` / ``prefix_k_rope`` over the dense prefix; no head dim)
placed under the reference's cache specs (``launch/specs.py``
``cache_structs_and_specs``: ``("layers", "batch", "seq", "rank")``, the
rows over the data axes, the sequence over "model": ``choose_cache_policy``
gives ``CachePolicy(1, False, True, ("model",))``), attention head-parallel
on the weights as the serving specs store them (``wq_b`` and ``wkv_b`` by
heads, ``wo`` by rows, ``wq_a`` / ``wkv_a`` whole).  Prefill runs K3 on
each model device's heads (``layers.mla_tp_latent``) and each device writes
its key slice of the prompt's latent rows; decode is the absorbed form
head-parallel (``decode._mla_decode_tp``), each device scoring every head
against its own keys and merging its head block of the partials: no
parameter moves.

Meshes of logical CPU devices (``REPRO_TORCH_FORCE_DEVICE_COUNT``) of
shapes (1, 2), (2, 1), (2, 2), (1, 4) and (2, 4); the smoke configuration
(4 heads, 1 dense-FFN prefix layer + 2 MoE layers, latent rank 16) with
the reference's weights (``from_jax_params``) and tokens drawn with numpy
from a seed, ``B, N_PRE, STEPS`` of ``test_torch_serve_mesh.py`` into a
16-key cache: on 4 model devices each holds 4 keys, the last none at
prefill and its first at the fourth step.  Tolerances: logits against the
reference's single-device ``prefill`` / ``decode_step`` (JAX, f32) within
``test_torch_lm.py``'s ``RTOL`` (1e-4 of the largest |logit|); each
device's latent slices against the port's own single-device cache within
``test_torch_serve_mesh.py``'s ``CACHE_RTOL`` (1e-5 of the largest |entry|:
the tensor-parallel sums precede the writes); placement bitwise; a
decode step's collective bytes to the byte.
"""

import collections
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import configs  # noqa: E402
from repro_torch.configs.shapes import SHAPES, InputShape  # noqa: E402
from repro_torch.device import current_logical  # noqa: E402
from repro_torch.distributed import collectives as C  # noqa: E402
from repro_torch.distributed import sharding as S  # noqa: E402
from repro_torch.distributed import zero as Z  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import hlo_analysis as H  # noqa: E402
from repro_torch.launch import specs as TS  # noqa: E402
from repro_torch.launch.mesh import make_mesh, make_production_mesh  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.serving.kv_cache import CachePolicy, choose_cache_policy  # noqa: E402

from test_torch_lm import RTOL, _close  # noqa: E402
from test_torch_serve_mesh import B, CACHE_RTOL, N_PRE, STEPS, _max_len, _reference, _serve, _setup  # noqa: E402
from test_torch_tensor_parallel import _spec_slice  # noqa: E402
from test_torch_train_mesh import _mesh  # noqa: E402

ARCH = "deepseek-v2-236b"
MAX_LEN = 16
MESHES = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2), "1x4": (1, 4), "2x4": (2, 4)}
LATENT = {"c_kv", "k_rope", "prefix_c_kv", "prefix_k_rope"}


def _widened():
    """The smoke configuration at MLA's widths that K3 takes (q/k 192, v
    128): a trace runs the card's branch."""
    return dataclasses.replace(configs.get_smoke_config(ARCH), nope_head_dim=128, rope_head_dim=64, v_head_dim=128)


def _spied(monkeypatch) -> dict:
    """K3's and K4's calls by logical device."""
    seen = {"k3": collections.Counter(), "k4": collections.Counter()}

    def spy(key, fn):
        def wrapped(*args, **kw):
            seen[key][current_logical().label] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(L, "attention_scores_blockwise", spy("k3", L.attention_scores_blockwise))
    monkeypatch.setattr(da_ops, "decode_attention_cache", spy("k4", da_ops.decode_attention_cache))
    return seen


def _single_run(cfg, model, toks) -> dict:
    """The port's single-device cache after prefill and STEPS decode
    steps."""
    _, single, lens = D.prefill(model, cfg, torch.from_numpy(toks[:, :N_PRE]), max_len=MAX_LEN,
                                cache_dtype=torch.float32)
    for t in range(STEPS):
        _, single, lens = D.decode_step(model, cfg, torch.from_numpy(toks[:, N_PRE + t]), single, lens)
    return single


def test_the_cache_is_as_long_as_the_reference_run():
    """The reference's run (``test_torch_serve_mesh._reference``) fills a
    cache of MAX_LEN keys."""
    assert _max_len(configs.get_smoke_config(ARCH)) == MAX_LEN


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mla_logits_against_reference(mesh, monkeypatch):
    """Prefill's last-token logits and STEPS decode steps' within RTOL of
    the reference's single-device run, every row on the mesh's first
    device; the policy splits the latent cache's sequence over "model";
    K3 ran once a layer (the dense prefix's among them) on every model
    device in prefill, and no K4 ran."""
    shape = MESHES[mesh]
    _, cfg, _, model, toks, _ = _setup(ARCH)
    want = _reference(ARCH)
    m = _mesh(shape, monkeypatch)
    seen = _spied(monkeypatch)
    got, _, policy, _ = _serve(cfg, model, m, toks, None, max_len=MAX_LEN)
    for g, w in zip(got, want):
        assert g.shape == (B, cfg.padded_vocab_size)
        _close(g, w, RTOL, cfg.vocab_size)
    assert policy == CachePolicy(1, False, True, ("model",))
    assert seen["k3"] == dict.fromkeys([dev.label for dev in m.flat], cfg.num_layers), seen
    assert not seen["k4"]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mla_cache_slices_are_the_single_device_caches(mesh, monkeypatch):
    """After prefill and the decode steps every device holds its rows and
    its keys of each latent leaf, the prefix's and the main layers', of the
    port's single-device cache after the same calls, within CACHE_RTOL;
    ``gather_cache`` joins them back.  On 4 model devices the last one's 4
    keys start at 12: prefill (9 tokens) leaves them zero, the decode steps
    (positions 9..12) write its first."""
    shape = MESHES[mesh]
    _, cfg, _, model, toks, _ = _setup(ARCH)
    m = _mesh(shape, monkeypatch)
    if shape[1] == 4:
        with S.use_rules(S.SINGLE_POD_RULES):
            pspecs = S.param_pspecs(model)
            prefill = D.make_mesh_prefill(cfg, m, pspecs, choose_cache_policy(cfg, 4, B, shape[0]))
            placed = Z.place_params(model, m, pspecs)
        _, fresh, _ = prefill(placed, torch.from_numpy(toks[:, :N_PRE]), max_len=MAX_LEN, cache_dtype=torch.float32)
        for q, mine in enumerate(fresh):
            last = m.coords(q)["model"] == 3
            assert all(bool(mine[k].any()) != last for k in LATENT), q
    _, cache, policy, _ = _serve(cfg, model, m, toks, None, max_len=MAX_LEN)
    single = _single_run(cfg, model, toks)
    with S.use_rules(S.SINGLE_POD_RULES):
        specs = D.cache_pspecs(single, policy, m)
        back = D.gather_cache(cache, m, policy)
    assert all(specs[k] == S.P(None, "data", "model", None) for k in LATENT)
    for q, mine in enumerate(cache):
        assert set(mine) == set(single) == LATENT
        for key, whole in single.items():
            want = _spec_slice(whole.numpy(), specs[key], m, q)
            got = mine[key].numpy()
            assert got.shape == want.shape and got.shape[2] == MAX_LEN // shape[1], (key, q)
            assert np.abs(got - want).max() <= CACHE_RTOL * np.abs(whole.numpy()).max(), (key, q)
    for k in back:
        assert (back[k] - single[k]).abs().max() <= CACHE_RTOL * single[k].abs().max(), k


@pytest.mark.parametrize("mesh", ["2x2", "1x4", "2x4"])
def test_placed_latent_cache_is_the_reference_specs_slices(mesh, monkeypatch):
    """A seeded single-device latent cache placed with ``place_cache`` is,
    on each device, the numpy slice of the reference's cache specs (rows
    over "data", keys over "model"); ``gather_cache`` joins it back
    bitwise; ``init_mesh_cache`` makes the same shapes, zero."""
    shape = MESHES[mesh]
    cfg = configs.get_smoke_config(ARCH)
    m = _mesh(shape, monkeypatch)
    rng = np.random.default_rng(3)
    with S.use_rules(S.SINGLE_POD_RULES):
        policy = choose_cache_policy(cfg, shape[1], B, shape[0])
        cache = {k: torch.from_numpy(rng.normal(size=v.shape).astype(np.float32))
                 for k, v in D.init_cache(cfg, B, MAX_LEN, 1, torch.float32, "cpu").items()}
        placed = D.place_cache(cache, m, policy)
        specs = D.cache_pspecs(cache, policy, m)
        back = D.gather_cache(placed, m, policy)
        zeros = D.init_mesh_cache(cfg, m, policy, B, MAX_LEN, torch.float32)
    assert all(specs[k] == S.P(None, "data", "model", None) for k in LATENT)
    for q, mine in enumerate(placed):
        for key, whole in cache.items():
            assert np.array_equal(mine[key].numpy(), _spec_slice(whole.numpy(), specs[key], m, q)), (key, q)
            assert zeros[q][key].shape == mine[key].shape and not zeros[q][key].any()
    assert all(torch.equal(back[k], cache[k]) for k in cache)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_role_mesh_trace_equals_a_full_trace_of_an_mla_cell(kind, monkeypatch):
    """The smoke deepseek-v2-236b at MLA's kernel widths in a 64-token cell
    at batch 4 on (2, 4): a trace on the mesh's RoleMesh (3 indices an
    axis) counts what a trace of every device counts, per device: the
    collectives, the launches (K3 once a layer in prefill, the dense
    prefix's among them; none in decode), FLOPs, traffic and bytes."""
    cfg = _widened()
    cell = InputShape("c", kind, 64, 4)
    mesh = make_mesh((2, 4), ("data", "model"), H.trace_devices(8))
    short = dryrun.run_cell(cfg, cell, mesh)
    monkeypatch.setattr(TS, "RoleMesh", lambda m: m)
    full = dryrun.run_cell(cfg, cell, mesh)
    assert short["hlo"] == full["hlo"] and short["memory"] == full["memory"]
    assert short["hlo"]["launches"] == ({"flash_attention": cfg.num_layers} if kind == "prefill" else {})
    assert short["memory"]["argument_bytes"] == (short["memory"]["reference_layout_argument_bytes"]
                                                 + short["memory"]["dtype_surplus_bytes"])


@pytest.mark.parametrize("shape", [(2, 4), (2, 2)], ids=["2x4", "2x2"])
def test_mla_decode_moves_no_parameter(shape, monkeypatch):
    """A traced decode step's collectives inside MLA's attention
    (``decode._mla_decode_tp``, every layer of every data shard) are, to the
    byte and in order, those worked out from the shapes, and hold no
    parameter: the queries' input and the token's latent row copied to the
    group (b x (q_lora + R + rope) in the model dtype), q_c and q_rope
    gathered on every device (b x H x (R + rope), f32), each device's head
    block of every device's partial (TP slices of b x H/TP x (R + 1), f32)
    and the outputs' ring sum (b x D).  b: a data shard's rows; a RoleMesh
    device stands for the model axis' devices it leaves out."""
    cfg = _widened()
    mesh = make_mesh(shape, ("data", "model"), H.trace_devices(8))
    rows, tp = 8, shape[1]
    b, h, r, rd, d, dt = rows // shape[0], cfg.num_heads, cfg.kv_lora_rank, cfg.rope_head_dim, cfg.d_model, 4
    inside, seen = [False], []
    collective, decode_tp = C._collective, D._mla_decode_tp

    def recording(kind, tensors, devices):
        if inside[0] and _build.tracing():
            seen.append((kind, sum(t.numel() * t.element_size() for t in tensors), len(devices)))
        return collective(kind, tensors, devices)

    def attention(*args, **kw):
        inside[0] = True
        try:
            return decode_tp(*args, **kw)
        finally:
            inside[0] = False

    monkeypatch.setattr(C, "_collective", recording)
    monkeypatch.setattr(D, "_mla_decode_tp", attention)
    rec = dryrun.run_cell(cfg, InputShape("c", "decode", 64, rows), mesh)
    n = min(tp, 3)  # the group's devices on the RoleMesh
    one = ([("collective-permute", b * (cfg.q_lora_rank + r + rd) * dt, n),
            ("all-gather", b * h * (r + rd) * 4, n)]
           + [("all-gather", tp * b * (h // tp) * (r + 1) * 4, 1)] * n
           + [("all-reduce", b * d * dt, n)])
    assert seen == one * (cfg.num_layers * min(shape[0], 3)), seen
    per_device = cfg.num_layers * (b * h * (r + rd) * 4 + b * h * (r + 1) * 4)
    assert rec["hlo"]["collective_bytes"]["all-gather"] >= per_device
    params = {w.numel() * w.element_size() for w in TS.param_structs(cfg).parameters()}
    assert not params & {nbytes for _, nbytes, _ in seen}


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_two_layers_at_full_width_place_the_reference_layout(shape, multi_pod):
    """deepseek-v2-236b at full width reduced to 2 layers (the dense prefix
    and one MoE layer: no FSDP at 2 bytes over 16) on the 16x16 and
    2x16x16 meshes (their RoleMesh, meta tensors): served, not skipped;
    the busiest device's argument bytes equal the spec trees' (the weights
    at 2 bytes, the latent cache at the reference's bf16, the inputs over
    the data axes) plus 2 bytes for each element of the f32 norm scales
    and router; a decode_32k device holds its 8 rows (4 on 2x16x16) x 2048
    of the 32,768 keys of each latent leaf."""
    cfg = dataclasses.replace(configs.get_config(ARCH), num_layers=2)
    mesh = make_production_mesh(multi_pod=multi_pod, devices=H.trace_devices(512 if multi_pod else 256))
    rules = S.MULTI_POD_RULES if multi_pod else S.SINGLE_POD_RULES
    with S.use_rules(rules):
        spec = TS.build_cell(cfg, SHAPES[shape], mesh)
    assert spec.skip is None
    assert spec.argument_bytes == spec.reference_argument_bytes + spec.dtype_surplus_bytes
    if SHAPES[shape].kind != "decode":
        return
    cache, rows = spec.args[2][0], SHAPES[shape].global_batch // (32 if multi_pod else 16)
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} == {
        "c_kv": ((1, rows, 2048, 512), torch.bfloat16), "k_rope": ((1, rows, 2048, 64), torch.bfloat16),
        "prefix_c_kv": ((1, rows, 2048, 512), torch.bfloat16), "prefix_k_rope": ((1, rows, 2048, 64), torch.bfloat16)}


def test_production_decode_cell_names_fsdp():
    """deepseek-v2-236b's decode_32k at full size on 16x16: at 235.7 B
    parameters ``maybe_fsdp_pspecs`` picks FSDP at 2 bytes over TP 16, and
    the cell's skip reason names FSDP, not MLA (the gap checks FSDP
    first)."""
    cfg = configs.get_config(ARCH)
    mesh = make_production_mesh(devices=H.trace_devices(256))
    with S.use_rules(S.SINGLE_POD_RULES):
        params = TS.param_structs(cfg)
        _, fsdp = TS.maybe_fsdp_pspecs(cfg, params, S.param_pspecs(params), mesh, bytes_per_param=2)
        spec = TS.build_cell(cfg, SHAPES["decode_32k"], mesh)
    assert fsdp
    assert spec.skip.startswith(f"{cfg.name}: parameters under FSDP at 2 bytes") and "ROADMAP 26b" in spec.skip
