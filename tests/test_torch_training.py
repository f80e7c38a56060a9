"""The port's trainer against the reference on the CPU: the input pipeline,
AdamW and its schedule, K3's backward, the loss and one train step over
the smoke configs, gradient accumulation, ``moe_aux_loss``, checkpoints
resumed across the packages, and the training CLI.

Same inputs on both sides: numpy-seeded tokens, frames, patches and
weights (:func:`_numpy_params`: the reference's layout, norm scales and
Mamba's fixed leaves drawn too, so their gradients show), loaded into the
port with ``from_jax_params(..., train=True)`` (f32 leaves that require
grad).
Tolerances, each with its reason:

* the pipeline: bitwise (a copy of the same numpy code);
* ``cosine_schedule``, ``clip_by_global_norm`` and ``adamw_update`` on a
  random tree: 1e-6 relative to each leaf's largest value (f32 with
  another rounding order: ``_foreach_norm``, ``addcmul``);
* K3's plain backward and the autograd Function's CPU gradients against
  ``jax.vjp`` of the reference's ``attention_scores_blockwise``, and the
  forward's ``lse`` against ``logsumexp`` of the reference's scores:
  1e-5 relative to the largest |value| (f32 sums in another order);
* ``lm_loss``, one ``make_train_step`` (loss, grad norm) and the updated
  leaves: 1e-5 relative (:data:`STEP_RTOL`); the leaves' error is
  measured on the update itself, ``p_new - p``, against the reference's
  update's largest |value| (``p`` is the same on both sides), plus one f32
  rounding of the new leaf (a norm scale near 1 holds its update to
  2^-23).  The step
  starts from seeded ``m`` and ``v`` at count 3: at count 0 AdamW's first
  step is ``g / (|g| + eps)``, which turns the ~1e-6 (of a leaf's largest
  |grad|) that f32 grads differ by into a flipped sign wherever a grad is
  that small.  What each config reaches is in :data:`REACHED` (measured
  on this CPU, all f32);
* ``grad_accum=2`` against ``grad_accum=1``: 1e-4 loss, 1e-5 leaves, as
  ``tests/test_training.py`` holds the reference;
* resumed training against straight training: 1e-5 relative.
"""

import os
import signal
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.data import pipeline as ref_pipeline  # noqa: E402
from repro.distributed import checkpoint as ref_ckpt  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.training import optimizer as ref_opt  # noqa: E402
from repro.training import train_loop as ref_loop  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import plain as fa_plain  # noqa: E402
from repro_torch.kernels.selective_scan import ops as scan_ops  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import train_loop as loop  # noqa: E402

RTOL = 1e-5
OPT_RTOL = 1e-6
STEP_RTOL = 1e-5
LOG2E = float(np.log2(np.e))
F32_EPS = float(np.finfo(np.float32).eps)

# largest error measured per config (loss, grad norm: relative; leaves:
# |Δ update| beyond one f32 rounding of the leaf / max |reference update|)
# on a CPU, with the state and batch of test_train_step_against_reference;
# each is held to STEP_RTOL
REACHED = {
    "gemma3-1b": "loss 0e+00, grad norm 7e-07, update 3e-06",
    "qwen3-32b": "loss 7e-08, grad norm 1e-07, update 4e-06",
    "olmoe-1b-7b": "loss 8e-08, grad norm 3e-07, update 1e-06",
    "xlstm-125m": "loss 2e-07, grad norm 2e-07, update 4e-06",
    "hymba-1.5b": "loss 8e-08, grad norm 1e-07, update 2e-06",  # K6 through its written-out backward
    "deepseek-v2-236b": "loss 9e-08, grad norm 1e-07, update 2e-06",
    "whisper-large-v3": "loss 0e+00, grad norm 2e-07, update 2e-06",
    "internvl2-26b": "loss 9e-08, grad norm 0e+00, update 2e-06",
}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _paths(tree[key], prefix + (key,))
    else:
        yield prefix, tree


# ---------------------------------------------------------------- pipeline
def test_pipeline_batches_are_the_references():
    fn, ref_fn = pipeline.synthetic_lm_batch_fn(97, 8, 33), ref_pipeline.synthetic_lm_batch_fn(97, 8, 33)
    for args in ((0, 0, 0, 1), (3, 5, 1, 2), (7, 11, 3, 4)):
        got, want = fn(*args), ref_fn(*args)
        assert got.keys() == want.keys() and got["tokens"].dtype == want["tokens"].dtype
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
    src = pipeline.ShardedBatchSource(fn, seed=4, host_index=1, host_count=2)
    ref_src = ref_pipeline.ShardedBatchSource(ref_fn, seed=4, host_index=1, host_count=2)
    for step in (0, 9):
        np.testing.assert_array_equal(src.batch_at(step)["tokens"], ref_src.batch_at(step)["tokens"])
    it, ref_it = pipeline.PrefetchIterator(src, start_step=3), ref_pipeline.PrefetchIterator(ref_src, start_step=3)
    try:
        for _ in range(4):
            np.testing.assert_array_equal(next(it)["tokens"], next(ref_it)["tokens"])
        assert it.step == ref_it.step == 7
    finally:
        it.close()
        ref_it.close()


# --------------------------------------------------------------- optimizer
def _random_tree(rng):
    return {"w": rng.normal(size=(6, 5)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32),
            "blk": {"a": rng.normal(size=(2, 3, 4)).astype(np.float32),
                    "s": rng.normal(size=(4,)).astype(np.float32)}}


def _torch_tree(tree):
    return opt.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def test_cosine_schedule_is_the_references():
    for warmup, total, min_ratio in ((10, 100, 0.1), (1, 10, 0.1), (0, 50, 0.3)):
        fn, ref_fn = opt.cosine_schedule(warmup, total, min_ratio), ref_opt.cosine_schedule(warmup, total, min_ratio)
        got = np.array([float(fn(torch.tensor(s, dtype=torch.int32))) for s in range(121)])
        want = np.array([float(ref_fn(jnp.asarray(s, jnp.int32))) for s in range(121)])
        np.testing.assert_allclose(got, want, rtol=OPT_RTOL, atol=1e-7)
        assert got[0] == 0.0 or warmup == 0


def test_clip_by_global_norm_is_the_references():
    rng = np.random.default_rng(1)
    tree = _random_tree(rng)
    for max_norm in (0.5, 100.0):
        got, gnorm = opt.clip_by_global_norm(_torch_tree(tree), max_norm)
        want, ref_norm = ref_opt.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), max_norm)
        assert _rel(_np(gnorm), ref_norm) <= OPT_RTOL
        for (_, g), (_, w) in zip(_paths(got), _paths(want)):
            assert _rel(_np(g), w) <= OPT_RTOL


def test_adamw_update_is_the_references():
    rng = np.random.default_rng(2)
    params, cfg = _random_tree(rng), ref_opt.AdamWConfig(lr=1e-2, grad_clip=3.0)
    p_t, p_j = _torch_tree(params), jax.tree.map(jnp.asarray, params)
    st_t, st_j = opt.adamw_init(p_t), ref_opt.adamw_init(p_j)
    port_cfg = opt.AdamWConfig(lr=1e-2, grad_clip=3.0)
    for step in range(4):
        grads = _random_tree(rng)
        scale = 0.5 + 0.1 * step
        p_t, st_t, gn_t = opt.adamw_update(_torch_tree(grads), st_t, p_t, port_cfg, torch.tensor(scale))
        p_j, st_j, gn_j = ref_opt.adamw_update(jax.tree.map(jnp.asarray, grads), st_j, p_j, cfg,
                                               jnp.asarray(scale, jnp.float32))
        assert _rel(_np(gn_t), gn_j) <= OPT_RTOL
        assert int(st_t["count"]) == int(st_j["count"]) == step + 1
        for tree_t, tree_j in ((p_t, p_j), (st_t["m"], st_j["m"]), (st_t["v"], st_j["v"])):
            for (path, a), (_, b) in zip(_paths(tree_t), _paths(tree_j)):
                assert _rel(_np(a), b) <= OPT_RTOL, (step, path)


# ---------------------------------------------------------- K3's backward
ATTN_CASES = [  # b, s, h, kvh, d, dv (None: d), causal, window, block (the reference's KV block)
    (2, 24, 2, 2, 16, None, True, None, 1024),  # causal, dense branch
    (1, 37, 4, 1, 16, None, True, None, 16),  # GQA, S not a multiple of the block
    (2, 40, 4, 2, 8, None, True, 7, 16),  # window, GQA
    (1, 33, 2, 1, 16, None, False, None, 1024),  # non-causal (the encoder)
    (1, 29, 6, 2, 16, None, True, 5, 8),  # window, group 3, ragged blocks
    (1, 30, 4, 4, 24, 16, True, None, 16),  # v narrower than q/k (MLA's 192/128 in small), ragged blocks
]


def _attn_case_id(case) -> str:
    """pytest's id of the case's values, dv left out where it is d."""
    return "-".join(str(x) for i, x in enumerate(case) if i != 5 or x is not None)


def _attn_inputs(b, s, h, kvh, d, seed, dv=None):
    """q, k (d wide), v and dO (dv wide, d if None), seeded."""
    dv = d if dv is None else dv
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for shape in
            ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, dv), (b, s, h, dv))]


def _ref_attention_vjp(q, k, v, do, causal, window, block):
    fn = lambda q_, k_, v_: RL.attention_scores_blockwise(q_, k_, v_, causal=causal, window=window,  # noqa: E731
                                                          block=block)
    out, grads = jax.jit(lambda *a: (lambda o, vjp: (o, vjp(a[3])))(*jax.vjp(fn, *a[:3])))(
        *(jnp.asarray(x) for x in (q, k, v, do)))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _ref_lse(q, k, causal, window):
    """log2 Σ_k exp(scale q·k) over the unmasked keys, (B, H, S)."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    kk = np.repeat(k, h // kvh, axis=2)
    sc = np.einsum("bqhd,bmhd->bhqm", q.astype(np.float64), kk.astype(np.float64)) * d**-0.5
    qpos, kpos = np.arange(s)[:, None], np.arange(s)[None, :]
    mask = np.ones((s, s), bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    sc = np.where(mask, sc, -np.inf)
    mx = sc.max(-1, keepdims=True)
    return (mx[..., 0] + np.log(np.exp(sc - mx).sum(-1))) * LOG2E


@pytest.mark.parametrize("b,s,h,kvh,d,dv,causal,window,block", ATTN_CASES,
                         ids=[_attn_case_id(c) for c in ATTN_CASES])
def test_flash_attention_backward_against_reference_vjp(b, s, h, kvh, d, dv, causal, window, block):
    q, k, v, do = _attn_inputs(b, s, h, kvh, d, seed=s, dv=dv)
    want_out, (dq_w, dk_w, dv_w) = _ref_attention_vjp(q, k, v, do, causal, window, block)
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = fa_plain.flash_attention_bshd(qt, kt, vt, causal=causal, window=window, return_lse=True)
    assert _rel(out, want_out) <= RTOL
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    assert _rel(lse, _ref_lse(q, k, causal, window)) <= RTOL
    # the plain backward, written out
    dq, dk, dv = fa_plain.flash_attention_bwd_bshd(qt, kt, vt, out, lse, dot, causal=causal, window=window)
    for got, want in ((dq, dq_w), (dk, dk_w), (dv, dv_w)):
        assert got.shape == want.shape and _rel(got, want) <= RTOL
    # the wrapper's autograd Function: the same saved tensors and gradients
    leaves = [t.clone().requires_grad_(True) for t in (qt, kt, vt)]
    out = fa_ops.flash_attention_bshd(*leaves, causal=causal, window=window)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "FlashAttentionBackward"
    grads = torch.autograd.grad(out, leaves, dot)
    for got, want in zip(grads, (dq_w, dk_w, dv_w)):
        assert got.dtype == torch.float32 and _rel(got, want) <= RTOL
    # serving: no input requires grad, no lse and no graph
    with torch.no_grad():
        assert fa_ops.flash_attention_bshd(*leaves, causal=causal, window=window).grad_fn is None


def test_flash_attention_backward_blockwise_lse_and_bf16():
    """The plain version's blockwise branch (Sk > 1024) returns the same
    lse as the dense one; bf16 inputs get bf16 gradients."""
    q, k, v, do = _attn_inputs(1, 1030, 2, 1, 8, seed=5)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    _, lse_blk = fa_plain.flash_attention_bshd(qt, kt, vt, window=100, return_lse=True)
    _, lse_dense = fa_plain.flash_attention_bshd(qt, kt, vt, window=100, block=2048, return_lse=True)
    assert _rel(lse_blk, lse_dense) <= RTOL
    leaves = [t[:, :64].to(torch.bfloat16).requires_grad_(True) for t in (qt, kt, vt)]
    out = fa_ops.flash_attention_bshd(*leaves, window=16)
    grads = torch.autograd.grad(out.float().sum(), leaves)
    assert all(g.dtype == torch.bfloat16 and bool(torch.isfinite(g.float()).all()) for g in grads)


# ------------------------------------------------------------------ no silent detachment
def test_kernels_without_backward_raise_under_grad():
    """K4 has no backward: on a non-CPU tensor that requires grad (meta
    tensors here: no card needed) its wrapper raises before its device
    branch.  K6 has one now: under grad a meta tensor goes through its
    autograd Function to the device branch, which raises for a device
    other than cuda or cpu, as it does under no_grad."""
    meta = dict(device="meta")
    q = torch.empty(2, 4, 64, **meta, requires_grad=True)
    cache = torch.empty(2, 8, 1, 64, **meta)
    lens = torch.empty(2, dtype=torch.int32, **meta)
    with pytest.raises(NotImplementedError, match="decode_attention"):
        da_ops.decode_attention_cache(q, cache, cache, lens)
    xc = torch.empty(1, 5, 16, **meta, requires_grad=True)
    args = (torch.empty(1, 5, 17, **meta), torch.empty(16, 8, **meta), torch.empty(16, **meta),
            torch.empty(16, **meta))
    with pytest.raises(ValueError, match="cuda or cpu"):
        scan_ops.selective_scan(xc, *args)
    with torch.no_grad(), pytest.raises(ValueError, match="cuda or cpu"):
        scan_ops.selective_scan(xc, *args)
    # on the CPU the plain versions keep their gradient
    x = torch.randn(1, 5, 16, requires_grad=True)
    y, _ = scan_ops.selective_scan(x, torch.randn(1, 5, 17), torch.zeros(16, 8), torch.zeros(16), torch.ones(16))
    assert y.grad_fn is not None


def _spy(mod, name: str, log: list):
    """Patch ``mod.name`` with a wrapper that records (name, kwargs)."""
    from unittest import mock

    real = getattr(mod, name)

    def wrapper(*args, **kwargs):
        log.append((name, kwargs))
        return real(*args, **kwargs)

    return mock.patch.object(mod, name, wrapper)


@pytest.mark.parametrize("arch", list(REACHED))
def test_training_on_the_card_raises_where_a_kernel_has_no_backward(arch):
    """No configuration meets a kernel without a backward in training: the
    smoke config's loss and gradients (CPU: the plain versions, through
    the same autograd Functions the card runs) reach K3 and K6 only
    through their Functions — every forward keeps what its backward needs
    (K3's lse, K6's h_chunks), and under per-layer remat each forward runs
    twice per backward — and never K4, the one kernel with no backward.
    hymba-1.5b runs K6's backward once per layer."""
    from contextlib import ExitStack

    cfg = configs.get_smoke_config(arch)
    model = T.from_jax_params(_numpy_params(cfg), cfg, train=True)
    batch = _batch(cfg)
    tok = torch.from_numpy(batch["tokens"]).long()
    fwd = {k: torch.from_numpy(batch[k]) for k in ("vision_embeds", "encoder_frames") if k in batch}
    log = []
    with ExitStack() as stack:
        for mod, name in ((fa_ops, "_forward"), (fa_ops, "flash_attention_bwd_bshd"), (scan_ops, "_forward"),
                          (scan_ops, "selective_scan_bwd"), (da_ops, "decode_attention_cache")):
            stack.enter_context(_spy(mod, name, log))
        loss = loop.lm_loss(model, cfg, tok[:, :-1], tok[:, 1:], torch.from_numpy(batch["loss_mask"]), **fwd)
        torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
    k3 = [kw["with_lse"] for name, kw in log if name == "_forward" and "with_lse" in kw]
    k6 = [kw["with_chunks"] for name, kw in log if name == "_forward" and "with_chunks" in kw]
    k3_bwd = sum(name == "flash_attention_bwd_bshd" for name, _ in log)
    k6_bwd = sum(name == "selective_scan_bwd" for name, _ in log)
    assert not any(name == "decode_attention_cache" for name, _ in log)
    assert all(k3) and all(k6)
    assert len(k3) == 2 * k3_bwd and (k3_bwd > 0) == (cfg.family != "ssm")
    hybrid_layers = cfg.num_layers if cfg.family == "hybrid" else 0
    assert len(k6) == 2 * k6_bwd and k6_bwd == hybrid_layers


def test_training_mla_on_the_card_passes_the_check():
    """K3's backward takes MLA's (192, 128) instance: DeepSeek-V2's (q/k,
    v) widths are one of the backward's instances (and its smoke config,
    also q/k wider than v, trains through the same Function on the CPU:
    the test above)."""
    for cfg in (configs.get_config("deepseek-v2-236b"), configs.get_smoke_config("deepseek-v2-236b")):
        assert cfg.attn_type == "mla" and cfg.nope_head_dim + cfg.rope_head_dim != cfg.v_head_dim
    full = configs.get_config("deepseek-v2-236b")
    assert (full.nope_head_dim + full.rope_head_dim, full.v_head_dim) in fa_ops.HEAD_DIMS


# ------------------------------------------------------------ loss and step
STEP_ARCHS = list(REACHED)
STEP_AT = 5  # a step with lr > 0 (the schedule gives 0 at step 0)


def _batch(cfg, seed=0, b=2, s=12):
    batch = ref_pipeline.synthetic_lm_batch_fn(cfg.vocab_size, b, s)(seed, 0, 0, 1)
    rng = np.random.default_rng(seed + 100)
    if cfg.is_encdec:
        batch["encoder_frames"] = rng.normal(size=(b, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vit_stub":
        batch["vision_embeds"] = rng.normal(size=(b, cfg.num_vision_tokens, cfg.d_model)).astype(np.float32)
    batch["loss_mask"] = (rng.random((b, s)) < 0.8).astype(np.float32)
    return batch


def _numpy_params(cfg, seed=0) -> dict:
    """Seeded weights in the reference's layout (``init_lm``'s tree): each
    matrix N(0, 1) / sqrt(fan-in), the embedding N(0, 1) / sqrt(d_model),
    norm scales 1 + N(0, 0.1), biases and Mamba's dt_bias N(0, 0.1),
    a_log log(1..N) + N(0, 0.1), d_skip 1 + N(0, 0.1), conv_w N(0, 0.2)."""
    rng = np.random.default_rng(seed)
    model = T.TransformerLM(cfg, "cpu", torch.float32)
    with torch.no_grad():
        for name, w in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            noise = torch.from_numpy(rng.normal(size=tuple(w.shape)).astype(np.float32))
            if name == "embed":
                w.copy_(noise * cfg.d_model**-0.5)
            elif leaf in ("scale", "d_skip"):
                w.copy_(1 + 0.1 * noise)
            elif leaf in ("bias", "dt_bias"):
                w.copy_(0.1 * noise)
            elif leaf == "a_log":
                w.copy_(w + 0.1 * noise)  # log(1..N) as built
            elif leaf == "conv_w":
                w.copy_(0.2 * noise)
            else:
                w.copy_(noise * w.shape[-2] ** -0.5)
    return jax.tree.map(lambda t: t.numpy(), T.to_jax_layout(model))


def _states(arch, seed=0):
    """The reference's and the port's state on the same weights, with the
    same seeded AdamW moments at count 3 and step STEP_AT."""
    ref_cfg, cfg = ref_configs.get_smoke_config(arch), configs.get_smoke_config(arch)
    params = _numpy_params(cfg, seed)
    rng = np.random.default_rng(seed + 1)
    m = jax.tree.map(lambda p: (1e-2 * rng.normal(size=p.shape)).astype(np.float32), params)
    v = jax.tree.map(lambda p: (1e-4 * rng.random(size=p.shape)).astype(np.float32), params)
    ref_state = {"params": jax.tree.map(jnp.asarray, params),
                 "opt": {"m": jax.tree.map(jnp.asarray, m), "v": jax.tree.map(jnp.asarray, v),
                         "count": jnp.asarray(3, jnp.int32)},
                 "step": jnp.asarray(STEP_AT, jnp.int32)}
    model = T.from_jax_params(params, cfg, train=True)
    state = {"params": model, "opt": opt.adamw_init(dict(model.named_parameters())),
             "step": torch.tensor(STEP_AT, dtype=torch.int32)}
    T.load_jax_layout(state["opt"]["m"].items(), m)
    T.load_jax_layout(state["opt"]["v"].items(), v)
    state["opt"]["count"].fill_(3)
    return ref_cfg, cfg, ref_state, state, params


@pytest.mark.parametrize("arch", ["gemma3-1b", "internvl2-26b"])
def test_lm_loss_against_reference(arch):
    """The mean over every token (the step tests take a loss_mask), and
    the VLM's crop of its vision tokens' logits."""
    ref_cfg, cfg, ref_state, state, _ = _states(arch)
    batch = _batch(cfg)
    tok, fwd = batch["tokens"], {k: batch[k] for k in ("vision_embeds",) if k in batch}
    want = jax.jit(lambda p, f: ref_loop.lm_loss(p, ref_cfg, tok[:, :-1], tok[:, 1:], **f))(
        ref_state["params"], {k: jnp.asarray(v) for k, v in fwd.items()})
    with torch.no_grad():
        got = loop.lm_loss(state["params"], cfg, torch.from_numpy(tok[:, :-1]).long(),
                           torch.from_numpy(tok[:, 1:]).long(), **{k: torch.from_numpy(v) for k, v in fwd.items()})
    assert _rel(_np(got), want) <= STEP_RTOL


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_step_against_reference(arch):
    """One make_train_step (lm_loss with a loss_mask, the grads, the clip
    and AdamW) on the same state and batch."""
    ref_cfg, cfg, ref_state, state, params = _states(arch)
    batch = _batch(cfg)
    tcfg = ref_loop.TrainConfig(optimizer=ref_opt.AdamWConfig(lr=1e-3), warmup_steps=2, total_steps=20)
    port_tcfg = loop.TrainConfig(optimizer=opt.AdamWConfig(lr=1e-3), warmup_steps=2, total_steps=20)
    ref_new, ref_m = jax.jit(ref_loop.make_train_step(ref_cfg, tcfg))(
        ref_state, {k: jnp.asarray(v) for k, v in batch.items()})
    new, m = loop.make_train_step(cfg, port_tcfg)(state, batch)
    assert _rel(_np(m["loss"]), ref_m["loss"]) <= STEP_RTOL
    assert _rel(_np(m["grad_norm"]), ref_m["grad_norm"]) <= STEP_RTOL
    assert int(new["step"]) == int(ref_new["step"]) == STEP_AT + 1
    got_tree = T.to_jax_layout(new["params"])
    for (path, p_new), (_, p_ref), (_, p0) in zip(_paths(got_tree), _paths(ref_new["params"]), _paths(params)):
        upd_ref = np.asarray(p_ref, np.float64) - p0
        upd = _np(p_new).astype(np.float64) - p0
        # STEP_RTOL of the largest update, plus one f32 rounding of the new leaf
        bound = STEP_RTOL * np.abs(upd_ref).max() + F32_EPS * np.abs(np.asarray(p_ref, np.float64))
        assert (np.abs(upd - upd_ref) <= bound).all(), (path, np.abs(upd - upd_ref).max() / np.abs(upd_ref).max())


def test_grad_accum_matches_full_batch():
    """accum=2 over half-batches == accum=1 over the full batch (the
    reference's own test, on the port)."""
    cfg = configs.get_smoke_config("gemma3-1b")
    batch = pipeline.synthetic_lm_batch_fn(cfg.vocab_size, 4, 12)(3, 0, 0, 1)
    new = []
    for accum, b in ((1, batch), (2, {"tokens": batch["tokens"].reshape(2, 2, -1)})):
        state = loop.init_train_state(cfg, 0, "cpu")
        state["step"].fill_(STEP_AT)
        new.append(loop.make_train_step(cfg, loop.TrainConfig(grad_accum=accum))(state, b))
    (s1, m1), (s2, m2) = new
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-4
    d = max(float((a - b).detach().abs().max()) for a, b in zip(s1["params"].parameters(), s2["params"].parameters()))
    assert d < 1e-5


def test_moe_aux_loss_is_the_references():
    ref_cfg, cfg = ref_configs.get_smoke_config("olmoe-1b-7b"), configs.get_smoke_config("olmoe-1b-7b")
    params = _numpy_params(cfg, seed=1)
    model = T.from_jax_params(params, cfg)
    x = np.random.default_rng(4).normal(size=(2, 9, cfg.d_model)).astype(np.float32)
    for i in (0, 1):
        want = RL.moe_aux_loss(jax.tree.map(lambda a, i=i: a[i], params["layers"]["moe"]), ref_cfg, jnp.asarray(x))
        got = L.moe_aux_loss(model.layers[i].moe, cfg, torch.from_numpy(x))
        assert got.dtype == torch.float32 and _rel(_np(got), want) <= RTOL


# ------------------------------------------------------- cross-package resume
RESUME_ARCH = "gemma3-1b"


def _data(cfg, start=0):
    return ref_pipeline.PrefetchIterator(
        ref_pipeline.ShardedBatchSource(ref_pipeline.synthetic_lm_batch_fn(cfg.vocab_size, 4, 12), seed=3),
        start_step=start)


def _ref_state(params):
    p = jax.tree.map(jnp.asarray, params)
    return {"params": p, "opt": ref_opt.adamw_init(p), "step": jnp.zeros((), jnp.int32)}


def _run(train_fn, tcfg, cfg, steps, start=0, **kw):
    it = _data(cfg, start)
    try:
        return train_fn(cfg, tcfg, it, num_steps=steps, log_every=1000, **kw)
    finally:
        it.close()


def _ref_tcfg(d):
    return ref_loop.TrainConfig(optimizer=ref_opt.AdamWConfig(lr=1e-3), warmup_steps=1, total_steps=10,
                                checkpoint_dir=d, checkpoint_every=2)


def _port_tcfg(d):
    return loop.TrainConfig(optimizer=opt.AdamWConfig(lr=1e-3), warmup_steps=1, total_steps=10,
                            checkpoint_dir=d, checkpoint_every=2)


@pytest.fixture(scope="module")
def straight_run():
    """The reference's 4 straight steps from the seeded weights."""
    ref_cfg = ref_configs.get_smoke_config(RESUME_ARCH)
    params = _numpy_params(configs.get_smoke_config(RESUME_ARCH), seed=7)
    with tempfile.TemporaryDirectory() as d:
        state, _ = _run(ref_loop.train, _ref_tcfg(d), ref_cfg, 4, state=_ref_state(params))
    return params, state


@pytest.mark.parametrize("first", ["reference", "port"])
def test_resume_across_packages(first, straight_run):
    """One package trains 2 steps and checkpoints (the reference's format);
    the other restores it and trains 2 more; the result is the reference's
    4 straight steps."""
    params, straight = straight_run
    ref_cfg, cfg = ref_configs.get_smoke_config(RESUME_ARCH), configs.get_smoke_config(RESUME_ARCH)
    with tempfile.TemporaryDirectory() as d:
        if first == "reference":
            _run(ref_loop.train, _ref_tcfg(d), ref_cfg, 2, state=_ref_state(params))
            # the port's train finds the checkpoint and restores it over its own init
            state, hist = _run(loop.train, _port_tcfg(d), cfg, 2, start=2, key=3, device="cpu")
            assert [h["step"] for h in hist] == [2, 3]
            got = loop.state_tree(state)
        else:
            state = {"params": T.from_jax_params(params, cfg, train=True),
                     "step": torch.tensor(0, dtype=torch.int32)}
            state["opt"] = opt.adamw_init(dict(state["params"].named_parameters()))
            _run(loop.train, _port_tcfg(d), cfg, 2, state=state)
            assert sorted(os.listdir(d)) == ["step_000000002"]
            # what the reference's train does on finding a checkpoint, on a state given
            # (its init_lm would only be overwritten)
            restored, at = ref_ckpt.restore(d, None, _ref_state(params))
            assert at == 2
            got, _ = _run(ref_loop.train, _ref_tcfg(d), ref_cfg, 2, start=2, state=restored)
    assert int(_np(got["step"])) == 4 and int(_np(got["opt"]["count"])) == 4
    for tree in ("params", "m", "v"):
        a_tree = got[tree] if tree == "params" else got["opt"][tree]
        b_tree = straight[tree] if tree == "params" else straight["opt"][tree]
        for (path, a), (_, b) in zip(_paths(a_tree), _paths(b_tree)):
            assert _rel(_np(a), b) <= RTOL, (tree, path)


def test_train_cli_runs_on_the_cpu(capsys):
    handler = signal.getsignal(signal.SIGTERM)  # the CLI installs its preemption handler
    try:
        state, history = train_cli.main(["--arch", "gemma3-1b", "--smoke", "--steps", "3", "--batch", "2",
                                         "--seq", "16", "--device", "cpu"])
    finally:
        signal.signal(signal.SIGTERM, handler)
    assert [h["step"] for h in history] == [0, 1, 2] and int(state["step"]) == 3
    assert all(np.isfinite(h["loss"]) for h in history)
    assert "final loss" in capsys.readouterr().out
