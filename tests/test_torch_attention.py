"""Port attention kernels K3 (flash attention) and K4 (flash-decoding)
against the reference Pallas kernels (interpret mode), their jnp oracles,
and the jnp functions the reference model calls, on the CPU.

On a CPU tensor each wrapper runs its plain PyTorch version; the CUDA
kernels are held against those plain versions on the card by
``chip_smoke.py``.  Same seeded numpy inputs on both sides.  Tolerances:
f32 2e-5 and bf16 3e-2 absolute, the reference's own kernel-sweep bounds
(``tests/test_kernels.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention.decode_attention import decode_attention_packed  # noqa: E402
from repro.kernels.decode_attention.ops import decode_attention as ref_decode  # noqa: E402
from repro.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro.kernels.flash_attention.ops import flash_attention as ref_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da  # noqa: E402
from repro_torch.kernels.decode_attention import plain as da_plain  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attention import plain as fa_plain  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

F32_ATOL, BF16_ATOL = 2e-5, 3e-2
RNG = np.random.default_rng(0)


def _normal(*shape):
    return RNG.normal(size=shape).astype(np.float32)


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _flash_bhsd(q, k, v, **kw):
    """K3 on the reference's (B, H, S, D) layout: the same call on views."""
    out = fa.flash_attention_bshd(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), **kw)
    return out.transpose(1, 2)


# ----------------------------------------------------------- K3: the sweep
@pytest.mark.parametrize(
    "b,h,kvh,s,d,causal,window",
    [
        (1, 2, 2, 64, 32, True, None),
        (1, 4, 2, 64, 32, True, None),  # GQA
        (2, 4, 1, 96, 32, True, None),  # MQA
        (1, 2, 2, 80, 32, True, None),  # ragged padding
        (1, 2, 2, 64, 32, False, None),  # encoder
        (1, 2, 2, 128, 32, True, 64),  # sliding window
        (1, 2, 1, 1100, 16, True, 300),  # the plain version's blockwise branch
    ],
)
def test_flash_attention_sweep(b, h, kvh, s, d, causal, window):
    q, k, v = _normal(b, h, s, d), _normal(b, kvh, s, d), _normal(b, kvh, s, d)
    out = _flash_bhsd(*_t(q, k, v), causal=causal, window=window)
    assert out.shape == (b, h, s, d) and out.dtype == torch.float32
    ref = np.asarray(attention_ref(*map(jnp.asarray, (q, k, v)), causal=causal, window=window))
    np.testing.assert_allclose(out.numpy(), ref, atol=F32_ATOL)
    if s <= 128:  # interpret mode is slow at long S
        pallas = np.asarray(ref_flash(*map(jnp.asarray, (q, k, v)), causal=causal, window=window,
                                      bq=32, bk=32))
        np.testing.assert_allclose(out.numpy(), pallas, atol=F32_ATOL)


def test_flash_attention_bf16():
    q, k, v = _normal(1, 2, 64, 32), _normal(1, 2, 64, 32), _normal(1, 2, 64, 32)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    out = _flash_bhsd(*_t(q, k, v, dtype=torch.bfloat16))
    assert out.dtype == torch.bfloat16
    ref = np.asarray(attention_ref(jq, jk, jv), np.float32)
    np.testing.assert_allclose(out.float().numpy(), ref, atol=BF16_ATOL)
    pallas = np.asarray(ref_flash(jq, jk, jv, bq=32, bk=32), np.float32)
    np.testing.assert_allclose(out.float().numpy(), pallas, atol=BF16_ATOL)


# ------------------------------------- K3: the bf16 kernel's arithmetic
def _k3_bf16_emulation(q, k, v, causal, window, bk=64, split_p=True):
    """The tensor-core kernel's arithmetic, written in torch: f32 scores of
    bf16 inputs pre-scaled by scale * log2 e, an online softmax with exp2
    over 64-key tiles (masked scores -1e30), P split into bf16 hi + bf16
    lo with both products added, l summed from the unrounded f32 P, the
    output divided by l and rounded once to bf16.  ``split_p=False`` rounds
    P once to bf16 instead (no lo product)."""
    b, s, h, d = q.shape
    group = h // k.shape[2]
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    scale_log2 = d**-0.5 * 1.4426950408889634
    m = torch.full((b, h, s), -1e30)
    l = torch.zeros((b, h, s))
    o = torch.zeros((b, h, s, d))
    qpos = torch.arange(s)[:, None]
    for k0 in range(0, s, bk):
        kpos = torch.arange(k0, min(k0 + bk, s))[None, :]
        x = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf[:, k0:k0 + bk]) * scale_log2
        ok = torch.ones((s, kpos.shape[1]), dtype=torch.bool)
        if causal:
            ok &= kpos <= qpos
        if window is not None:
            ok &= kpos > qpos - window
        x = x.masked_fill(~ok, -1e30)
        m_new = torch.maximum(m, x.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new[..., None])
        hi = p.bfloat16().float()
        lo = (p - hi).bfloat16().float() if split_p else torch.zeros_like(p)
        vt = vf[:, k0:k0 + bk]
        pv = torch.einsum("bhqk,bkhd->bhqd", hi, vt) + torch.einsum("bhqk,bkhd->bhqd", lo, vt)
        l = corr * l + p.sum(-1)
        o = corr[..., None] * o + pv
        m = m_new
    l = torch.where(l == 0, torch.ones_like(l), l)
    return (o / l[..., None]).permute(0, 2, 1, 3).bfloat16()


@pytest.mark.parametrize("causal,window", [(True, None), (True, 64), (True, 100), (False, None)])
def test_k3_bf16_arithmetic_within_the_card_bound(causal, window):
    # the card check's bound on the bf16 kernel, elementwise: one bf16
    # rounding step, 2^-7 |plain| + 1e-4 (chip_smoke.py ATTN_BF16_*)
    b, s, h, kvh, d = 1, 256, 4, 1, 64
    q, k, v = _t(_normal(b, s, h, d), _normal(b, s, kvh, d), _normal(b, s, kvh, d), dtype=torch.bfloat16)
    got = _k3_bf16_emulation(q, k, v, causal, window)
    want = fa_plain.flash_attention_bshd(q, k, v, causal=causal, window=window)
    bound = 2**-7 * want.float().abs() + 1e-4
    assert ((got.float() - want.float()).abs() <= bound).all()
    # and the reference's f32 attention on the same bf16 inputs
    jq, jk, jv = (jnp.asarray(x.float().transpose(1, 2).numpy()) for x in (q, k, v))
    ref = np.asarray(attention_ref(jq, jk, jv, causal=causal, window=window)).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got.float().numpy(), ref, atol=BF16_ATOL)
    # P rounded once to bf16 before P.V breaks the same bound
    once = _k3_bf16_emulation(q, k, v, causal, window, split_p=False)
    assert ((once.float() - want.float()).abs() > bound).any()


# ----------------------------------------------------------- K4: the sweep
@pytest.mark.parametrize(
    "b,h,kvh,s,d,window",
    [
        (2, 8, 1, 256, 64, None),
        (2, 8, 2, 256, 64, None),
        (1, 4, 4, 100, 32, None),
        (2, 8, 2, 512, 64, 128),
    ],
)
def test_decode_attention_sweep(b, h, kvh, s, d, window):
    q, k, v = _normal(b, h, d), _normal(b, kvh, s, d), _normal(b, kvh, s, d)
    lengths = RNG.integers(max(1, s // 2), s + 1, size=(b,)).astype(np.int32)
    kc, vc = (x.transpose(1, 2) for x in _t(k, v))  # the reference's (B, KVH, S, D) as views
    out = da.decode_attention_cache(torch.from_numpy(q), kc, vc, torch.from_numpy(lengths), window=window)
    args = [jnp.asarray(x) for x in (q, k, v, lengths)]
    ref = np.asarray(decode_attention_ref(*args, window=window))
    np.testing.assert_allclose(out.numpy(), ref, atol=F32_ATOL)
    pallas = np.asarray(ref_decode(*args, window=window, bk=64))
    np.testing.assert_allclose(out.numpy(), pallas, atol=F32_ATOL)


# ------------------------------------------ K4: the kernel's split plan
H100_SMS = 132


def _chunk_keys(length, s, window, chunk, split):
    """Keys [c0, c1) of one block, as csrc/decode_attention.cu takes them:
    chunks start at max(0, length - window) and stop at min(length, S)."""
    length = max(length, 0)
    lo = max(0, length - window) if window is not None else 0
    c0 = lo + split * chunk
    return c0, max(c0, min(c0 + chunk, length, s))


@pytest.mark.parametrize(
    "bkvh,s,window,d,cache_bytes",
    [
        (4, 2112, None, 256, 2),  # Gemma3-1B decode, global layer
        (4, 2112, 512, 256, 2),  # Gemma3-1B decode, local layer
        (8, 256, None, 256, 4),  # serve, f32 cache
        (8, 256, 512, 256, 4),  # window >= S
        (5, 300, 64, 128, 4),
        (3, 1000, 100, 64, 2),
        (1, 1, None, 64, 4),
        (2, 100_000, None, 128, 2),  # the stage caps the chunk
    ],
)
def test_k4_split_plan_covers_every_valid_key_once(bkvh, s, window, d, cache_bytes):
    chunk, n_split = da.split_plan(bkvh, s, window, d, cache_bytes, H100_SMS)
    assert 2 * chunk * d * cache_bytes <= da.STAGE_BYTES
    span = s if window is None else min(s, window)
    assert bkvh * n_split >= H100_SMS or chunk in (min(da.MIN_CHUNK, span),
                                                   da.STAGE_BYTES // (2 * d * cache_bytes))
    w = 0 if window is None else window
    for length in sorted({0, 1, s // 2, s - 1, s, s + 5, s + w - 1, s + w, s + w + 7, 3 * s}):
        lo = max(0, length - window) if window is not None else 0
        want = list(range(lo, min(length, s)))
        got = []
        for split in range(n_split):
            c0, c1 = _chunk_keys(length, s, window, chunk, split)
            assert c1 == c0 or c1 <= s  # an empty chunk reads nothing
            got += range(c0, c1)
        assert got == want, (length, chunk, n_split)


def test_k4_split_plan_fills_the_card_at_the_gemma_decode_shape():
    # B 4 x KVH 1, 2112-key bf16 cache, D 256: global and local layers
    for window in (None, 512):
        chunk, n_split = da.split_plan(4, 2112, window, 256, 2, H100_SMS)
        assert 4 * n_split >= H100_SMS
    assert da.split_plan(4, 2112, None, 256, 2, H100_SMS) == (64, 33)
    chunk, n_split = da.split_plan(4, 2112, 512, 256, 2, H100_SMS)
    assert n_split == -(-512 // chunk)  # the window's keys, not the cache's


# ------------------------- K4: the kernel's split-and-merge arithmetic
def _k4_emulation(q, k, v, lengths, window, n_sm=H100_SMS):
    """csrc/decode_attention.cu's arithmetic in torch, at the plan the
    wrapper picks: per chunk a max, p = exp(s - max), its sum and p V;
    then the last block's merge over the chunks in split order, skipping
    empty chunks; with no valid key at all, the mean of V's S rows."""
    b, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    chunk, n_split = da.split_plan(b * kvh, s, window, d, k.element_size(), n_sm)
    out = torch.empty((b, h, d))
    for bi in range(b):
        for kv in range(kvh):
            qg = q[bi, kv * g:(kv + 1) * g].float()
            parts = []
            for split in range(n_split):
                c0, c1 = _chunk_keys(int(lengths[bi]), s, window, chunk, split)
                if c1 == c0:
                    parts.append((torch.full((g,), -1e30), torch.zeros(g), None))
                    continue
                sc = qg @ k[bi, c0:c1, kv].float().T * d**-0.5
                m = sc.amax(-1)
                p = torch.exp(sc - m[:, None])
                parts.append((m, p.sum(-1), p @ v[bi, c0:c1, kv].float()))
            mx = torch.stack([m for m, _, _ in parts]).amax(0)
            total = torch.zeros(g)
            acc = torch.zeros((g, d))
            for m, l, a in parts:
                total += l * torch.exp(m - mx)
                if a is not None:
                    acc += a * torch.exp(m - mx)[:, None]
            if (total == 0).all():
                res = v[bi, :, kv].float().mean(0).expand(g, d)
            else:
                res = acc / total[:, None]
            out[bi, kv * g:(kv + 1) * g] = res
    return out.to(q.dtype)


@pytest.mark.parametrize(
    "b,h,kvh,s,d,window,lengths",
    [
        (3, 4, 1, 256, 64, None, [0, 100, 263]),  # 32 chunks of 8 keys
        (3, 8, 2, 128, 64, 32, [0, 160, 50]),  # 160 = S + window: no valid key
        (4, 4, 1, 512, 256, 128, [640, 0, 300, 511]),  # Gemma's head_dim and group
        (2, 4, 1, 192, 128, None, [192, 1]),
    ],
)
def test_k4_split_merge_matches_the_pallas_kernel(b, h, kvh, s, d, window, lengths):
    q, k, v = _normal(b, h, d), _normal(b, s, kvh, d), _normal(b, s, kvh, d)
    lens = np.asarray(lengths, np.int32)
    got = _k4_emulation(*_t(q, k, v), torch.from_numpy(lens), window)
    # the Pallas kernel on the reference's packed (B * KVH, ., D) layout
    g = h // kvh
    pk = lambda x: jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * kvh, s, d))  # noqa: E731
    pallas = np.asarray(decode_attention_packed(
        jnp.asarray(q.reshape(b * kvh, g, d)), pk(k), pk(v),
        jnp.asarray(np.repeat(lens, kvh).reshape(b * kvh, 1)),
        scale=d**-0.5, window=window, bk=64, interpret=True)).reshape(b, h, d)
    np.testing.assert_allclose(got.numpy(), pallas, atol=F32_ATOL)
    # and the plain version (the wrapper on CPU tensors)
    plain = da.decode_attention_cache(*_t(q, k, v), torch.from_numpy(lens), window=window)
    np.testing.assert_allclose(plain.numpy(), pallas, atol=F32_ATOL)


@pytest.mark.parametrize("window,length", [(None, 0), (32, 0), (32, 128 + 32), (32, 128 + 40)])
def test_k4_no_valid_key_gives_the_mean_of_v(window, length):
    # the reference's masked scores are all -1e30, its softmax uniform:
    # the Pallas kernel returns the mean of V's S rows, and so must K4
    b, h, kvh, s, d = 2, 4, 1, 128, 64
    q, k, v = _normal(b, h, d), _normal(b, s, kvh, d), _normal(b, s, kvh, d)
    lens = np.array([length, 5], np.int32)
    pk = lambda x: jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * kvh, s, d))  # noqa: E731
    pallas = np.asarray(decode_attention_packed(
        jnp.asarray(q.reshape(b * kvh, h, d)), pk(k), pk(v), jnp.asarray(lens.reshape(b, 1)),
        scale=d**-0.5, window=window, bk=64, interpret=True))
    mean = v[0, :, 0].mean(0)
    np.testing.assert_allclose(pallas[0], np.broadcast_to(mean, (h, d)), atol=1e-6)
    got = _k4_emulation(*_t(q, k, v), torch.from_numpy(lens), window)
    np.testing.assert_allclose(got.numpy(), pallas, atol=F32_ATOL)
    plain = da.decode_attention_cache(*_t(q, k, v), torch.from_numpy(lens), window=window)
    np.testing.assert_allclose(plain.numpy(), pallas, atol=F32_ATOL)


# --------------------------------- the model-layout functions the LM calls
@pytest.mark.parametrize("block", [1024, 16])  # the reference's dense / scan branch
@pytest.mark.parametrize(
    "b,s,h,kvh,hd,window", [(2, 64, 4, 2, 16, None), (2, 50, 4, 1, 16, 8), (1, 40, 6, 3, 8, None)]
)
def test_attention_scores_blockwise_matches_reference(block, b, s, h, kvh, hd, window):
    q, k, v = _normal(b, s, h, hd), _normal(b, s, kvh, hd), _normal(b, s, kvh, hd)
    ref = np.asarray(RL.attention_scores_blockwise(*map(jnp.asarray, (q, k, v)), causal=True,
                                                   window=window, block=block))
    out = L.attention_scores_blockwise(*_t(q, k, v), causal=True, window=window)
    np.testing.assert_allclose(out.numpy(), ref, atol=F32_ATOL)
    # the plain version's own two branches
    plain = fa_plain.flash_attention_bshd(*_t(q, k, v), causal=True, window=window, block=block)
    np.testing.assert_allclose(plain.numpy(), ref, atol=F32_ATOL)


@pytest.mark.parametrize(
    "b,sq,sk,h,kvh,causal,window,block",
    [
        (2, 12, 30, 4, 4, False, None, 1024),  # cross attention (whisper: non-causal, group 1)
        (2, 12, 30, 4, 2, False, None, 8),  # the blockwise branch at a small block
        (2, 7, 1500, 4, 4, False, None, 1024),  # whisper's 1500 frames: blockwise past 1024 keys
        (1, 9, 1100, 4, 2, True, None, 1024),  # causal, Sk > Sq, blockwise
        (2, 12, 30, 4, 2, True, None, 1024),  # causal, Sk > Sq: kpos <= qpos from 0
        (2, 30, 12, 4, 2, True, None, 1024),  # causal, Sk < Sq
        (1, 20, 40, 4, 1, True, 6, 1024),  # a window
        (1, 20, 40, 4, 1, True, 6, 16),
    ],
)
def test_k3_takes_a_key_length_other_than_the_query_length(b, sq, sk, h, kvh, causal, window, block):
    hd = 16
    q, k, v = _normal(b, sq, h, hd), _normal(b, sk, kvh, hd), _normal(b, sk, kvh, hd)
    ref = np.asarray(RL.attention_scores_blockwise(*map(jnp.asarray, (q, k, v)), causal=causal,
                                                   window=window, block=block))
    plain = fa_plain.flash_attention_bshd(*_t(q, k, v), causal=causal, window=window, block=block)
    assert plain.shape == ref.shape == (b, sq, h, hd)
    np.testing.assert_allclose(plain.numpy(), ref, atol=F32_ATOL)
    if block == 1024:  # the layer and the wrapper: the plain version at its default block
        before = fa.flash_attention_bshd.launches_cross
        out = L.attention_scores_blockwise(*_t(q, k, v), causal=causal, window=window)
        np.testing.assert_allclose(out.numpy(), ref, atol=F32_ATOL)
        assert fa.flash_attention_bshd.launches_cross == before  # CPU calls launch nothing


def test_k3_checks_the_key_and_value_lengths():
    q, k = torch.zeros((1, 8, 2, 16)), torch.zeros((1, 5, 2, 16))
    with pytest.raises(ValueError, match="do not match"):
        fa.flash_attention_bshd(q, k, torch.zeros((1, 6, 2, 16)))
    with pytest.raises(ValueError, match="no keys"):
        fa.flash_attention_bshd(q, k[:, :0], k[:, :0])
    assert fa.flash_attention_bshd(q, k, k).shape == (1, 8, 2, 16)


@pytest.mark.parametrize("window", [None, 24])
def test_decode_attention_jnp_matches_reference_bf16_q_f32_cache(window):
    # the serving engine's mix: bf16 activations against an f32 cache,
    # read in the cache's own (B, S, KVH, hd) layout
    b, h, kvh, s, hd = 3, 4, 1, 64, 32
    q, kc, vc = _normal(b, h, hd), _normal(b, s, kvh, hd), _normal(b, s, kvh, hd)
    lengths = np.array([1, 40, 64], np.int32)
    ref = RL.decode_attention_jnp(jnp.asarray(q, jnp.bfloat16), jnp.asarray(kc), jnp.asarray(vc),
                                  jnp.asarray(lengths), window=window)
    out = da.decode_attention_cache(torch.from_numpy(q).bfloat16(), *_t(kc, vc),
                                    torch.from_numpy(lengths), window=window)
    assert out.dtype == torch.bfloat16 and out.shape == (b, h, hd)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=BF16_ATOL)


def test_decode_attention_reads_a_layer_slice_of_the_stacked_cache():
    # (L, B, S, KVH, hd)[l] is a strided view: same answer as a copy
    b, h, kvh, s, hd = 2, 4, 2, 32, 16
    q = torch.from_numpy(_normal(b, h, hd))
    kc, vc = (torch.from_numpy(_normal(3, b, s, kvh, hd)) for _ in range(2))
    lens = torch.tensor([5, 32], dtype=torch.int32)
    got = da.decode_attention_cache(q, kc[1], vc[1], lens, window=8)
    want = da_plain.decode_attention(q, kc[1].clone(), vc[1].clone(), lens, window=8)
    assert torch.equal(got, want)


# ----------------------------------------------------- wrapper contracts
def test_wrappers_never_fall_back_to_plain_off_the_cpu():
    # a tensor that is not on the CPU goes to the kernel or raises; the
    # meta device stands in for "not the CPU" here
    q = torch.empty((1, 8, 2, 64), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_attention_bshd(q, q, q)
    qd = torch.empty((1, 2, 64), device="meta")
    kc = torch.empty((1, 8, 1, 64), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        da.decode_attention_cache(qd, kc, kc, torch.ones(1, dtype=torch.int32, device="meta"))


def test_flash_attention_kernel_is_fixed_by_dtype(monkeypatch):
    # bf16 goes to the tensor-core kernel: a base pointer or stride TMA
    # cannot take raises before the library is even loaded; float32 goes to
    # the SIMT kernel, which takes any stride, and meets the device check
    def no_launch():
        raise AssertionError("a kernel was launched")

    monkeypatch.setattr(fa._build, "load_library", no_launch)
    assert fa._DTYPES == {torch.float32: 0, torch.bfloat16: 1}
    bf16 = torch.bfloat16
    odd_stride = torch.empty((1, 8, 2, 68), device="meta", dtype=bf16)[..., :64]  # 136-byte head stride
    odd_base = torch.empty((1 * 8 * 2 * 64 + 1,), device="meta", dtype=bf16)[1:].view(1, 8, 2, 64)
    for q in (odd_stride, odd_base):
        with pytest.raises(ValueError, match="16-byte"):
            fa.flash_attention_bshd(q, q, q)
    aligned = torch.empty((1, 8, 2, 64), device="meta", dtype=bf16)
    # B = S = 1: those strides are never stepped, whatever their value
    one_row = torch.empty(1000, device="meta", dtype=bf16).as_strided((1, 1, 2, 64), (999, 4, 64, 1))
    f32_odd = torch.empty((1, 8, 2, 68), device="meta")[..., :64]
    for q in (aligned, one_row, f32_odd):
        with pytest.raises(ValueError, match="cuda or cpu"):
            fa.flash_attention_bshd(q, q, q)


def test_k3_takes_expanded_k_and_v_to_the_kernel(monkeypatch):
    # K and V expanded over the batch or the KV heads (a stride of 0) pass
    # the bf16 kernel's TMA checks unchanged and meet the device check: TMA
    # takes a stride of 0, and on the card the kernel over such K/V agrees
    # with its plain version (chip_smoke.py, check_flash_attention)
    def no_launch():
        raise AssertionError("a kernel was launched")

    monkeypatch.setattr(fa._build, "load_library", no_launch)
    bf16 = torch.bfloat16
    q = torch.empty((2, 300, 8, 64), device="meta", dtype=bf16)
    over_batch = torch.empty((1, 300, 2, 64), device="meta", dtype=bf16).expand(2, 300, 2, 64)
    over_heads = torch.empty((2, 300, 1, 64), device="meta", dtype=bf16).expand(2, 300, 4, 64)
    for kv in (over_batch, over_heads):
        assert 0 in kv.stride()
        fa._check_tma(q, kv, kv)
        with pytest.raises(ValueError, match="cuda or cpu"):
            fa.flash_attention_bshd(q, kv, kv)


def test_decode_attention_checks_cache_alignment(monkeypatch):
    # the kernel's 16-byte cp.async copies: a cache whose base or stepped
    # stride is not 16-byte aligned raises before the library is loaded;
    # a size-1 dimension's stride is never stepped, whatever its value
    def no_launch():
        raise AssertionError("a kernel was launched")

    monkeypatch.setattr(da._build, "load_library", no_launch)
    q = torch.empty((2, 4, 64), device="meta", dtype=torch.bfloat16)
    odd_seq = torch.empty((2, 16, 1, 68), device="meta", dtype=torch.bfloat16)[..., :64]  # 136 B
    odd_base = torch.empty((2 * 16 * 64 + 1,), device="meta", dtype=torch.bfloat16)[1:].view(2, 16, 1, 64)
    for kc in (odd_seq, odd_base):
        with pytest.raises(ValueError, match="16-byte"):
            da.decode_attention_cache(q, kc, kc, torch.ones(2, dtype=torch.int32, device="meta"))
    one_head = torch.empty(4000, device="meta", dtype=torch.bfloat16).as_strided(
        (2, 16, 1, 64), (1024, 64, 3, 1))
    with pytest.raises(ValueError, match="cuda or cpu"):
        da.decode_attention_cache(q, one_head, one_head, torch.ones(2, dtype=torch.int32, device="meta"))


def test_wrappers_check_dtype_and_shape():
    x = torch.zeros((1, 8, 2, 16))
    with pytest.raises(TypeError):
        fa.flash_attention_bshd(x.double(), x.double(), x.double())
    with pytest.raises(TypeError):
        fa.flash_attention_bshd(x, x.bfloat16(), x)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention_bshd(torch.zeros((1, 8, 3, 16)), x, x)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention_bshd(x, x, x, window=0)
    q, kc = torch.zeros((1, 2, 16)), torch.zeros((1, 8, 1, 16))
    with pytest.raises(ValueError, match="lengths"):
        da.decode_attention_cache(q, kc, kc, torch.ones(2, dtype=torch.int32))
    with pytest.raises(TypeError):
        da.decode_attention_cache(q, kc.half(), kc.half(), torch.ones(1, dtype=torch.int32))


@pytest.mark.parametrize(
    "b,h,kvh,s,d,dv,want",
    [
        (4, 4, 1, 2048, 256, 256, 16),  # Gemma3-1B's prefill: one group, every head's heaviest tile first
        (4, 16, 16, 1024, 128, 128, 16),  # OLMoE's: 512 KiB of K/V a head
        (4, 128, 128, 1024, 192, 128, 12),  # DeepSeek-V2's: 640 KiB a head
        (2, 8, 2, 65536, 128, 128, 4),  # one KV head past the budget: a group is still whole
    ],
)
def test_k3_tile_groups_hold_whole_kv_heads_within_the_l2_budget(b, h, kvh, s, d, dv, want):
    got = fa.tile_group(b, h, kvh, s, d, dv)
    assert got == want
    group, kv_bytes = h // kvh, s * (d + dv) * 2
    assert got == b * h or got % group == 0
    assert got // group == 1 or got // group * kv_bytes <= fa.KV_L2_BYTES


def test_k3_tile_groups_without_a_budget_are_head_major(monkeypatch):
    monkeypatch.setattr(fa, "KV_L2_BYTES", 0)
    assert fa.tile_group(4, 128, 128, 1024, 192, 128) == 1
    assert fa.tile_group(4, 8, 2, 1024, 128, 128) == 4  # the query heads of one KV head
    monkeypatch.setattr(fa, "KV_L2_BYTES", 1 << 60)
    assert fa.tile_group(4, 128, 128, 1024, 192, 128) == 512  # one group: every head's heaviest tile first


def test_launch_counters_ignore_cpu_calls():
    before = (fa.flash_attention_bshd.launches, da.decode_attention_cache.launches)
    x = torch.zeros((1, 8, 2, 16))
    fa.flash_attention_bshd(x, x, x)
    da.decode_attention_cache(torch.zeros((1, 2, 16)), x, x, torch.ones(1, dtype=torch.int32))
    assert (fa.flash_attention_bshd.launches, da.decode_attention_cache.launches) == before
