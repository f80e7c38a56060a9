"""The dry run's dot FLOPs against the reference's
``hlo_analysis.analyze`` of the same cell: smoke configurations of
gemma3-1b, olmoe-1b-7b, deepseek-v2-236b and hymba-1.5b, each a train,
prefill and decode cell on the 1x1 host mesh, at head widths the kernels
take (the trace runs the card's branch).

The two programs differ where the port runs a kernel.  The reference's
jnp attention computes every (query, key) pair, masked or not, in
products an HLO dot each — forward, its rematerialisation and the
backward's four products in a train cell — and its decode attends over
the whole cache; the port's attention is K3, K3's backward and K4, whose
work each launch hands the trace from its cost function.  For hymba the
reference's Mamba has two more dot-like terms the port runs in K6 or
elementwise: ``y = h C`` as an einsum and the causal conv as a
convolution, whose weight gradient the reference's analysis counts as a
dense convolution over the channels (it divides by
``feature_group_count`` only, and XLA lowers the depthwise weight
gradient with ``batch_group_count``).  The test works those terms out
from the cell's shapes; the rest must agree within :data:`REST_RTOL`
(2%: the Mamba einsum and conv in the reference's forward, about 1%), and
the port's kernel terms must equal their cost functions summed over the
launches the cell's layers make.

Then the training mesh's placement: a train cell's argument bytes on its
busiest device against the bytes of the reference's spec trees, on small
meshes at the smoke configurations and on the 16x16 production mesh at
full size (no trace: ``specs.build_cell`` places the state on meta
tensors).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro import configs as RC  # noqa: E402
from repro.configs.shapes import InputShape as RShape  # noqa: E402
from repro.distributed import sharding as Rsh  # noqa: E402
from repro.launch import hlo_analysis as RH  # noqa: E402
from repro.launch import mesh as RM  # noqa: E402
from repro.launch import specs as RS  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.configs.shapes import InputShape  # noqa: E402
from repro_torch.kernels.cost import KernelCost  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.selective_scan import ops as scan_ops  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.distributed import sharding as Tsh  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import hlo_analysis as H  # noqa: E402
from repro_torch.launch import specs as TS  # noqa: E402
from repro_torch.launch.mesh import RoleMesh, make_host_mesh, make_mesh, make_production_mesh  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

REST_RTOL = 0.02
SEQ, BATCH = 32, 8  # train: 2 microbatches of 4


def _widen(cfg):
    if cfg.attn_type == "mla":
        return dataclasses.replace(cfg, nope_head_dim=128, rope_head_dim=64, v_head_dim=128)
    return dataclasses.replace(cfg, head_dim=64)


def _attention(cfg):
    """(heads, KV heads, q/k width, v width, the window of each attention
    layer in order)."""
    model = T.TransformerLM(cfg, "meta")
    windows = [None] * (len(model.dense_prefix) if model.dense_prefix else 0)
    windows += [D._window(cfg, local) for local in model.is_local]
    if cfg.attn_type == "mla":
        return cfg.num_heads, cfg.num_heads, cfg.nope_head_dim + cfg.rope_head_dim, cfg.v_head_dim, windows
    hd = cfg.resolved_head_dim
    return cfg.num_heads, cfg.num_kv_heads, hd, hd, windows


def _reference_terms(cfg, kind: str) -> float:
    """The reference's dots the port runs in kernels or elementwise."""
    h, _, d, dv, windows = _attention(cfg)
    layers, micro, accum = len(windows), BATCH // 2, 2
    d_in, n, conv = 2 * cfg.d_model, cfg.ssm_state, cfg.ssm_conv
    hybrid = cfg.family == "hybrid"
    if kind == "prefill":
        attn = 2 * (d + dv) * BATCH * h * SEQ * SEQ
        mamba = 2 * BATCH * SEQ * d_in * (n + 1)  # y = h C; the depthwise conv, one tap a channel
        return layers * (attn + hybrid * mamba)
    if kind == "decode":
        attn = 0 if cfg.attn_type == "mla" else 4 * d * BATCH * h * SEQ  # MLA decodes in plain torch on both
        mamba = 2 * BATCH * d_in * (n + conv)  # y = h C; the conv as an einsum over its window
        return layers * (attn + hybrid * mamba)
    attn = 4 * 2 * (d + dv) * micro * h * SEQ * SEQ  # forward, remat, backward (2x)
    mamba = 4 * 2 * micro * SEQ * d_in * (n + 1) + 2 * (conv * d_in * d_in) * (micro * SEQ)
    return accum * layers * (attn + hybrid * mamba)


def _port_kernels(cfg, kind: str) -> dict:
    """Each kernel's cost functions summed over the cell's launches."""
    h, kvh, d, dv, windows = _attention(cfg)
    dt, hybrid = T.torch_dtype(cfg.dtype), cfg.family == "hybrid"
    d_in, n = 2 * cfg.d_model, cfg.ssm_state
    out: dict = {}

    def add(name, cost, times=1):
        out[name] = out[name] + times * cost if name in out else times * cost

    for w in windows:
        if kind == "prefill":
            add("flash_attention", fa_ops.flash_attention_cost(BATCH, SEQ, SEQ, h, kvh, d, dv, True, w, dt))
            if hybrid:
                add("selective_scan", scan_ops.selective_scan_cost(BATCH, SEQ, d_in, n, dt, False, True))
        elif kind == "decode":
            if cfg.attn_type != "mla":
                add("decode_attention", da_ops.decode_attention_cost(BATCH, SEQ, h, kvh, d, w, dt, torch.bfloat16))
            if hybrid:
                add("selective_scan", scan_ops.selective_scan_cost(BATCH, 1, d_in, n, dt, True, True))
        else:
            micro = BATCH // 2  # 2 microbatches: forward and its recompute, then the backward
            add("flash_attention", fa_ops.flash_attention_cost(micro, SEQ, SEQ, h, kvh, d, dv, True, w, dt, lse=True), 4)
            add("flash_attention_bwd", fa_ops.flash_attention_bwd_cost(micro, SEQ, SEQ, h, kvh, d, dv, True, w, dt), 2)
            if hybrid:
                add("selective_scan", scan_ops.selective_scan_cost(micro, SEQ, d_in, n, dt, False, True, True), 4)
                add("selective_scan_bwd", scan_ops.selective_scan_bwd_cost(micro, SEQ, d_in, n, dt, False, True), 2)
    return out


def _reference_dots(arch: str, kind: str) -> float:
    cfg, mesh = _widen(RC.get_smoke_config(arch)), RM.make_host_mesh()
    with Rsh.use_rules(Rsh.SINGLE_POD_RULES), jax.set_mesh(mesh):
        spec = getattr(RS, f"{kind}_cell")(cfg, RShape("c", kind, SEQ, BATCH), mesh)
        compiled = jax.jit(spec.fn, in_shardings=spec.in_shardings,
                           donate_argnums=spec.donate_argnums).lower(*spec.args).compile()
    return RH.analyze(compiled.as_text()).dot_flops


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", ["gemma3-1b", "olmoe-1b-7b", "deepseek-v2-236b", "hymba-1.5b"])
def test_dot_flops_agree_with_reference(arch, kind):
    cfg = _widen(TC.get_smoke_config(arch))
    rec = dryrun.run_cell(cfg, InputShape("c", kind, SEQ, BATCH), make_host_mesh(H.trace_devices(1)))
    rest = _reference_dots(arch, kind) - _reference_terms(cfg, kind)
    port = rec["hlo"]["dot_flops"]
    assert abs(port - rest) <= REST_RTOL * rest, (port, rest)
    want = _port_kernels(cfg, kind)
    got = rec["hlo"]["kernels"]
    assert set(got) == set(want)
    for name, cost in want.items():
        k = KernelCost(got[name]["flops"], got[name]["exps"], got[name]["bytes"])
        assert k.flops == pytest.approx(cost.flops, rel=1e-12), name
        assert (k.exps, k.bytes) == pytest.approx((cost.exps, cost.bytes), rel=1e-12), name


# ------------------------------------------------- the reference's layout
def _fsdp(cfg, mesh) -> bool:
    """The reference adds FSDP to the parameters' specs on ``mesh``."""
    params = TS.param_structs(cfg, torch.float32)
    return TS.maybe_fsdp_pspecs(cfg, params, Tsh.param_pspecs(params), mesh, bytes_per_param=4)[1]


@pytest.mark.parametrize("shape", [(2, 2), (4, 4)])
@pytest.mark.parametrize("arch", TC.ARCH_NAMES)
def test_train_cell_places_the_reference_layout(arch, shape):
    """A train cell on the (2, 2) and (4, 4) meshes (their RoleMesh) at the
    smoke configurations places on its busiest device exactly the bytes of
    the reference's spec trees: every "model"-split leaf as its slice, its
    moments the ZeRO slices of that slice."""
    cfg = TC.get_smoke_config(arch)
    mesh = make_mesh(shape, ("data", "model"), H.trace_devices(16))
    with Tsh.use_rules(Tsh.SINGLE_POD_RULES):
        assert not _fsdp(cfg, mesh)
        spec = TS.build_cell(cfg, InputShape("c", "train", SEQ, 16), mesh)
    assert len(spec.device_args) == RoleMesh(mesh).size
    assert spec.argument_bytes == spec.reference_argument_bytes


@pytest.mark.parametrize("arch", TC.ARCH_NAMES)
def test_train_4k_on_the_production_mesh_places_the_reference_layout(arch):
    """train_4k on the 16x16 mesh at full size: the reference layout's
    bytes to the byte for every arch, those above the reference's FSDP
    threshold (qwen3-32b, internlm2-20b, internvl2-26b, deepseek-v2-236b)
    included: there each device's parameters are placed under the FSDP
    tree (``zero_pspecs`` of the parameters' specs, the moments' tree), to
    the byte, and a layer another data index owns takes no byte."""
    cfg = TC.get_config(arch)
    mesh = make_production_mesh(devices=H.trace_devices(256))
    with Tsh.use_rules(Tsh.SINGLE_POD_RULES):
        fsdp = _fsdp(cfg, mesh)
        spec = TS.build_cell(cfg, SHAPES["train_4k"], mesh)
    assert spec.argument_bytes == spec.reference_argument_bytes
    assert fsdp == (arch in ("qwen3-32b", "internlm2-20b", "internvl2-26b", "deepseek-v2-236b"))
    state, state_specs = spec.args[0], spec.in_specs[0]
    assert (state_specs["params"] == state_specs["opt"]["m"]) == fsdp
    shapes = TS.zero._shapes(TS.param_structs(cfg, torch.float32))
    want = TS._spec_bytes(shapes, state_specs["params"], mesh, 4)
    for copy in state["params"]:
        assert sum(w.numel() * w.element_size() for w in copy.parameters()) == want
        assert any(w.numel() == 0 for w in copy.parameters()) == (fsdp and arch != "deepseek-v2-236b")
