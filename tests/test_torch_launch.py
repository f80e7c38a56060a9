"""The port's ``launch/specs.py``, ``launch/dryrun.py`` and
``launch/hlo_analysis.py`` on the CPU.

* The spec trees of ``train_cell``, ``prefill_cell`` and ``decode_cell``
  equal the reference's (``in_shardings``' specs) for every smoke
  configuration, on a 1x1 mesh here and on a (2, 2) mesh in a subprocess
  with 4 forced JAX host devices.
* The analysis of a traced program on the reference's known workloads
  (``tests/test_hlo_analysis.py``): a loop of layers, a checkpointed
  backward, a row written into a cache, a matmul's FLOPs and bytes, a
  product on a two-device mesh and its collective.
* The trace launches nothing, its library refuses real pointers, and a
  CUDA tensor inside a trace raises.
* The kernels' cost functions against the formulas ``chip_smoke.py``
  bounded each kernel with, at its timed shapes.
* The role-mesh shortcut against a full trace of the training mesh.
* One full-size cell of each kind traced to its end on the 1x1 host mesh.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

from repro import configs as RC  # noqa: E402
from repro.configs.shapes import InputShape as RShape  # noqa: E402
from repro.distributed import sharding as Rsh  # noqa: E402
from repro.launch import mesh as RM  # noqa: E402
from repro.launch import specs as RS  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.configs.shapes import SHAPES, InputShape  # noqa: E402
from repro_torch.distributed import collectives as C  # noqa: E402
from repro_torch.distributed import sharding as Tsh  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.selective_scan import ops as scan_ops  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.launch import hlo_analysis as H  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, make_mesh  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SUBPROCESS_TIMEOUT_S = 600
META = torch.device("meta")
# the cells whose spec trees are compared: (kind, seq_len, global batch); a
# decode of one sequence puts the cache's sequence on the data axes
SPEC_CELLS = (("train", 64, 8), ("prefill", 64, 8), ("decode", 64, 8), ("decode", 64, 1))


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def _lists(tree):
    """Spec trees as nested lists (JSON's form, either package's)."""
    return json.loads(json.dumps(tree))


# ------------------------------------------------------------- spec trees
def _port_specs(arch: str, mesh) -> list:
    out = []
    with Tsh.use_rules(Tsh.SINGLE_POD_RULES):
        for kind, s, b in SPEC_CELLS:
            out.append(_lists(specs.build_cell(TC.get_smoke_config(arch), InputShape("c", kind, s, b), mesh).in_specs))
    return out


def _reference_specs(arch: str, mesh) -> list:
    out = []
    with Rsh.use_rules(Rsh.SINGLE_POD_RULES), jax.set_mesh(mesh):
        for kind, s, b in SPEC_CELLS:
            spec = getattr(RS, f"{kind}_cell")(RC.get_smoke_config(arch), RShape("c", kind, s, b), mesh)
            out.append(_lists(jax.tree.map(lambda sh: list(sh.spec), spec.in_shardings,
                                           is_leaf=lambda x: isinstance(x, NamedSharding))))
    return out


@pytest.mark.parametrize("arch", RC.ARCH_NAMES)
def test_spec_trees_equal_reference_on_host_mesh(arch):
    assert _port_specs(arch, make_host_mesh(H.trace_devices(1))) == _reference_specs(arch, RM.make_host_mesh())


_REFERENCE_SPECS = textwrap.dedent(
    """
    import json, sys
    import jax
    from jax.sharding import NamedSharding
    from repro import configs
    from repro.configs.shapes import InputShape
    from repro.distributed import sharding
    from repro.launch import mesh as M, specs
    cells = json.loads(sys.argv[1])
    mesh = M.make_mesh((2, 2), ("data", "model"))
    out = {}
    with sharding.use_rules(sharding.SINGLE_POD_RULES), jax.set_mesh(mesh):
        for arch in configs.ARCH_NAMES:
            out[arch] = []
            for kind, s, b in cells:
                cell = getattr(specs, kind + "_cell")(configs.get_smoke_config(arch), InputShape("c", kind, s, b), mesh)
                out[arch].append(jax.tree.map(lambda sh: list(sh.spec), cell.in_shardings,
                                              is_leaf=lambda x: isinstance(x, NamedSharding)))
    print("SPECS", json.dumps(out))
    """
)


@pytest.fixture(scope="module")
def reference_specs_2x2():
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=4", "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", _REFERENCE_SPECS, json.dumps(SPEC_CELLS)], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=SUBPROCESS_TIMEOUT_S)
    line = next((ln for ln in out.stdout.splitlines() if ln.startswith("SPECS ")), None)
    assert line is not None, out.stdout + out.stderr
    return json.loads(line[len("SPECS "):])


def test_spec_trees_equal_reference_on_2x2_mesh(reference_specs_2x2):
    mesh = make_mesh((2, 2), ("data", "model"), H.trace_devices(4))
    for arch in RC.ARCH_NAMES:
        assert _port_specs(arch, mesh) == _lists(reference_specs_2x2[arch]), arch


# the smoke cells on (2, 2): gemma3-1b's cache splits by heads (kv 1 repeated 2 over 2 model devices),
# hymba-1.5b's by sequence (5 KV heads over 2) beside its Mamba states, split by channels, xlstm-125m keeps its
# recurrent states alone (4 mLSTM heads and 32 channels over 2), whisper-large-v3's self and cross caches split by
# heads (4 over 2), deepseek-v2-236b's latent cache by sequence beside its heads over "model" (4 over 2); no arch
# keeps a reason it is not served on (2, 2)
MESH_SERVING = {"gemma3-1b": None, "hymba-1.5b": None, "xlstm-125m": None,
                "deepseek-v2-236b": None, "whisper-large-v3": None}


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", list(MESH_SERVING))
def test_prefill_and_decode_skip_a_mesh_of_more_than_one_device(arch, kind):
    """On (2, 2) gemma3-1b's, hymba-1.5b's, xlstm-125m's,
    deepseek-v2-236b's and whisper-large-v3's prefill and decode step are
    traced (the mesh's steps, at head widths the kernels take): K3 or K4
    once a layer on the busiest device, hymba's K6 once a layer beside it,
    no kernel for the xLSTM; whisper's K3 once an encoder layer and twice a
    decoder layer (self and cross), K4 twice a decoder layer; MLA's K3 once
    a layer (the dense prefix's among them) on each model device in
    prefill and no kernel in decode (its absorbed form is plain torch).  A
    cell the slice leaves out would keep a skip reason naming it
    (``decode.mesh_serving_gap``)."""
    mesh = make_mesh((2, 2), ("data", "model"), H.trace_devices(4))
    cfg = _widened(arch) if MESH_SERVING[arch] is None else TC.get_smoke_config(arch)
    rec = dryrun.run_cell(cfg, InputShape("c", kind, 64, 8), mesh)
    if MESH_SERVING[arch] is None:
        assert "skipped" not in rec and "hlo" in rec
        kernel = "flash_attention" if kind == "prefill" else "decode_attention"
        want = {"gemma3-1b": {kernel: cfg.num_layers}, "xlstm-125m": {},
                "hymba-1.5b": {kernel: cfg.num_layers, "selective_scan": cfg.num_layers},
                "deepseek-v2-236b": {kernel: cfg.num_layers} if kind == "prefill" else {},
                "whisper-large-v3": {kernel: (cfg.encoder_layers if kind == "prefill" else 0) + 2 * cfg.num_layers}
                }[arch]
        assert rec["hlo"]["launches"] == want
        mem = rec["memory"]
        assert mem["dtype_surplus_bytes"] > 0  # the port's f32 norm scales over the reference's bf16
        assert mem["argument_bytes"] == mem["reference_layout_argument_bytes"] + mem["dtype_surplus_bytes"]
    else:
        assert "hlo" not in rec and MESH_SERVING[arch] in rec["skipped"] and "ROADMAP 26b" in rec["skipped"]


# ------------------------------------------------ the analysis, known workloads
def test_loop_of_layers_multiplies_flops():
    b, d = 32, 64

    def layers(x, w):
        for wl in w:
            x = torch.tanh(x @ wl)
        return x

    one_layer = 2 * b * d * d
    for n in (4, 8):
        _, s, _ = H.analyze(layers, _meta(b, d), _meta(n, d, d))
        assert abs(s.dot_flops - n * one_layer) / (n * one_layer) < 0.05


def test_checkpointed_backward_counts_three_matmuls():
    b, d, n = 16, 32, 3
    from torch.utils.checkpoint import checkpoint

    def f(x, w):
        c = x
        for wl in w:
            c = checkpoint(lambda c, wl: torch.tanh(c @ wl), c, wl, use_reentrant=False)
        return torch.autograd.grad(c.sum(), [w])

    _, s, _ = H.analyze(f, _meta(b, d), _meta(n, d, d).requires_grad_(True))
    fwd = n * 2 * b * d * d
    assert 2.8 * fwd <= s.dot_flops <= 4.2 * fwd


def test_row_write_counts_the_row_not_the_buffer():
    buffer_bytes = 1024 * 256 * 4

    def write(cache, row):
        cache[3] = row

    _, s, _ = H.analyze(write, _meta(1024, 256), _meta(256))
    assert s.traffic_bytes < 0.1 * buffer_bytes
    # the KV cache's per-sequence row write (decode's), on a 1 MiB cache
    lengths = torch.empty(4, dtype=torch.int32, device=META)
    _, s, _ = H.analyze(D._scatter_rows_, _meta(4, 1024, 64), _meta(4, 64), lengths)
    assert s.traffic_bytes < 0.1 * buffer_bytes


def test_dot_counts_flops_and_bytes():
    m = 256
    _, s, _ = H.analyze(torch.matmul, _meta(m, m), _meta(m, m))
    assert abs(s.dot_flops - 2 * m**3) / (2 * m**3) < 0.01
    assert s.dot_flops_by_dtype == {"float32": 2.0 * m**3}
    expect = 3 * m * m * 4  # read a, read b, write out
    assert 0.9 * expect <= s.traffic_bytes <= 1.6 * expect


def test_product_on_two_devices_reports_collectives_by_type():
    """x (64, 128) @ w (128, 64) with the contraction split over two
    devices: each device's partial product, summed with the ring (an
    all-reduce of the (64, 64) result), then a copy of the sum to each
    device (a collective-permute)."""
    devices = H.trace_devices(2)

    def product(x, w):
        parts = []
        for i, dev in enumerate(devices):
            with dev.scope():
                parts.append(x[:, 64 * i:64 * (i + 1)] @ w[64 * i:64 * (i + 1)])
        total = C.ring_allreduce(parts, devices)
        return C.copy_leaves([total[0]], devices)

    _, s, _ = H.analyze(product, _meta(64, 128), _meta(128, 64))
    assert s.collective_bytes == {"all-reduce": 64 * 64 * 4, "collective-permute": 64 * 64 * 4}
    assert s.total_collective_bytes == 2 * 64 * 64 * 4
    assert s.dot_flops == 2 * 64 * 64 * 64  # one device's half of the contraction


# ------------------------------------------------------- a trace launches nothing
class _Sink:
    def __init__(self):
        self.launches = []

    def kernel_launch(self, name, cost):
        self.launches.append((name, cost))


def test_trace_launches_nothing_and_hands_over_the_work():
    q = _meta(2, 48, 4, 64, dtype=torch.bfloat16)
    k = _meta(2, 48, 1, 64, dtype=torch.bfloat16)
    before = fa_ops.flash_attention_bshd.launches
    sink = _Sink()
    with _build.trace(sink) as lib:
        out = fa_ops.flash_attention_bshd(q, k, k, window=16)
    assert out.device == META and out.shape == (2, 48, 4, 64)
    assert fa_ops.flash_attention_bshd.launches == before  # nothing launched, nothing counted
    assert [name for name, _ in lib.calls] == ["repro_flash_attention"]
    assert sink.launches == [("flash_attention", fa_ops.flash_attention_cost(
        2, 48, 48, 4, 1, 64, 64, True, 16, torch.bfloat16))]


def test_recording_library_refuses_real_pointers():
    lib = _build.RecordingLibrary()
    real = torch.zeros(64, dtype=torch.int32)
    with pytest.raises(ValueError, match="no real pointer"):
        lib.repro_decode_attention(1, 1, real.data_ptr(), *[0] * 29)
    with pytest.raises(ValueError, match="no real pointer"):
        lib.repro_decode_attention(1, 1, 0x7F00_0000_0000, *[0] * 29)
    # a meta view's pointer is its byte offset: accepted, recorded, nothing launched
    view = _meta(4, 80)[1:]
    assert lib.repro_decode_attention(1, 1, view.data_ptr(), *[0] * 29) == 0
    assert lib.calls[-1][1][2] == 320
    assert lib.repro_selective_scan_chunk() == 8  # kStateStride of csrc/selective_scan.cuh
    sink = _Sink()
    with _build.trace(sink):
        assert _build.on_card(META)
        with pytest.raises(RuntimeError, match="inside a trace"):
            _build.on_card(torch.device("cuda"))
    assert not _build.on_card(META)


# ------------------------------------------------------------- cost functions
def _attention_pairs(s: int, causal: bool, window) -> int:
    """chip_smoke.py's formula before the cost functions (square masks)."""
    qpos = np.arange(s)
    hi = qpos + 1 if causal else np.full(s, s)
    lo = np.maximum(0, qpos - window + 1) if window is not None else np.zeros(s, np.int64)
    return int((hi - lo).sum())


def _bound(nbytes, *ops) -> float:
    """The larger of the bytes at 3.35 TB/s and each (operations, rate)."""
    return max([nbytes / 3.35e12] + [n / rate for n, rate in ops]) * 1e3


def test_cost_functions_equal_the_formulas_they_replaced():
    """Each bound at the shapes chip_smoke.py times, from the cost
    function and from the formula it replaced (K3: a Gemma3-1B prefill,
    DeepSeek-V2's MLA, whisper's cross layer; K3's backward: a Gemma3-1B
    training step; K4: a Gemma3-1B decode step; K6: hymba's prefill layer
    and decode step; K6's backward: hymba's training layer)."""
    bf16, bf16_peak, f32_peak, sfu = torch.bfloat16, 989e12, 67e12, 132 * 16 * 1.98e9
    b, s, h, kvh, d = 4, 2048, 4, 1, 256
    layers = ((None, 4), (512, 22))
    cost = sum((n * fa_ops.flash_attention_cost(b, s, s, h, kvh, d, d, True, w, bf16) for w, n in layers[1:]),
               4 * fa_ops.flash_attention_cost(b, s, s, h, kvh, d, d, True, None, bf16))
    flops = sum(n * 4.0 * d * _attention_pairs(s, True, w) * b * h for w, n in layers)
    old = _bound(26 * (2 * b * s * h * d + 2 * b * s * kvh * d) * 2, (flops, bf16_peak))
    assert cost.bound_ms()[0] == pytest.approx(old, rel=1e-12) and round(old, 4) == 0.4735

    s = 1024
    cost = sum((n * fa_ops.flash_attention_bwd_cost(b, s, s, h, kvh, d, d, True, w, bf16) for w, n in layers[1:]),
               4 * fa_ops.flash_attention_bwd_cost(b, s, s, h, kvh, d, d, True, None, bf16))
    flops = sum(n * 10.0 * d * _attention_pairs(s, True, w) * b * h for w, n in layers)
    old = _bound(26 * (b * s * (4 * h + 4 * kvh) * d * 2 + b * h * s * 4), (flops, bf16_peak))
    assert cost.bound_ms()[0] == pytest.approx(old, rel=1e-12) and round(old, 4) == 0.4454

    (dqk, dv), h = (192, 128), 128
    cost = 4 * fa_ops.flash_attention_cost(b, s, s, h, h, dqk, dv, True, None, bf16)
    old = _bound(4 * b * s * h * (2 * dqk + 2 * dv) * 2, (4 * 2.0 * (dqk + dv) * _attention_pairs(s, True, None) * b * h,
                                                       bf16_peak))
    assert cost.bound_ms()[0] == pytest.approx(old, rel=1e-12) and round(old, 4) == 0.8013
    bwd = fa_ops.flash_attention_bwd_cost(b, s, s, h, h, dqk, dv, True, None, bf16)
    old = _bound(b * s * h * (4 * dqk + 4 * dv) * 2 + b * h * s * 4,
                 (2.0 * (3 * dqk + 2 * dv) * _attention_pairs(s, True, None) * b * h, bf16_peak))
    assert bwd.bound_ms()[0] == pytest.approx(old, rel=1e-12)

    sq, sk, h, d = 224, 1500, 20, 64
    cost = 32 * fa_ops.flash_attention_cost(b, sq, sk, h, h, d, d, False, None, bf16)
    old = _bound(32 * (2 * b * sq * h * d + 2 * b * sk * h * d) * 2, (32 * 4.0 * d * sq * sk * b * h, bf16_peak))
    assert cost.bound_ms()[0] == pytest.approx(old, rel=1e-12) and round(old, 4) == 0.3373
    cross = da_ops.decode_attention_cost(b, sk, h, h, d, None, bf16, bf16, keys=b * sk)
    assert cross.bound_ms()[0] == pytest.approx(_bound(h * b * sk * d * 2 * 2 + 2 * b * h * d * 2 + b * 4,
                                                       (4.0 * h * d * b * sk, bf16_peak)), rel=1e-12)

    s, h, kvh, d = 2112, 4, 1, 256
    lens = 2048 + np.arange(b) * 4
    cost, nbytes, flops = None, 0.0, 0.0
    for w, n in layers:
        keys = int((np.minimum(lens, s) - (np.maximum(0, lens - w) if w else 0)).sum())
        one = n * da_ops.decode_attention_cost(b, s, h, kvh, d, w, bf16, bf16, keys=keys)
        cost = one if cost is None else cost + one
        nbytes += n * (kvh * keys * d * 2 * 2 + 2 * b * h * d * 2 + b * 4)
        flops += n * 4.0 * h * d * keys
    old = _bound(nbytes, (flops, bf16_peak))
    assert cost.bound_ms()[0] == pytest.approx(old, rel=1e-12) and round(old, 4) == 0.0239

    d, n = 3200, 16
    for s, with_h0, want in ((2048, False, 0.1128), (1, True, 0.0006)):
        cost = scan_ops.selective_scan_cost(b, s, d, n, bf16, with_h0, True)
        elems, rows = b * s * d * n, b * s * d
        nbytes = rows * 2 + b * s * (2 * n + 1) * 2 + d * n * 4 + 2 * d * 4 + (b * d * n * 4 if with_h0 else 0)
        nbytes += 2 * rows * 2 + b * d * n * 4
        old = _bound(nbytes, (elems + 2 * rows + 2 * b * s, sfu), (6.0 * elems, f32_peak))
        assert cost.bound_ms()[0] == pytest.approx(old, rel=1e-12) and round(old, 4) == want

    s = 1024
    rows, f32_params = b * s * d, 3 * d * 4 + d * n * 4
    nbytes = (3 * rows * 2 + 2 * b * s * (2 * n + 1) * 2 + b * -(-s // 32) * d * n * 4 + 2 * rows * 2
              + 2 * f32_params)
    old = _bound(nbytes, (b * s * d * n, sfu))
    cost = scan_ops.selective_scan_bwd_cost(b, s, d, n, bf16, False, True)
    assert cost.bound_ms()[0] == pytest.approx(old, rel=1e-12) and round(old, 4) == 0.0501


# --------------------------------------------------------- the role shortcut
def _widened(arch: str):
    """A smoke configuration at head widths the kernels take (the trace
    runs the card's branch, whose kernels have instances of 64-256)."""
    cfg = TC.get_smoke_config(arch)
    if cfg.attn_type == "mla":
        return dataclasses.replace(cfg, nope_head_dim=128, rope_head_dim=64, v_head_dim=128)
    return dataclasses.replace(cfg, head_dim=64)


@pytest.mark.parametrize("arch,shape,seq", [("gemma3-1b", (2, 2), 32), ("gemma3-1b", (4, 4), 32),
                                            ("olmoe-1b-7b", (4, 2), 128)])
def test_role_mesh_equals_a_full_trace(monkeypatch, arch, shape, seq):
    """The training mesh's step traced on the mesh's RoleMesh (3 indices an
    axis) counts what a trace of every device counts, per device: the
    dense step's data shards and model devices, and OLMoE's
    expert-parallel shards (its model axis within the span).  The
    outputs' bytes are left out: the ring pads a buffer to a multiple of
    its group's size."""
    cfg, cell = _widened(arch), InputShape("c", "train", seq, 16)
    mesh = make_mesh(shape, ("data", "model"), H.trace_devices(16))
    short = dryrun.run_cell(cfg, cell, mesh)
    monkeypatch.setattr(specs, "RoleMesh", lambda m: m)
    full = dryrun.run_cell(cfg, cell, mesh)
    assert short["hlo"] == full["hlo"] and short["roofline"] == full["roofline"]
    for key in ("argument_bytes", "temp_bytes", "peak_estimate_bytes", "reference_layout_argument_bytes"):
        assert short["memory"][key] == full["memory"][key], key
    assert short["hlo"]["total_collective_bytes"] > 0


def test_role_mesh_counts_an_expert_parallel_leads_sums(monkeypatch):
    """OLMoE on (2, 4), whose model axis passes the RoleMesh's 3 indices,
    over microbatches: each shard's lead adds up every model device's
    gradients on its own stream, and the RoleMesh's last model device
    stands for the one it leaves out (``_build.counted``).  The trace
    counts what a trace of every device counts — FLOPs, launches,
    collective bytes, argument bytes — and the traffic within 64 bytes
    (scalars the autograd engine makes for each model device's backward,
    counted on the lead; the sums alone were 2.18 MB short).  The bytes
    made are left out: the accumulators the lead makes for the other
    model devices count as its own."""
    cfg, cell = _widened("olmoe-1b-7b"), InputShape("c", "train", 128, 16)
    mesh = make_mesh((2, 4), ("data", "model"), H.trace_devices(8))
    short = dryrun.run_cell(cfg, cell, mesh)
    monkeypatch.setattr(specs, "RoleMesh", lambda m: m)
    full = dryrun.run_cell(cfg, cell, mesh)
    fed = ("traffic_bytes", "temp_bytes")
    assert {k: v for k, v in short["hlo"].items() if k not in fed} == {
        k: v for k, v in full["hlo"].items() if k not in fed}
    assert abs(short["hlo"]["traffic_bytes"] - full["hlo"]["traffic_bytes"]) <= 64
    for key in ("argument_bytes", "reference_layout_argument_bytes"):
        assert short["memory"][key] == full["memory"][key], key


def test_repeated_microbatches_count_as_a_full_loop(monkeypatch):
    """Five microbatches traced as two, the second counted four times, give
    the counts of tracing all five."""
    cfg, cell = _widened("gemma3-1b"), InputShape("c", "train", 32, 20)
    mesh = make_host_mesh(H.trace_devices(1))
    short = dryrun.run_cell(cfg, cell, mesh)
    monkeypatch.setattr(_build, "repeat", lambda n: range(n))
    full = dryrun.run_cell(cfg, cell, mesh)
    assert short["hlo"] == full["hlo"] and short["memory"] == full["memory"]
    assert short["hlo"]["launches"] == {"flash_attention": 60, "flash_attention_bwd": 30}


# ------------------------------------------------------------ full-size cells
def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


@pytest.mark.parametrize("arch,shape", [("gemma3-1b", "train_4k"), ("qwen3-32b", "prefill_32k"),
                                        ("deepseek-v2-236b", "decode_32k")])
def test_full_size_cell_traces_to_its_end(arch, shape):
    """At full size on the 1x1 host mesh: every term finite and positive,
    and the argument bytes those of the leaves the cell places."""
    cfg, cell = TC.get_config(arch), SHAPES[shape]
    rec = dryrun.run_cell(cfg, cell, make_host_mesh(H.trace_devices(1)))
    r = rec["roofline"]
    assert all(np.isfinite(r[k]) for k in ("compute_seconds", "memory_seconds", "collective_seconds"))
    assert r["compute_seconds"] > 0 and r["memory_seconds"] > 0 and r["collective_seconds"] == 0
    assert rec["memory"]["peak_estimate_bytes"] > rec["memory"]["argument_bytes"] > 0
    b, s = cell.global_batch, cell.seq_len
    if cell.kind == "train":
        params = _nbytes(T.TransformerLM(cfg, META, torch.float32).parameters())
        want = 3 * params + 8 + b * (s + 1) * 4  # f32 leaves, m and v; count and step; the int32 tokens
        assert rec["hlo"]["launches"] == {"flash_attention": 2 * 64 * cfg.num_layers,
                                          "flash_attention_bwd": 64 * cfg.num_layers}
    elif cell.kind == "prefill":
        want = _nbytes(T.TransformerLM(cfg, META).parameters()) + b * s * 4
    else:
        cache = D.init_cache(cfg, b, s, device=META)
        want = _nbytes(T.TransformerLM(cfg, META).parameters()) + _nbytes(cache.values()) + 2 * b * 4
    assert rec["memory"]["argument_bytes"] == want
