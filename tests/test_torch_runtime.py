"""``SmolRuntime.run`` in both packages on the setup of
``tests/test_runtime.py``: same corpus bytes, same linear-model weights,
decode time, entropy-stage time and dispatch overhead pinned so both plan
alike; then the same
plan key, identical argmax and logits within 1e-4 — also with warmup,
recalibration, tenants, telemetry and the rendition cache on, and through
a serving round trip.  The replica mesh is held in
``tests/test_torch_mesh.py``.

``_runtimes`` is the shared set-up of the ``tests/test_torch_*`` files
that hold the runtime against the reference."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import repro.runtime as R  # noqa: E402
import repro_torch.runtime as T  # noqa: E402

from conftest import smooth_image  # noqa: E402
from repro.core.planner import ModelSpec as RModelSpec  # noqa: E402
from repro.preprocessing.formats import ImageFormat as RFormat  # noqa: E402
from repro.preprocessing.formats import StoredImage as RStored  # noqa: E402
from repro.runtime import DeviceCompilerConfig as RDevCfg  # noqa: E402
from repro.runtime import RuntimeConfig as RConfig  # noqa: E402
from repro.runtime import SmolRuntime as RRuntime  # noqa: E402
from repro_torch.core.planner import ModelSpec as TModelSpec  # noqa: E402
from repro_torch.preprocessing.formats import ImageFormat as TFormat  # noqa: E402
from repro_torch.preprocessing.formats import StoredImage as TStored  # noqa: E402
from repro_torch.runtime import DeviceCompilerConfig as TDevCfg  # noqa: E402
from repro_torch.runtime import RuntimeConfig as TConfig  # noqa: E402
from repro_torch.runtime import SmolRuntime as TRuntime  # noqa: E402

INPUT = 32
FMT_ARGS = {"full": ("jpeg", None, 95), "thumb": ("jpeg", 48, 75)}


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(3)
    return [smooth_image(rng, 80, 80) for _ in range(20)]


def _weights(seed, classes=7):
    return np.array(  # a writable copy: torch.from_numpy shares memory
        jax.random.normal(jax.random.PRNGKey(seed), (3 * INPUT * INPUT, classes)) * 0.02
    )


def _runtimes(images, extra=None, **device_cfg):
    """(reference runtime, port runtime, reference corpus, port corpus).

    ``extra(pkg)`` returns further ``RuntimeConfig`` kwargs, built from
    ``pkg`` — ``repro.runtime`` for the reference, ``repro_torch.runtime``
    for the port — so both get the same tenants, telemetry, memory or
    recalibration config."""
    out = []
    for ModelSpec, Format, Stored, Config, DevCfg, Runtime, to_model, pkg in (
        (RModelSpec, RFormat, RStored, RConfig, RDevCfg, RRuntime, lambda w: w, R),
        (TModelSpec, TFormat, TStored, TConfig, TDevCfg, TRuntime, torch.from_numpy, T),
    ):
        full, thumb = Format(*FMT_ARGS["full"]), Format(*FMT_ARGS["thumb"])
        corpus = [Stored.from_array(img, [full, thumb]) for img in images]
        models = [
            ModelSpec("fast", INPUT, exec_throughput=10_000.0,
                      accuracy_by_format={full.key: 0.95, thumb.key: 0.70}),
            ModelSpec("slow", INPUT, exec_throughput=500.0,
                      accuracy_by_format={full.key: 0.97, thumb.key: 0.92}),
        ]
        fns = {}
        for name, seed in (("fast", 0), ("slow", 1)):
            w = to_model(_weights(seed))
            if Runtime is TRuntime:
                # row by row: a CPU matmul's bits can depend on a row's
                # position in the batch (MKL), and tests compare runs bitwise
                fns[name] = lambda x, w=w: torch.stack([r.reshape(-1) @ w for r in x])
            else:
                fns[name] = lambda x, w=w: x.reshape(x.shape[0], -1) @ w
        kw = {"device": "cpu"} if Runtime is TRuntime else {}
        rt = Runtime(
            models, [full, thumb], fns, calibration=corpus[:3],
            config=Config(batch_size=4, num_workers=2, min_accuracy=0.9,
                          device=DevCfg(dispatch_overhead_s=0.0, **device_cfg),
                          **(extra(pkg) if extra is not None else {})),
            decode_time=lambda fmt: 1e-4 if fmt.short_side else 2e-3,
            **kw,
        )
        # the split-decode host stage is priced by a measured entropy time:
        # pin it like the decode time, so a loaded CPU cannot flip the plan
        rt._entropy_time_cache.update({full.key: 2e-3, thumb.key: 1e-4})
        out.append((rt, corpus))
    (r_rt, r_corpus), (t_rt, t_corpus) = out
    return r_rt, t_rt, r_corpus, t_corpus


@pytest.mark.parametrize("split_decode", ["off", "full"])
def test_run_matches_reference(images, split_decode):
    r_rt, t_rt, r_corpus, t_corpus = _runtimes(images, split_decode=split_decode)
    r_outs, r_report = r_rt.run(r_corpus)
    t_outs, t_report = t_rt.run(t_corpus)
    assert t_report.plan_key == r_report.plan_key == "fast@jpeg_full_q95"
    compiled = t_rt.compile()
    assert (compiled.coeff is not None) == (split_decode == "full")
    assert compiled.placement.split == r_rt.compile().placement.split
    assert t_report.stats.num_items == len(t_corpus)
    assert t_report.stats.batches == r_report.stats.batches == 5
    for a, b in zip(t_outs, r_outs):
        assert a.shape == (7,)
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-4)
        assert np.argmax(a) == np.argmax(b)


def test_plans_and_pareto_match_reference(images):
    r_rt, t_rt, _, _ = _runtimes(images)
    assert [p.key for p in t_rt.pareto()] == [p.key for p in r_rt.pareto()]
    assert t_rt.plan().key == r_rt.plan().key
    assert t_rt.plan().placement.split == r_rt.plan().placement.split


def test_synchronous_staging_engine_matches_double_buffered(images):
    _, t_rt, _, t_corpus = _runtimes(images)
    outs_db, _ = t_rt.run(t_corpus)
    t_rt.config.double_buffer = False
    t_rt.compile().engine = None
    outs_sync, report = t_rt.run(t_corpus)
    assert report.stats.batches == 5
    for a, b in zip(outs_db, outs_sync):
        np.testing.assert_array_equal(a, b)


def test_engine_measurement_protocol_on_cpu():
    # paper §8.2: preproc-only, exec-only and pipelined throughput of a plan
    from repro_torch.core.engine import measure_plan

    w = torch.ones((4 * 4, 3))
    rates = measure_plan(
        lambda item: np.full((4, 4), item, np.float32),
        lambda batch: torch.from_numpy(np.asarray(batch)).reshape(len(batch), -1) @ w,
        list(range(10)), (4, 4), np.float32, batch_size=4, num_workers=2, device="cpu",
    )
    assert set(rates) == {"preproc", "exec", "pipelined"}
    assert all(r > 0 for r in rates.values())


def test_measure_exec_throughput_on_cpu():
    w = torch.zeros((3 * 8 * 8, 2))
    rate = TRuntime.measure_exec_throughput(
        lambda x: x.reshape(x.shape[0], -1) @ w, 8, batch_size=4, iters=2, device="cpu")
    assert rate > 0


def _assert_same_outputs(t_outs, r_outs, atol=1e-4):
    assert len(t_outs) == len(r_outs)
    for a, b in zip(t_outs, r_outs):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol)
        assert np.argmax(a) == np.argmax(b)


@pytest.mark.parametrize(
    "feature,extra",
    [
        ("recalibration", lambda pkg: {"recal": pkg.RecalConfig(every=8)}),
        ("warmup", lambda pkg: {"warmup": "full"}),
        ("tenants", lambda pkg: {"tenants": (pkg.TenantConfig("a", weight=4.0),
                                             pkg.TenantConfig("b"))}),
        ("telemetry", lambda pkg: {"telemetry": pkg.TelemetryConfig(spans=True)}),
        ("rendition cache", lambda pkg: {"memory": pkg.MemoryConfig(rendition_cache_bytes=1 << 22)}),
    ],
)
def test_ported_features_run_like_the_reference(images, feature, extra):
    r_rt, t_rt, r_corpus, t_corpus = _runtimes(images, extra, split_decode="full")
    tenants = ["ab"[i % 2] for i in range(len(r_corpus))] if feature == "tenants" else None
    r_outs, r_report = r_rt.run(r_corpus, tenants=tenants)
    t_outs, t_report = t_rt.run(t_corpus, tenants=tenants)
    assert t_report.plan_key == r_report.plan_key
    assert len(t_report.recalibrations) == len(r_report.recalibrations)
    assert [c.num_items for c in t_report.chunk_stats] == [
        c.num_items for c in r_report.chunk_stats
    ]
    _assert_same_outputs(t_outs, r_outs)
    if feature == "warmup":
        assert t_rt.wait_warm(timeout=60.0) and r_rt.wait_warm(timeout=60.0)
        assert t_rt.compile().program_sets[0].buckets == r_rt.compile().program_sets[0].buckets
        assert t_rt.stats().warmup.failures == 0
    if feature == "rendition cache":
        # a second pass hits every staged tensor in both packages
        _assert_same_outputs(t_rt.run(t_corpus)[0], r_rt.run(r_corpus)[0])
        assert t_rt.stats().cache.hits == r_rt.stats().cache.hits > 0


def test_serving_methods_raise_and_cuda_is_the_default(images, monkeypatch):
    # before start_serving() the serving methods raise, as the reference's
    r_rt, t_rt, r_corpus, t_corpus = _runtimes(images)
    for rt, item in ((r_rt, R.ClassificationQuery(r_corpus[0])),
                     (t_rt, T.ClassificationQuery(t_corpus[0]))):
        for call in (lambda: rt.submit(item), rt.drain):
            with pytest.raises(RuntimeError, match="start_serving"):
                call()
    # a serving round trip: every item as a classification query, the same
    # scores as the reference's round trip
    results = []
    for rt, corpus, pkg in ((r_rt, r_corpus, R), (t_rt, t_corpus, T)):
        rt.start_serving()
        try:
            uids = [rt.submit(pkg.ClassificationQuery(item)) for item in corpus]
            rt.flush(timeout=60.0)
            done = rt.drain(timeout=60.0)
        finally:
            rt.stop_serving()
        assert [r.uid for r in done] == uids and not any(r.error for r in done)
        results.append(done)
    r_done, t_done = results
    _assert_same_outputs([r.scores for r in t_done], [r.scores for r in r_done])
    assert [r.prediction for r in t_done] == [r.prediction for r in r_done]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fmt = TFormat(*FMT_ARGS["full"])
    corpus = [TStored.from_array(images[0], [fmt])]
    spec = TModelSpec("m", INPUT, exec_throughput=1.0, accuracy_by_format={fmt.key: 1.0})
    with pytest.raises(RuntimeError, match="cuda"):
        TRuntime([spec], [fmt], {"m": lambda x: x}, corpus)
