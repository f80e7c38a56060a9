"""Typed queries on the port's serving path against ``repro``'s, on the
set-up of ``tests/test_query_api.py``: flat bright images score class 0
with near-1.0 confidence, dark ones argmax to class 1 at ~1/6, so a 0.6
cascade threshold splits them the same way in both packages.  The same
queries go through both runtimes; classification argmax equal and scores
within 1e-4, cascade exit stages and refetch flags equal, aggregation
estimates within 1e-6 on the same seed."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.runtime as R  # noqa: E402
import repro_torch.runtime as T  # noqa: E402
from repro.core.planner import ModelSpec as RModelSpec  # noqa: E402
from repro.preprocessing.formats import ImageFormat as RFormat  # noqa: E402
from repro.preprocessing.formats import StoredImage as RStored  # noqa: E402
from repro_torch.core.planner import ModelSpec as TModelSpec  # noqa: E402
from repro_torch.preprocessing.formats import ImageFormat as TFormat  # noqa: E402
from repro_torch.preprocessing.formats import StoredImage as TStored  # noqa: E402

from conftest import smooth_image  # noqa: E402

INPUT = 32
BRIGHT, DARK = 210, 80
TIMEOUT = 60.0


def _conf_model_jnp(x):
    m = jnp.mean(x, axis=(1, 2, 3))
    z = jnp.zeros((x.shape[0], 7), jnp.float32)
    return z.at[:, 0].set(m * 12.0)


def _conf_model_torch(x):
    m = x.mean(dim=(1, 2, 3))
    z = torch.zeros((x.shape[0], 7), dtype=torch.float32)
    z[:, 0] = m * 12.0
    return z


def _images(n_smooth=4):
    rng = np.random.default_rng(11)
    flat = [np.full((80, 80, 3), v, np.uint8) for v in (BRIGHT, DARK, BRIGHT, DARK, DARK)]
    return flat + [smooth_image(rng, 80, 80) for _ in range(n_smooth)]


def _pair(extra=None, n_smooth=4):
    """[(reference runtime, its corpus, repro.runtime), (port runtime, its
    corpus, repro_torch.runtime)] over the same image bytes."""
    out = []
    for ModelSpec, Format, Stored, model, pkg in (
        (RModelSpec, RFormat, RStored, _conf_model_jnp, R),
        (TModelSpec, TFormat, TStored, _conf_model_torch, T),
    ):
        fmt = Format("jpeg", None, 95)
        corpus = [Stored.from_array(img, [fmt]) for img in _images(n_smooth)]
        calibration = [Stored.from_array(np.full((80, 80, 3), 128, np.uint8), [fmt])
                       for _ in range(3)]
        cfg = pkg.RuntimeConfig(
            batch_size=4, num_workers=2, max_wait_ms=1.0,
            device=pkg.DeviceCompilerConfig(dispatch_overhead_s=0.0),
            **(extra(pkg) if extra is not None else {}))
        kw = {"device": "cpu"} if pkg is T else {}
        rt = pkg.SmolRuntime(
            [ModelSpec("conf", INPUT, exec_throughput=5_000.0,
                       accuracy_by_format={fmt.key: 0.95})],
            [fmt], {"conf": model}, calibration=calibration, config=cfg,
            decode_time=lambda f: 2e-3, **kw)
        rt._entropy_time_cache[fmt.key] = 2e-3  # pinned: plans must not drift
        out.append((rt, corpus, pkg))
    return out


def _serve(rt, submit):
    """Serve what ``submit`` submits; (results, stats taken before stop)."""
    rt.start_serving()
    try:
        uids = submit()
        rt.flush(timeout=TIMEOUT)
        done = rt.drain(timeout=TIMEOUT)
        stats = rt.stats()
    finally:
        rt.stop_serving()
    assert [r.uid for r in done] == uids
    assert not any(r.error for r in done)
    return done, stats


def test_classification_queries_match_reference():
    results = []
    for rt, corpus, pkg in _pair():
        done, _ = _serve(rt, lambda: [rt.submit(pkg.ClassificationQuery(im), tenant="default")
                                      for im in corpus])
        assert all(type(r).__name__ == "ClassificationResult" for r in done)
        results.append(done)
    r_done, t_done = results
    for a, b in zip(t_done, r_done):
        assert a.prediction == b.prediction
        np.testing.assert_allclose(a.scores, np.asarray(b.scores), rtol=0, atol=1e-4)


@pytest.mark.parametrize("cache", [False, True])
def test_cascade_exits_and_refetches_match_reference(cache):
    extra = (lambda pkg: {"memory": pkg.MemoryConfig(rendition_cache_bytes=1 << 22)}) if cache else None
    results = []
    for rt, corpus, pkg in _pair(extra):
        stages = (pkg.CascadeStageSpec(threshold=0.6), pkg.CascadeStageSpec())
        done, stats = _serve(rt, lambda: [rt.submit(pkg.CascadeQuery(im, stages))
                                          for im in corpus])
        results.append((done, stats.cascade))
    (r_done, r_casc), (t_done, t_casc) = results
    assert [(r.exit_stage, r.refetched) for r in t_done] == [
        (r.exit_stage, r.refetched) for r in r_done
    ]
    assert {r.exit_stage for r in t_done} == {0, 1}  # both exits taken
    for a, b in zip(t_done, r_done):
        assert a.prediction == b.prediction
        np.testing.assert_allclose(a.scores, np.asarray(b.scores), rtol=0, atol=1e-4)
    assert t_casc.factor == r_casc.factor and t_casc.refetched_items == r_casc.refetched_items
    assert [s.items for s in t_casc.stages] == [s.items for s in r_casc.stages]


@pytest.mark.parametrize("seed", [0, 5])
def test_aggregation_estimate_matches_reference(seed):
    results = []
    for rt, corpus, pkg in _pair(n_smooth=12):
        rt.start_serving()
        try:
            res = rt.submit(pkg.AggregationQuery(corpus, eps=0.2, delta=0.1, batch=4,
                                                 min_samples=6, seed=seed))
        finally:
            rt.stop_serving()
        results.append(res)
    r_res, t_res = results
    assert abs(t_res.estimate - r_res.estimate) <= 1e-6
    assert abs(t_res.ci_halfwidth - r_res.ci_halfwidth) <= 1e-6
    assert t_res.num_target_invocations == r_res.num_target_invocations
    assert t_res.num_specialized_invocations == r_res.num_specialized_invocations == 17


def test_bare_submit_warns_once_like_reference():
    for rt, corpus, pkg in _pair():
        rt.start_serving()
        try:
            with pytest.warns(DeprecationWarning, match="typed"):
                uids = [rt.submit(im) for im in corpus[:2]]
            rt.flush(timeout=TIMEOUT)
            done = rt.drain(timeout=TIMEOUT)
        finally:
            rt.stop_serving()
        assert [r.uid for r in done] == uids
        assert type(done[0]).__name__ == "CompletedRequest"


def test_vision_serving_engine_matches_reference():
    from repro.serving.vision import VisionServingEngine as RVision
    from repro_torch.serving.vision import VisionServingEngine as TVision

    results = []
    for (rt, corpus, pkg), Vision in zip(_pair(), (RVision, TVision)):
        kw = {"device": "cpu"} if pkg is T else {}
        engine = Vision(rt.models, rt.formats, rt.model_fns, rt.calibration,
                        config=rt.config, decode_time=lambda f: 2e-3, **kw)
        engine.runtime._entropy_time_cache.update(rt._entropy_time_cache)
        with engine:
            uids = [engine.submit(pkg.ClassificationQuery(im)) for im in corpus]
            engine.runtime.flush(timeout=TIMEOUT)
            done = engine.drain(timeout=TIMEOUT)
            plan_key = engine.plan_key
        assert [r.uid for r in done] == uids
        results.append((plan_key, done))
    (r_key, r_done), (t_key, t_done) = results
    assert t_key == r_key
    assert [r.prediction for r in t_done] == [r.prediction for r in r_done]


def test_cascade_stages_match_reference():
    from repro.core import cascade as r_cascade
    from repro_torch.core import cascade as t_cascade

    rng = np.random.default_rng(2)
    batch = rng.normal(size=(16, 6)).astype(np.float32)
    ws = [rng.normal(size=(6, 4)).astype(np.float32) * s for s in (3.0, 1.0)]
    results = []
    for mod, to_param, kw in ((r_cascade, lambda w: w, {}),
                              (t_cascade, torch.from_numpy, {"device": "cpu"})):
        stages = [mod.make_jit_stage(f"s{i}", to_param(w), lambda p, x: x @ p, 0.7, **kw)
                  for i, w in enumerate(ws)]
        results.append(mod.Cascade(stages)(batch))
    r_res, t_res = results
    np.testing.assert_array_equal(t_res.predictions, r_res.predictions)
    np.testing.assert_array_equal(t_res.exit_stage, r_res.exit_stage)
    assert t_res.pass_fractions == r_res.pass_fractions
    assert 0.0 < t_res.pass_fractions[1] < 1.0
