"""Telemetry and the rendition cache in both packages: the same serving
traffic through the reference's runtime and the port's gives the same
request counters, histogram counts and rendition-cache counters, the same
``metrics_text`` keys, and the same per-request span timeline in the
trace; the cache alone, fed one admission sequence, makes the same
admit/evict/hit decisions."""

import json
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.runtime as R  # noqa: E402
import repro_torch.runtime as T  # noqa: E402
from repro.runtime.rendition_cache import RenditionCache as RCache  # noqa: E402
from repro_torch.runtime.rendition_cache import RenditionCache as TCache  # noqa: E402

from test_torch_runtime import _runtimes, images  # noqa: E402,F401

TIMEOUT = 60.0


def _extra(pkg):
    return {"telemetry": pkg.TelemetryConfig(spans=True),
            "tenants": (pkg.TenantConfig("a", weight=2.0), pkg.TenantConfig("b")),
            "memory": pkg.MemoryConfig(rendition_cache_bytes=1 << 22)}


def _metric_keys(text):
    """Series names with their labels; a bucket's finite ``le`` bound
    depends on the latency measured, so only its family is kept."""
    keys = set()
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        series = line.rsplit(" ", 1)[0]
        keys.add(re.sub(r',le="[0-9.e+-]+"', ',le=<bound>', series))
    return keys


def _counter_values(text):
    """Counter series whose value is a count of events, not a time."""
    out = {}
    for line in text.splitlines():
        series, _, value = line.rpartition(" ")
        if series.startswith(("smol_requests_total", "smol_rendition_cache_events_total",
                              "smol_programs_compiled_post_warmup_total",
                              "smol_program_cache_events_total")) or (
                series.startswith("smol_stage_latency_seconds_count")):
            out[series] = value
    return out


def _serve_twice(rt, corpus, pkg):
    names = ["ab"[i % 2] for i in range(len(corpus))]
    rt.start_serving()
    try:
        done = []
        for _ in range(2):  # the second pass hits the cache
            for name, item in zip(names, corpus):
                rt.submit(pkg.ClassificationQuery(item), tenant=name)
            rt.flush(timeout=TIMEOUT)
            done += rt.drain(timeout=TIMEOUT)
        stats = rt.stats()
    finally:
        rt.stop_serving()
    assert len(done) == 2 * len(corpus) and not any(d.error for d in done)
    return done, stats, rt.metrics_text()


@pytest.mark.parametrize("split_decode", ["off", "full"])
def test_counters_and_metrics_keys_match_reference(images, split_decode):
    r_rt, t_rt, r_corpus, t_corpus = _runtimes(images, _extra, split_decode=split_decode)
    r_done, r_stats, r_text = _serve_twice(r_rt, r_corpus, R)
    t_done, t_stats, t_text = _serve_twice(t_rt, t_corpus, T)
    assert _metric_keys(t_text) == _metric_keys(r_text)
    assert _counter_values(t_text) == _counter_values(r_text)
    for name in ("a", "b"):
        for field in ("submitted", "completed", "failed", "rejected"):
            assert getattr(t_stats.tenants[name].stats, field) == getattr(
                r_stats.tenants[name].stats, field)
    assert set(t_stats.latency.stages) == set(r_stats.latency.stages)
    for stage, summary in r_stats.latency.stages.items():
        assert t_stats.latency.stages[stage].count == summary.count
    tc, rc = t_stats.cache, r_stats.cache
    assert (tc.hits, tc.misses, tc.admitted, tc.rejected, tc.evictions, tc.resident_entries) == (
        rc.hits, rc.misses, rc.admitted, rc.rejected, rc.evictions, rc.resident_entries)
    assert tc.resident_bytes == rc.resident_bytes and tc.hits == len(t_corpus)
    assert {n: (t.hits, t.misses) for n, t in tc.tenants.items()} == {
        n: (t.hits, t.misses) for n, t in rc.tenants.items()}
    for a, b in zip(t_done, r_done):
        np.testing.assert_allclose(a.scores, np.asarray(b.scores), rtol=0, atol=1e-4)


def _request_spans(path):
    events = json.loads(path.read_text())
    if isinstance(events, dict):
        events = events["traceEvents"]
    procs = {e["pid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    spans = sorted(
        (e["name"], e["args"].get("uid"))
        for e in events
        if e.get("ph") == "X" and procs.get(e.get("pid"), "").startswith("tenant")
    )
    return spans, set(procs.values())


def test_trace_holds_the_same_request_spans(tmp_path, images):
    r_rt, t_rt, r_corpus, t_corpus = _runtimes(images, _extra)
    out = []
    for rt, corpus, pkg, name in ((r_rt, r_corpus, R, "r"), (t_rt, t_corpus, T, "t")):
        _serve_twice(rt, corpus[:8], pkg)
        path = tmp_path / f"{name}.json"
        assert rt.dump_trace(str(path)) > 0
        out.append(_request_spans(path))
    (r_spans, r_procs), (t_spans, t_procs) = out
    assert t_spans == r_spans and len(t_spans) > 0
    assert t_procs == r_procs


def test_rendition_cache_decisions_match_reference():
    rng = np.random.default_rng(4)
    arrays = [rng.integers(0, 255, size=(16, 16, 3), dtype=np.uint8) for _ in range(12)]
    caches = [RCache(R.MemoryBudget(4096, name="rendition_cache")),
              TCache(T.MemoryBudget(4096, name="rendition_cache"))]
    trace = [[], []]
    # a stream of puts with mixed costs (utilities) and repeated gets:
    # 768-byte entries, 5 fit; cheap newcomers must not evict dearer ones
    for step, arr in enumerate(arrays):
        key = ("coeff", ("uid", step), "fmt", "packed")
        cost = 1e-3 * (1 + (step * 7) % 5)
        for i, cache in enumerate(caches):
            trace[i].append(cache.put(key, arr, cost, tenant="t"))
            for back in range(max(0, step - 3), step + 1):
                hit = cache.get(("coeff", ("uid", back), "fmt", "packed"), tenant="t")
                trace[i].append(hit is not None)
    assert trace[1] == trace[0]
    rs, ts = caches[0].stats(), caches[1].stats()
    for field in ("hits", "misses", "evictions", "admitted", "rejected",
                  "resident_bytes", "resident_entries", "capacity_bytes", "bytes_saved"):
        assert getattr(ts, field) == getattr(rs, field), field
    assert ts.evictions > 0 and ts.hits > 0
