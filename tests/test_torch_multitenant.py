"""Multi-tenant serving in both packages: one scenario through the
reference's ``RequestScheduler`` and the port's with the same fake device
function, then the facade with a model-pinned tenant.

The WFQ (weighted fair queueing) scenario is made deterministic: the one
host worker waits at a gate until every request is queued, and batches
close only when full (a long ``max_wait_ms``), so both schedulers must form
the same batches — the same per-tenant dispatch counts, batch by batch."""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.runtime as R  # noqa: E402
import repro_torch.runtime as T  # noqa: E402

from test_torch_runtime import _runtimes, images  # noqa: E402,F401

TIMEOUT = 30.0


def _wfq_batches(pkg, weights, n_each=16):
    """Batches the scheduler of ``pkg`` dispatches, as (tenant, item) rows."""
    gate = threading.Event()
    batches = []

    def host_fn(item):
        gate.wait(TIMEOUT)
        return np.full((4,), float(item), np.float32)

    def device_fn(batch):
        batches.append([int(v) for v in np.asarray(batch)[:, 0]])
        time.sleep(0.005)
        return batch

    tenants = [pkg.TenantConfig(name, weight=w) for name, w in zip(("gold", "bronze"), weights)]
    sched = pkg.RequestScheduler(host_fn, device_fn, (4,), np.float32, max_batch=4,
                                 num_workers=1, max_wait_ms=5_000.0, tenants=tenants)
    sched.start()
    try:
        for i in range(n_each):
            sched.submit(i, tenant="gold")
            sched.submit(100 + i, tenant="bronze")
        gate.set()
        sched.flush(timeout=TIMEOUT)
        done = sched.drain(timeout=TIMEOUT)
    finally:
        sched.stop()
    assert len(done) == 2 * n_each and not any(d.error for d in done)
    return [[("bronze" if v >= 100 else "gold", v) for v in b] for b in batches]


@pytest.mark.parametrize("weights", [(4.0, 1.0), (1.0, 1.0), (2.0, 1.0)])
def test_wfq_dispatches_match_reference(weights):
    r_batches = _wfq_batches(R, weights)
    t_batches = _wfq_batches(T, weights)
    assert t_batches == r_batches
    counts = [sum(t == "gold" for t, _ in b) for b in t_batches]
    # while both tenants are backlogged, gold holds its weight's share
    share = weights[0] / sum(weights)
    head = t_batches[: len(t_batches) // 2]
    gold = sum(counts[: len(head)])
    assert abs(gold / (4 * len(head)) - share) <= 0.15


def _saturation(pkg, **tenant_kw):
    sched = pkg.RequestScheduler(
        lambda item: (time.sleep(0.2), np.full((4,), float(item), np.float32))[1],
        lambda batch: batch, (4,), np.float32, max_batch=4, num_workers=2,
        max_wait_ms=1.0, admission="reject",
        tenants=[pkg.TenantConfig("a", **tenant_kw["a"]), pkg.TenantConfig("b", **tenant_kw["b"])],
        **tenant_kw.get("sched", {}))
    sched.start()
    rejected = []
    try:
        sched.submit(1, tenant="a")
        with pytest.raises(pkg.SchedulerSaturated, match="'a'"):
            sched.submit(2, tenant="a")
        rejected.append("a")
        for i in range(3):
            sched.submit(10 + i, tenant="b")  # unaffected by a's saturation
        sched.flush(timeout=TIMEOUT)
    finally:
        sched.stop()
    done = sched.drain(timeout=TIMEOUT)
    return (rejected, sorted(d.tenant for d in done),
            {n: (s.rejected, s.completed) for n, s in sched.tenants.items()})


@pytest.mark.parametrize("quota", ["max_pending", "budget_bytes"])
def test_bursting_tenant_saturates_alone_like_reference(quota):
    if quota == "max_pending":
        kw = {"a": {"max_pending": 1}, "b": {"max_pending": 8}}
    else:  # an item is 16 bytes: a's quota holds one
        kw = {"a": {"budget_bytes": 16}, "b": {"budget_bytes": 1024}}
    r_kw, t_kw = dict(kw), dict(kw)
    if quota == "budget_bytes":
        r_kw["sched"] = {"budget": R.MemoryBudget(4096)}
        t_kw["sched"] = {"budget": T.MemoryBudget(4096)}
    assert _saturation(T, **t_kw) == _saturation(R, **r_kw)


def test_facade_tenants_match_reference(images):
    def extra(pkg):
        return {"tenants": (pkg.TenantConfig("gold", weight=4.0, floor_bytes=1 << 20),
                            pkg.TenantConfig("pinned", weight=1.0, model="slow")),
                "memory": pkg.MemoryConfig(budget_bytes=1 << 22, max_pending=32)}

    r_rt, t_rt, r_corpus, t_corpus = _runtimes(images, extra)
    results = []
    for rt, corpus, pkg in ((r_rt, r_corpus, R), (t_rt, t_corpus, T)):
        rt.start_serving()
        try:
            names = ["gold" if i % 2 else "pinned" for i in range(len(corpus))]
            for name, item in zip(names, corpus):
                rt.submit(pkg.ClassificationQuery(item), tenant=name)
            rt.flush(timeout=TIMEOUT)
            done = rt.drain(timeout=TIMEOUT)
            stats = rt.stats()
            rt.serving_recalibrate("pinned")
            assert rt.recalibrations[-1].tenant == "pinned"
        finally:
            rt.stop_serving()
        assert [d.tenant for d in done] == names and not any(d.error for d in done)
        results.append((done, stats))
    (r_done, r_stats), (t_done, t_stats) = results
    for name in ("gold", "pinned"):
        assert t_stats.tenants[name].plan == r_stats.tenants[name].plan
        assert t_stats.tenants[name].stats.completed == r_stats.tenants[name].stats.completed
    assert t_stats.tenants["pinned"].plan.startswith("slow@")
    assert t_stats.tenants["gold"].budget.floor_bytes == 1 << 20
    assert t_stats.program_cache.misses == r_stats.program_cache.misses == 2
    for a, b in zip(t_done, r_done):
        np.testing.assert_allclose(a.scores, np.asarray(b.scores), rtol=0, atol=1e-4)
        assert a.prediction == b.prediction


def test_unknown_pinned_model_and_duplicate_tenants_raise(images):
    with pytest.raises(ValueError, match="unknown models"):
        _runtimes(images, lambda pkg: (  # the reference's runtime builds first, unpinned
            {"tenants": (pkg.TenantConfig("t", model="missing"),)} if pkg is T else {}))
    with pytest.raises(ValueError, match="duplicate"):
        T.RuntimeConfig(tenants=(T.TenantConfig("a"), T.TenantConfig("a")))
    with pytest.raises(ValueError, match="weight"):
        T.TenantConfig("free", weight=0.0)
