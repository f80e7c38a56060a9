"""The port's ``ProgramSet`` against ``repro``'s on the same inputs: bucket
enumeration, the smallest covering bucket, readiness while a background
warm is running, and what ``warm()`` warms — then a ragged-tail ``run()``
under ``warmup="lazy"`` and ``"full"`` against the reference (logits
within 1e-4, identical argmax).  On the CPU a warm runs each bucket's
program once, as the reference's does; the CUDA graph a warm captures on
the card is ``chip_smoke.py``'s to check.  Also: a failed warm is recorded
and counted, never hidden, and a failure on the caller's thread raises."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.runtime as R  # noqa: E402
import repro_torch.runtime as T  # noqa: E402
from repro.core import device_compiler as RDC  # noqa: E402
from repro_torch.core import device_compiler as TDC  # noqa: E402

from test_torch_runtime import _runtimes, images  # noqa: E402,F401

BATCH_SIZES = [1, 3, 4, 12, 32, 64]


class _FakeProg:
    """Stand-in program: the bucket algebra never inspects values."""

    def __init__(self, bucket, dispatched=1, warming=False):
        self.key = ("fake", bucket)
        self.dispatch_count = dispatched
        self._warming = warming


def _sets(buckets, require_ready=False, states=None):
    states = states or {}
    out = []
    for dc in (RDC, TDC):
        progs = {b: _FakeProg(b, *states.get(b, (1, False))) for b in buckets}
        out.append(dc.ProgramSet(programs=progs, require_ready=require_ready))
    return out


@pytest.mark.parametrize("batch_size", BATCH_SIZES)
def test_buckets_and_covering_bucket_match_reference(batch_size):
    assert TDC.batch_buckets(batch_size) == RDC.batch_buckets(batch_size)
    r_ps, t_ps = _sets(TDC.batch_buckets(batch_size))
    assert t_ps.buckets == r_ps.buckets and t_ps.max_batch == r_ps.max_batch
    for n in range(1, batch_size + 2):
        assert t_ps.bucket_for(n) == r_ps.bucket_for(n)
        r_hit, t_hit = r_ps.program_for(n), t_ps.program_for(n)
        assert (t_hit is None) == (r_hit is None)
        if t_hit is not None:
            assert t_hit[1] == r_hit[1] and t_hit[0].key == r_hit[0].key


@pytest.mark.parametrize("batch_size", [4, 12, 64])
def test_readiness_while_warming_matches_reference(batch_size):
    buckets = TDC.batch_buckets(batch_size)
    # the largest bucket warm, one mid-warm, the rest not yet dispatched
    states = {b: (0, False) for b in buckets}
    states[buckets[-1]] = (1, False)
    if len(buckets) > 2:
        states[buckets[1]] = (1, True)
    r_ps, t_ps = _sets(buckets, require_ready=True, states=states)
    assert t_ps.fully_warm == r_ps.fully_warm is False
    for n in range(1, batch_size + 1):
        r_hit, t_hit = r_ps.program_for(n), t_ps.program_for(n)
        assert t_hit[1] == r_hit[1] == buckets[-1]  # falls forward to the warm bucket


def _linear_programs(dc, bucket_sizes, model_fn, device_kw):
    from repro_torch.preprocessing.ops import TensorMeta as TMeta
    from repro.preprocessing.ops import TensorMeta as RMeta

    meta = (TMeta if dc is TDC else RMeta)((4, 4, 3), "float32", "HWC")
    return {
        b: dc.compile_device_program([], meta, model_fn, b, **device_kw)
        for b in bucket_sizes
    }


@pytest.mark.parametrize("batch_size", [4, 12])
def test_warm_warms_the_same_buckets_as_reference(batch_size):
    buckets = TDC.batch_buckets(batch_size)
    w = np.random.default_rng(0).normal(size=(48, 5)).astype(np.float32)
    r_progs = _linear_programs(RDC, buckets, lambda x: x.reshape(x.shape[0], -1) @ w, {})
    tw = torch.from_numpy(w)
    t_progs = _linear_programs(TDC, buckets, lambda x: x.reshape(x.shape[0], -1) @ tw,
                               {"device": "cpu"})
    r_ps = RDC.ProgramSet(programs=r_progs, require_ready=True)
    t_ps = TDC.ProgramSet(programs=t_progs, require_ready=True)
    # the facade's startup: the largest bucket first, then the rest
    assert t_ps.warm(buckets=(batch_size,)) == r_ps.warm(buckets=(batch_size,)) == 1
    assert t_ps.fully_warm == r_ps.fully_warm is False
    assert t_ps.program_for(1)[1] == r_ps.program_for(1)[1] == batch_size
    assert t_ps.warm() == r_ps.warm() == len(buckets) - 1
    assert t_ps.fully_warm and r_ps.fully_warm
    assert t_ps.warm() == r_ps.warm() == 0  # nothing left to warm
    assert [p.dispatch_count for p in t_ps.programs.values()] == [
        p.dispatch_count for p in r_ps.programs.values()
    ]
    assert t_ps.graphs() == {}  # a CPU warm captures no graph
    x = np.random.default_rng(1).normal(size=(batch_size, 4, 4, 3)).astype(np.float32)
    np.testing.assert_allclose(t_ps.programs[batch_size](x).numpy(),
                               np.asarray(r_ps.programs[batch_size](x)), rtol=0, atol=1e-5)


def test_failed_warm_is_recorded_and_the_bucket_falls_forward():
    calls = []

    def model(x):
        calls.append(x.shape[0])
        if x.shape[0] == 2:
            raise RuntimeError("bucket 2 failed")
        return x.reshape(x.shape[0], -1).sum(1, keepdim=True)

    progs = _linear_programs(TDC, (1, 2, 4), model, {"device": "cpu"})
    ps = TDC.ProgramSet(programs=progs, require_ready=True)
    with pytest.raises(RuntimeError, match="bucket 2 failed"):
        ps.warm()
    assert calls == [4, 2, 1]  # largest first; a failure does not stop the pass
    assert [b for b, _ in ps.failures] == [2]
    assert not ps.fully_warm
    assert ps.program_for(1)[1] == 1
    assert ps.program_for(2)[1] == 4  # the failed bucket stays unready


@pytest.mark.parametrize("warmup", ["lazy", "full"])
@pytest.mark.parametrize("n_items", [10, 13])
def test_ragged_tail_run_matches_reference(images, warmup, n_items):
    r_rt, t_rt, r_corpus, t_corpus = _runtimes(
        images, lambda pkg: {"warmup": warmup}, split_decode="full")
    r_outs, _ = r_rt.run(r_corpus[:n_items])
    t_outs, report = t_rt.run(t_corpus[:n_items])
    assert report.stats.batches == -(-n_items // 4)
    for a, b in zip(t_outs, r_outs):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-4)
        assert np.argmax(a) == np.argmax(b)
    t_ps, r_ps = t_rt.compile().program_sets[0], r_rt.compile().program_sets[0]
    assert t_ps.buckets == r_ps.buckets == (1, 2, 4)
    if warmup == "full":
        assert t_rt.wait_warm(timeout=60.0) and r_rt.wait_warm(timeout=60.0)
        assert t_ps.fully_warm and r_ps.fully_warm
        stats = t_rt.stats().warmup
        assert stats.mode == "full" and stats.ready == (1, 2, 4) and stats.failures == 0
    tail = t_ps.bucket_for(n_items % 4)
    # the tail's covering bucket ran (under "lazy" only the tail runs it)
    assert t_ps.programs[tail].dispatch_count >= 1
    assert r_ps.programs[tail].dispatch_count >= 1


def test_warmup_full_serving_never_compiles_after_start(images):
    rts = _runtimes(images, lambda pkg: {"warmup": "full"}, split_decode="full")
    for rt, corpus, pkg in ((rts[0], rts[2], R), (rts[1], rts[3], T)):
        rt.start_serving()
        try:
            assert rt.wait_warm(timeout=60.0)
            for item in corpus[:11]:
                rt.submit(pkg.ClassificationQuery(item))
            rt.flush(timeout=60.0)
            done = rt.drain(timeout=60.0)
        finally:
            rt.stop_serving()
        assert len(done) == 11 and not any(r.error for r in done)
        assert rt.programs_compiled_post_warmup == 0
        assert "smol_programs_compiled_post_warmup_total 0" in rt.metrics_text()
    assert rts[1].stats().program_cache.pinned == rts[0].stats().program_cache.pinned == 3


def test_background_warm_failure_is_counted_in_stats(images, monkeypatch):
    _, t_rt, _, t_corpus = _runtimes(images, lambda pkg: {"warmup": "full"}, split_decode="full")
    original = TDC.ProgramSet.warm

    def warm(self, buckets=None):
        if buckets is None:  # the background pass: bucket 2 fails
            self.programs[2].fn = lambda batch: (_ for _ in ()).throw(RuntimeError("no graph"))
        return original(self, buckets)

    monkeypatch.setattr(TDC.ProgramSet, "warm", warm)
    t_rt.start_serving()
    try:
        assert t_rt.wait_warm(timeout=60.0)
        for item in t_corpus[:2]:  # a batch of 2 falls forward to bucket 4
            t_rt.submit(T.ClassificationQuery(item))
        t_rt.flush(timeout=60.0)
        done = t_rt.drain(timeout=60.0)
    finally:
        t_rt.stop_serving()
    assert len(done) == 2 and not any(r.error for r in done)
    stats = t_rt.stats().warmup
    assert stats.failures == 1 and "bucket 2: RuntimeError: no graph" in stats.errors[0]
    assert 2 not in stats.ready and not stats.fully_warm


def test_warm_failure_on_the_callers_thread_raises(images, monkeypatch):
    _, t_rt, _, _ = _runtimes(images, lambda pkg: {"warmup": "full"}, split_decode="full")

    def warm(self, buckets=None):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(TDC.ProgramSet, "warm", warm)
    with pytest.raises(RuntimeError, match="capture failed"):
        t_rt.compile()


def test_release_drops_the_graphs_no_set_still_pins():
    progs = {b: _FakeProg(b) for b in (1, 2)}
    for p in progs.values():
        p.graph = object()
    ps = TDC.ProgramSet(programs=progs)
    ps.release(keep=lambda p: p.key == ("fake", 2))
    assert progs[1].graph is None and progs[2].graph is not None
