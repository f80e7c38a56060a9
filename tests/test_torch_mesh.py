"""The serving replica mesh in the port: ``replica_groups`` and
``MeshConfig`` against the reference's, ``mesh_devices`` (logical devices,
``REPRO_TORCH_FORCE_DEVICE_COUNT``), the scheduler's replica dispatchers
with events and barriers instead of timed windows, and ``SmolRuntime``
with ``replicas=2``, sharded groups, explicit devices and ``fail_replica``
over 4 logical CPU devices: bitwise the port's single replica, within
1e-5 of the reference's.

Nothing here needs the reference to see 4 JAX devices: its side is always
a single replica (or pure Python over integer lists), so the file runs the
same whichever test file imported ``jax`` first in the worker."""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.runtime as R  # noqa: E402
import repro_torch.runtime as T  # noqa: E402
from repro.distributed.collectives import replica_groups as r_replica_groups  # noqa: E402
from repro_torch import device as D  # noqa: E402
from repro_torch.core import device_compiler as TDC  # noqa: E402
from repro_torch.distributed.collectives import replica_groups as t_replica_groups  # noqa: E402
from repro_torch.distributed.sharding import batch_sharding, serving_mesh  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.preprocessing.ops import TensorMeta  # noqa: E402
from repro_torch.runtime import scheduler as t_scheduler  # noqa: E402

from test_torch_runtime import _runtimes, images  # noqa: E402,F401

TIMEOUT = 30.0


# ---------------------------------------------------------------- layout
@pytest.mark.parametrize("n,replicas", [(1, 1), (4, 1), (4, 2), (4, 3), (4, 4), (5, 2), (8, 3)])
def test_replica_groups_match_reference(n, replicas):
    devices = list(range(n))
    assert t_replica_groups(devices, replicas) == r_replica_groups(devices, replicas)


@pytest.mark.parametrize("n,replicas", [(4, 0), (2, 3), (0, 1)])
def test_replica_groups_raise_like_reference(n, replicas):
    with pytest.raises(ValueError) as r_err:
        r_replica_groups(list(range(n)), replicas)
    with pytest.raises(ValueError) as t_err:
        t_replica_groups(list(range(n)), replicas)
    assert str(t_err.value) == str(r_err.value)


@pytest.mark.parametrize("kwargs", [{"replicas": 0}, {"replicas": 2, "devices": [0, 1, 1]},
                                    {"replicas": -1, "devices": [0]}])
def test_mesh_config_raises_like_reference(kwargs):
    with pytest.raises(ValueError) as r_err:
        R.MeshConfig(**kwargs)
    with pytest.raises(ValueError) as t_err:
        T.MeshConfig(**kwargs)
    assert str(t_err.value) == str(r_err.value)


def test_mesh_config_normalizes_like_reference():
    for kwargs in ({}, {"replicas": 2, "devices": [0, 1]}, {"replicas": 1, "sharded": True}):
        r, t = R.MeshConfig(**kwargs), T.MeshConfig(**kwargs)
        assert (t.replicas, t.devices, t.sharded) == (r.replicas, r.devices, r.sharded)
    assert T.MeshConfig(replicas=2, devices=[0, 1]).devices == (0, 1)


# -------------------------------------------------------- logical devices
@pytest.mark.parametrize("count", [None, "1", "4"])
def test_mesh_devices_on_the_cpu(monkeypatch, count):
    if count is None:
        monkeypatch.delenv(D.FORCE_DEVICE_COUNT_ENV, raising=False)
    else:
        monkeypatch.setenv(D.FORCE_DEVICE_COUNT_ENV, count)
    devs = D.mesh_devices("cpu")
    n = int(count or 1)
    assert [d.label for d in devs] == [f"cpu:{i}" for i in range(n)]
    assert [d.id for d in devs] == list(range(n))
    assert all(d.device == torch.device("cpu") and d.stream is None for d in devs)
    assert D.mesh_devices("cpu") == devs  # the same objects: a logical device lives on


@pytest.mark.parametrize("raw", ["0", "two"])
def test_forced_count_must_be_positive(monkeypatch, raw):
    monkeypatch.setenv(D.FORCE_DEVICE_COUNT_ENV, raw)
    with pytest.raises(ValueError, match=D.FORCE_DEVICE_COUNT_ENV):
        D.mesh_devices("cpu")


def test_forced_count_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setenv(D.FORCE_DEVICE_COUNT_ENV, "2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        D.mesh_devices("cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        D.mesh_devices()


def test_batch_sharding_splits_in_order(monkeypatch):
    monkeypatch.setenv(D.FORCE_DEVICE_COUNT_ENV, "4")
    devs = D.mesh_devices("cpu")
    sh = batch_sharding(devs[:2])
    assert sh.devices == tuple(devs[:2]) and sh.device_set == frozenset(devs[:2])
    assert serving_mesh(devs[:2]) == tuple(devs[:2])
    with pytest.raises(ValueError, match="at least one device"):
        serving_mesh([])
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    for batch in (x, torch.from_numpy(x)):
        parts = sh.split(batch)
        assert [np.asarray(p).tolist() for p in parts] == [x[:3].tolist(), x[3:].tolist()]
    with pytest.raises(ValueError, match="does not split"):
        sh.split(x[:5])


def test_program_cache_keys_apart_each_logical_device(monkeypatch):
    # two logical devices of one physical device: two programs, two sets of
    # tables; the runtime's own device keeps today's key
    monkeypatch.setenv(D.FORCE_DEVICE_COUNT_ENV, "2")
    a, b = D.mesh_devices("cpu")
    cache = TDC.ProgramCache(8)
    meta = TensorMeta((4, 4, 3), "float32", "HWC")
    progs = [TDC.compile_device_program([], meta, lambda x: x, 4, cache=cache, device=d)
             for d in (a, b, "cpu", a, batch_sharding([a, b]))]
    assert progs[0] is progs[3]
    assert len({id(p) for p in progs}) == 4 and len(cache) == 4
    assert progs[2].key[-1] == ("device", "cpu") and progs[2].target is None
    assert [p.target for p in progs[:2]] == [a, b]
    group = progs[4]
    assert [m.target for m in group.members] == [a, b]
    assert [m.batch_size for m in group.members] == [2, 2] and group.batch_size == 4
    # calling the group is its one path: no stream-less run of all members
    x = np.zeros((4, 4, 4, 3), np.float32)
    torch.testing.assert_close(group(x), torch.from_numpy(x), rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="members"):
        group.fn(torch.from_numpy(x))
    with pytest.raises(ValueError, match="does not split"):
        TDC.compile_device_program([], meta, lambda x: x, 3, device=batch_sharding([a, b]))


def test_model_copies_follow_the_input_device():
    # a mesh spanning another physical device copies an nn.Module onto it
    # once (the meta device stands in for a second card)
    model = torch.nn.Linear(3, 2)
    copies = T.facade._ModelCopies(model, torch.device("cpu"))
    x = torch.ones(4, 3)
    torch.testing.assert_close(copies(x), model(x), rtol=0, atol=0)
    out = copies(torch.ones(4, 3, device="meta"))
    assert out.device.type == "meta" and out.shape == (4, 2)
    assert copies(torch.ones(1, 3, device="meta")).shape == (1, 2)
    assert len(copies._copies) == 2 and copies._copies[torch.device("cpu")] is model


# ------------------------------------------------- stream order (simulated)
class _Stream:
    """A stand-in CUDA stream: the ops enqueued on it, in order; a wait is
    an op naming the other stream and how many of its ops it covers."""

    def __init__(self, name):
        self.name = name
        self.ops = []

    def wait_stream(self, other):
        self.ops.append(("wait", other, len(other.ops)))


def _simulated_streams(monkeypatch):
    current = threading.local()
    default = _Stream("default")

    class _Context:
        def __init__(self, stream):
            self.stream = stream

        def __enter__(self):
            self.prev = getattr(current, "stream", default)
            if self.stream is not None:
                current.stream = self.stream

        def __exit__(self, *exc):
            current.stream = self.prev

    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: getattr(
        current, "stream", default))
    monkeypatch.setattr(torch.cuda, "stream", _Context)
    return default, lambda: getattr(current, "stream", default)


def _ordered_after(reader: _Stream, op_index: int, writer: _Stream, work_index: int) -> bool:
    """True if ``reader``'s op ``op_index`` runs after ``writer``'s op
    ``work_index``: on the same stream later, or behind a wait covering it."""
    if reader is writer:
        return op_index > work_index
    return any(op[0] == "wait" and op[1] is writer and op[2] > work_index
               for op in reader.ops[:op_index])


@pytest.mark.parametrize("caller", ["default stream", "the target's stream"])
def test_readback_orders_after_the_targets_work(monkeypatch, caller):
    default, now = _simulated_streams(monkeypatch)
    target = D.LogicalDevice(torch.device("cpu"), 1, _Stream("replica1"), "sim:1")
    seen = []

    def program(batch):
        stream = now()
        stream.ops.append(("work", batch))
        seen.append((stream, len(stream.ops) - 1))
        return batch

    def readback():
        stream = now()
        stream.ops.append(("readback",))
        return stream, len(stream.ops) - 1

    if caller == "default stream":
        target.run(program, 7)
        reader, at = readback()
    else:
        with target.scope():
            target.run(program, 7)
            reader, at = readback()
    (writer, work), = seen
    assert writer is target.stream
    assert _ordered_after(reader, at, writer, work)
    assert reader is (default if caller == "default stream" else target.stream)
    assert now() is default


def test_stream_order_check_catches_a_missing_wait(monkeypatch):
    # the same check, on a run that skips the caller's wait, fails
    default, now = _simulated_streams(monkeypatch)
    stream = _Stream("replica0")
    with torch.cuda.stream(stream):
        stream.ops.append(("work",))
    default.ops.append(("readback",))
    assert not _ordered_after(default, 0, stream, 0)


def test_dispatcher_reads_back_on_the_target_it_ran_on(monkeypatch, images):
    # every dispatch's readback runs on the stream its program ran on: a
    # replica's dispatcher is paired with one logical device's stream, a
    # sharded group's with its first member's (simulated streams stand in
    # for the cards' on the mesh's logical CPU devices)
    monkeypatch.setenv(D.FORCE_DEVICE_COUNT_ENV, "4")
    default, now = _simulated_streams(monkeypatch)
    owner = {}  # simulated stream -> its logical device
    for dev in D.mesh_devices("cpu"):
        monkeypatch.setattr(dev, "stream", _Stream(dev.label))
        owner[dev.stream] = dev
    ran, read = [], []
    to_host = t_scheduler._to_host

    def recording_to_host(out):
        read.append((threading.get_ident(), now()))
        return to_host(out)

    monkeypatch.setattr(t_scheduler, "_to_host", recording_to_host)
    for sharded in (False, True):
        ran.clear()
        read.clear()
        _, t_rt, _, t_corpus = _runtimes(
            images, lambda pkg: {"mesh": pkg.MeshConfig(replicas=2, sharded=sharded)}
            if pkg is T else {})
        fn = t_rt.model_fns["fast"]
        t_rt.model_fns["fast"] = lambda x, fn=fn: (
            ran.append((threading.get_ident(), now())), fn(x))[1]
        _serve(t_rt, t_corpus)
        readers = {}  # dispatcher thread -> the streams its readbacks ran on
        for tid, stream in read:
            readers.setdefault(tid, set()).add(stream)
        assert len(readers) == 2 and all(len(ss) == 1 for ss in readers.values())
        firsts = [owner[next(iter(ss))] for ss in readers.values()]
        assert sorted(d.id for d in firsts) == [0, 2]
        dispatched = [(tid, stream) for tid, stream in ran if tid in readers]
        assert dispatched  # (the caller's thread makes the warm-up runs)
        for tid, stream in dispatched:
            (first,) = readers[tid]
            if sharded:  # a member of the first's group of two
                assert owner[stream].id // 2 == owner[first].id // 2
            else:
                assert stream is first
        assert now() is default


# ------------------------------------------------------------- scheduler
def _mesh_scheduler(pkg, num_replicas, device_fn, **kw):
    sched = pkg.RequestScheduler(
        lambda item: np.full((4,), float(item), np.float32), device_fn, (4,), np.float32,
        max_batch=8, num_workers=2, max_wait_ms=1.0, num_replicas=num_replicas, **kw)
    sched.start()
    return sched


def _pump(sched, n, start=0):
    uids = [sched.submit(start + i) for i in range(n)]
    sched.flush(timeout=TIMEOUT)
    return uids, sched.drain(timeout=TIMEOUT)


def _meet_first(parties):
    """A device function whose first ``parties`` calls meet at one barrier:
    it returns only if that many dispatches run at once."""
    barrier = threading.Barrier(parties, timeout=TIMEOUT)
    calls = []
    lock = threading.Lock()

    def fn(batch):
        with lock:
            calls.append(threading.get_ident())
            first = len(calls) <= parties
        if first:
            barrier.wait()
        return batch * 2.0

    return fn, calls


def test_two_replicas_dispatch_at_once():
    fn, calls = _meet_first(2)
    sched = _mesh_scheduler(T, 2, fn, replica_labels=["cpu:0", "cpu:1"])
    try:
        uids, done = _pump(sched, 32)
        snaps = sched.replica_snapshots()
    finally:
        sched.stop()
    assert sorted(d.uid for d in done) == uids and not any(d.error for d in done)
    assert len(set(calls[:2])) == 2  # two dispatcher threads met at the barrier
    assert [s.device for s in snaps] == ["cpu:0", "cpu:1"] and all(s.alive for s in snaps)
    assert sum(s.items for s in snaps) == 32 and all(s.batches > 0 for s in snaps)
    for d in done:
        np.testing.assert_array_equal(d.output, np.full((4,), d.uid * 2.0, np.float32))


def test_one_replica_never_dispatches_twice_at_once():
    # the barrier above is what proves parallelism: one replica alone
    # breaks it, and the requests fail with the broken barrier
    barrier = threading.Barrier(2, timeout=0.5)

    def fn(batch):
        barrier.wait()
        return batch

    sched = _mesh_scheduler(T, 1, fn)
    try:
        _, done = _pump(sched, 8)
    finally:
        sched.stop()
    assert done and all(isinstance(d.error, threading.BrokenBarrierError) for d in done)


def test_injected_fault_redispatches_without_losing_requests():
    injector = T.FaultInjector()
    tried = threading.Event()

    def replica0(batch):
        tried.wait(TIMEOUT)  # busy until replica 1 has taken a batch and died
        return batch * 2.0

    def replica1(batch):
        tried.set()
        injector.check(1)
        return batch * 2.0

    injector.arm(1)
    sched = _mesh_scheduler(T, 2, [replica0, replica1])
    try:
        uids, done = _pump(sched, 60)
        snaps = {s.index: s for s in sched.replica_snapshots()}
        assert sched.alive_replicas == 1
        assert sched.stats.replica_failures == 1
        assert sched.stats.redispatched_items > 0
        plan = sched.elastic_plan
    finally:
        sched.stop()
    assert sorted(d.uid for d in done) == uids
    for d in done:
        assert d.error is None
        np.testing.assert_array_equal(d.output, np.full((4,), d.uid * 2.0, np.float32))
    assert not snaps[1].alive and snaps[1].dispatch_errors == 1 and snaps[1].items == 0
    assert snaps[0].alive and snaps[0].items == 60
    assert plan is not None and plan.data_parallel == 1


def test_fail_replica_between_dispatches_loses_nothing():
    sched = _mesh_scheduler(T, 2, lambda batch: batch * 2.0)
    try:
        _pump(sched, 16)
        sched.fail_replica(0)
        uids, done = _pump(sched, 24, start=100)
        assert sched.alive_replicas == 1
        snaps = sched.replica_snapshots()
    finally:
        sched.stop()
    assert sorted(d.uid for d in done) == sorted(uids)
    assert all(d.error is None for d in done)
    assert not snaps[0].alive and snaps[1].alive


def test_whole_mesh_death_fails_fast_not_hangs():
    gate = threading.Event()
    sched = _mesh_scheduler(T, 2, lambda batch: (gate.wait(TIMEOUT), batch)[1])
    try:
        uids = [sched.submit(i) for i in range(20)]
        sched.fail_replica(0)
        sched.fail_replica(1)
        gate.set()
        sched.flush(timeout=TIMEOUT)  # completes (with the mesh error), never hangs
        done = sched.drain(timeout=TIMEOUT)
        assert len(done) == len(uids)
        assert any(isinstance(d.error, T.ReplicaFailure) for d in done if d.error)
        with pytest.raises(RuntimeError, match="no live replicas"):
            sched.submit(999)
    finally:
        sched.stop()


PROBE = -1


def _survivor_batches(pkg, weights, n_each=16):
    """A 2-replica mesh loses replica 1.  Its survivor is held on a probe
    batch until the one host worker has delivered a whole backlog, so the
    weighted-fair picks alone decide the batches it then dispatches,
    returned as (tenant, item) rows."""
    probing, release = threading.Event(), threading.Event()
    batches = []

    def device_fn(batch):
        rows = [int(v) for v in np.asarray(batch)[:, 0]]
        if rows[0] == PROBE:
            probing.set()
            release.wait(TIMEOUT)
        else:
            batches.append(rows)
        return batch

    tenants = [pkg.TenantConfig(n, weight=w) for n, w in zip(("gold", "bronze"), weights)]
    tenants.append(pkg.TenantConfig("probe", max_wait_ms=0.0))  # a batch of its own
    sched = pkg.RequestScheduler(
        lambda item: np.full((4,), float(item), np.float32), device_fn, (4,), np.float32,
        max_batch=4, num_workers=1, max_wait_ms=5_000.0, tenants=tenants, num_replicas=2)
    sched.start()
    try:
        doomed = sched._threads[sched.num_workers + 1]  # replica 1's batcher
        while doomed.is_alive():  # kick it until it has seen its death
            sched.fail_replica(1)
            doomed.join(0.01)
        sched.submit(PROBE, tenant="probe")
        assert probing.wait(TIMEOUT)
        for i in range(n_each):
            sched.submit(i, tenant="gold")
            sched.submit(100 + i, tenant="bronze")
        # the survivor is inside the probe's dispatch, the dead batcher is
        # gone: the ready queue holds exactly the delivered host outputs
        deadline = time.monotonic() + TIMEOUT
        while sched._ready.qsize() < 2 * n_each:
            assert time.monotonic() < deadline, "the host worker did not deliver the backlog"
            time.sleep(0.001)
        release.set()
        sched.flush(timeout=TIMEOUT)
        done = sched.drain(timeout=TIMEOUT)
        snaps = sched.replica_snapshots()
    finally:
        release.set()
        sched.stop()
    assert len(done) == 2 * n_each + 1 and not any(d.error for d in done)
    assert snaps[1].items == 0 and snaps[0].items == 2 * n_each + 1
    assert sched.alive_replicas == 1
    return [[("bronze" if v >= 100 else "gold", v) for v in b] for b in batches]


@pytest.mark.parametrize("weights", [(4.0, 1.0), (2.0, 1.0)])
def test_weights_survive_replica_loss_like_reference(weights):
    t_batches = _survivor_batches(T, weights)
    assert t_batches == _survivor_batches(R, weights)
    # while both tenants are backlogged, gold holds its weight's share
    head = t_batches[: len(t_batches) // 2]
    gold = sum(t == "gold" for b in head for t, _ in b)
    assert abs(gold / (4 * len(head)) - weights[0] / sum(weights)) <= 0.15


def test_capture_counts_only_its_own_threads_launches():
    class Wrapper:
        launches = 0

    inside, other_done = threading.Event(), threading.Event()

    def other():
        inside.wait(TIMEOUT)
        for _ in range(3):
            _build.count_launch(Wrapper)
        other_done.set()

    t = threading.Thread(target=other)
    t.start()
    with _build.thread_launches() as counted:
        _build.count_launch(Wrapper)
        inside.set()
        other_done.wait(TIMEOUT)
        _build.count_launch(Wrapper)
    t.join()
    assert counted == {Wrapper: 2} and Wrapper.launches == 5


# --------------------------------------------------------------- facade
def _serve(rt, corpus, fail_after=None):
    rt.start_serving()
    try:
        uids = []
        for i, item in enumerate(corpus):
            if i == fail_after:
                rt.fail_replica(0)
            uids.append(rt.submit(T.ClassificationQuery(item) if isinstance(rt, T.SmolRuntime)
                                  else R.ClassificationQuery(item)))
        rt.flush(timeout=TIMEOUT)
        done = rt.drain(timeout=TIMEOUT)
        assert rt.wait_warm(timeout=TIMEOUT)
        stats = rt.stats()
    finally:
        rt.stop_serving()
    assert [d.uid for d in done] == uids and not any(d.error for d in done)
    return [np.asarray(d.scores) for d in done], stats


@pytest.fixture(scope="module")
def single_replica(images):
    """Per split-decode mode: the reference's and the port's single-replica
    scores over the corpus."""
    out = {}
    for split, warmup in (("off", "off"), ("full", "full")):
        r_rt, t_rt, r_corpus, t_corpus = _runtimes(
            images, lambda pkg: {"warmup": warmup}, split_decode=split)
        out[split] = (_serve(r_rt, r_corpus)[0], _serve(t_rt, t_corpus)[0])
    return out


MESHES = {
    "replicas=2": (dict(replicas=2), ["cpu:0", "cpu:2"]),
    "replicas=2, sharded": (dict(replicas=2, sharded=True), ["sharded[0-1]", "sharded[2-3]"]),
    "replicas=1, sharded": (dict(replicas=1, sharded=True), ["sharded[0-3]"]),
    "devices=(0, 1)": (dict(replicas=2, devices=(0, 1)), ["cpu:0", "cpu:1"]),
}


@pytest.mark.parametrize("split", ["off", "full"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_facade_mesh_matches_single_replica(monkeypatch, images, single_replica, mesh, split):
    monkeypatch.setenv(D.FORCE_DEVICE_COUNT_ENV, "4")
    kwargs, labels = MESHES[mesh]
    warmup = "full" if split == "full" else "off"
    _, t_rt, _, t_corpus = _runtimes(
        images, lambda pkg: {"warmup": warmup, "mesh": pkg.MeshConfig(**kwargs)},
        split_decode=split)
    outs, stats = _serve(t_rt, t_corpus)
    r_ref, t_ref = single_replica[split]
    for got, port, ref in zip(outs, t_ref, r_ref):
        np.testing.assert_array_equal(got, port)
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-5)
    assert [r.device for r in stats.mesh.replicas] == labels
    assert stats.mesh.alive == len(labels) and stats.mesh.sharded == kwargs.get("sharded", False)
    assert sum(r.items for r in stats.mesh.replicas) == len(t_corpus)
    compiled = t_rt.compile()
    assert (compiled.coeff is not None) == (split == "full")
    assert len(compiled.device_programs) == len(labels)
    assert len({id(p) for p in compiled.device_programs}) == len(labels)
    for ps in compiled.program_sets:  # one per replica target
        group = len(ps.programs[ps.max_batch].members) or 1
        assert all(b % group == 0 for b in ps.buckets) and ps.fully_warm
        for b, prog in ps.programs.items():
            assert [m.batch_size for m in prog.members] == [b // group] * len(prog.members)


def test_facade_fail_replica_mid_stream_loses_no_uid(monkeypatch, images, single_replica):
    monkeypatch.setenv(D.FORCE_DEVICE_COUNT_ENV, "4")
    _, t_rt, _, t_corpus = _runtimes(
        images, lambda pkg: {"mesh": pkg.MeshConfig(replicas=2)}, split_decode="full")
    with pytest.raises(RuntimeError, match="start_serving"):
        t_rt.fail_replica(0)
    outs, stats = _serve(t_rt, t_corpus, fail_after=len(t_corpus) // 2)
    for got, port in zip(outs, single_replica["full"][1]):
        np.testing.assert_array_equal(got, port)
    assert stats.mesh.alive == 1 and stats.mesh.elastic_plan is not None
    assert not stats.mesh.replicas[0].alive


def test_facade_mesh_targets_fixed_at_first_compile(monkeypatch, images):
    # the targets resolved at the first compile serve for the runtime's
    # life, whatever the forced count says later
    monkeypatch.setenv(D.FORCE_DEVICE_COUNT_ENV, "4")
    _, t_rt, _, t_corpus = _runtimes(
        images, lambda pkg: {"mesh": pkg.MeshConfig(replicas=2)} if pkg is T else {})
    t_rt.compile()
    monkeypatch.setenv(D.FORCE_DEVICE_COUNT_ENV, "2")
    t_rt.compile(force=True)
    _, stats = _serve(t_rt, t_corpus)
    assert [r.device for r in stats.mesh.replicas] == ["cpu:0", "cpu:2"]


def test_facade_device_ordinals_out_of_range(monkeypatch, images):
    monkeypatch.setenv(D.FORCE_DEVICE_COUNT_ENV, "4")
    _, t_rt, _, _ = _runtimes(
        images, lambda pkg: {"mesh": pkg.MeshConfig(replicas=1, devices=(99,))})
    with pytest.raises(ValueError, match="device"):
        t_rt.start_serving()


def test_facade_mesh_needs_enough_devices(monkeypatch, images):
    monkeypatch.delenv(D.FORCE_DEVICE_COUNT_ENV, raising=False)
    _, t_rt, _, _ = _runtimes(images, lambda pkg: {"mesh": pkg.MeshConfig(replicas=2)})
    with pytest.raises(ValueError, match="cannot host 2 replicas"):
        t_rt.start_serving()
