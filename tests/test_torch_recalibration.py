"""Online recalibration in both packages: the same measurement sequences
through the reference's recalibrators and the port's give the same
decisions (split, decode factor, worker count, cascade factor), and
``run()`` with ``RecalConfig(every=k)`` makes the same decisions from the
same per-chunk measurements and keeps the reference's argmax (logits
within 1e-4).  ``run()``'s measurements are wall-clock stage occupancies,
so the run test scripts them — both runtimes see one sequence."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.runtime as R  # noqa: E402
import repro.runtime.recalibration as R_recal  # noqa: E402
import repro_torch.runtime as T  # noqa: E402
import repro_torch.runtime.recalibration as T_recal  # noqa: E402
from repro.core.cost_model import CoeffGeometry as RGeom  # noqa: E402
from repro.core.planner import standard_chain as r_chain  # noqa: E402
from repro.preprocessing.ops import TensorMeta as RMeta  # noqa: E402
from repro_torch.core.cost_model import CoeffGeometry as TGeom  # noqa: E402
from repro_torch.core.planner import standard_chain as t_chain  # noqa: E402
from repro_torch.preprocessing.ops import TensorMeta as TMeta  # noqa: E402

from test_torch_runtime import _runtimes, images  # noqa: E402,F401

# (host s/item, device s/item) windows: a host-bound stretch, a swing to a
# device-bound one, then noise around it
SEQUENCES = {
    "host_bound": [(8e-3, 1e-3)] * 4 + [(9e-3, 1.2e-3), (7e-3, 0.9e-3)],
    "device_bound": [(1e-3, 9e-3)] * 3 + [(1.1e-3, 8e-3)] * 3,
    "swing": [(8e-3, 1e-3), (8e-3, 1e-3), (1e-3, 8e-3), (1e-3, 9e-3), (2e-3, 2e-3), (3e-3, 1e-3)],
}


def _recalibrators(split_decode):
    out = []
    for recal, chain, Meta, Geom in ((R_recal, r_chain, RMeta, RGeom),
                                     (T_recal, t_chain, TMeta, TGeom)):
        geom = None
        if split_decode != "off":
            geom = Geom(height=384, width=512, channels=3, n_br=48, n_bc=64, subsample=True)
        out.append(recal.Recalibrator(
            chain(224), Meta((384, 512, 3), "uint8", "HWC"),
            host_decode_time=4e-3, dnn_device_time=1e-3,
            host_ops_per_sec=2e9, device_ops_per_sec=2e11,
            alpha=0.5, hysteresis=0.1, device_dispatch_overhead_s=1e-5,
            split_decode=split_decode, coeff_geometry=geom,
            host_entropy_time=2e-3 if geom is not None else None))
    return out


def _event_key(e):
    return (e.old_split, e.new_split, e.old_factor, e.new_factor, e.changed,
            round(e.predicted_throughput, 6))


@pytest.mark.parametrize("split_decode", ["off", "auto"])
@pytest.mark.parametrize("sequence", sorted(SEQUENCES))
def test_split_recalibrator_decisions_match_reference(split_decode, sequence):
    r_rec, t_rec = _recalibrators(split_decode)
    placements = [r_rec._placement_for(len(r_rec.chain)), t_rec._placement_for(len(t_rec.chain))]
    coeffs = [None, None]
    for host, dev in SEQUENCES[sequence]:
        for i, (rec, pkg) in enumerate(((r_rec, R), (t_rec, T))):
            placements[i], _ = rec.update(placements[i], pkg.StageMeasurement(host, dev),
                                          coeff=coeffs[i])
            coeffs[i] = rec.chosen_coeff
        assert placements[1].split == placements[0].split
        assert (coeffs[1] is None) == (coeffs[0] is None)
        if coeffs[1] is not None:
            assert (coeffs[1].factor, coeffs[1].layout) == (coeffs[0].factor, coeffs[0].layout)
    assert [_event_key(e) for e in t_rec.events] == [_event_key(e) for e in r_rec.events]


@pytest.mark.parametrize("sequence", sorted(SEQUENCES))
def test_worker_recalibrator_decisions_match_reference(sequence):
    recs = [pkg.WorkerRecalibrator(num_workers=4, max_workers=16, alpha=0.5) for pkg in (R, T)]
    for host, dev in SEQUENCES[sequence]:
        moves = [rec.update(pkg.StageMeasurement(host, dev)) for rec, pkg in zip(recs, (R, T))]
        assert moves[1] == moves[0]
    assert [(e.old_workers, e.new_workers) for e in recs[1].events] == [
        (e.old_workers, e.new_workers) for e in recs[0].events
    ]


def test_cascade_recalibrator_decisions_match_reference():
    recs = [pkg.CascadeRecalibrator(2, 0.6, candidates=(1, 2, 4)) for pkg in (R, T)]
    windows = [(40, 30, 2e-3), (40, 35, 2e-3), (40, 5, 1e-3), (40, 4, 1e-3), (40, 20, 3e-3)]
    for items, refetched, cheap_spi in windows:
        for rec in recs:
            rec.observe(rec.factor, items, refetched, cheap_spi, 8e-3)
        moves = [rec.update() for rec in recs]
        assert moves[1] == moves[0]
    assert [(e.old_factor, e.new_factor) for e in recs[1].events] == [
        (e.old_factor, e.new_factor) for e in recs[0].events
    ]


def _scripted(monkeypatch, windows):
    """Both packages' ``from_engine_stats`` return ``windows`` in turn."""
    for pkg, recal in ((R, R_recal), (T, T_recal)):
        it = iter(windows)
        monkeypatch.setattr(
            recal.StageMeasurement, "from_engine_stats",
            classmethod(lambda cls, stats, it=it: cls(*next(it))))


@pytest.mark.parametrize("every", [4, 8])
@pytest.mark.parametrize("split_decode", ["auto", "full"])
def test_run_with_recalibration_matches_reference(images, monkeypatch, every, split_decode):
    n_windows = -(-len(images) // every) - 1
    windows = [(8e-3, 1e-4)] * n_windows  # host-bound
    _scripted(monkeypatch, windows)
    r_rt, t_rt, r_corpus, t_corpus = _runtimes(
        images, lambda pkg: {"recal": pkg.RecalConfig(every=every)}, split_decode=split_decode)
    r_outs, r_report = r_rt.run(r_corpus)
    t_outs, t_report = t_rt.run(t_corpus)
    assert len(t_report.recalibrations) == len(r_report.recalibrations) == n_windows
    assert [_event_key(e) for e in t_report.recalibrations] == [
        _event_key(e) for e in r_report.recalibrations
    ]
    assert [(e.old_workers, e.new_workers) for e in t_rt.worker_recalibrations] == [
        (e.old_workers, e.new_workers) for e in r_rt.worker_recalibrations
    ]
    assert t_rt.compile().placement.split == r_rt.compile().placement.split
    if split_decode == "auto":  # moves pixels <-> scaled decode; "full" stays put
        assert any(e.changed for e in t_report.recalibrations)
    assert [c.num_items for c in t_report.chunk_stats] == [
        c.num_items for c in r_report.chunk_stats
    ]
    for a, b in zip(t_outs, r_outs):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-4)
        assert np.argmax(a) == np.argmax(b)


def test_recalibrate_needs_a_compiled_plan(images):
    r_rt, t_rt, _, _ = _runtimes(images)
    for rt, pkg in ((r_rt, R), (t_rt, T)):
        with pytest.raises(RuntimeError, match="compile"):
            rt.recalibrate(pkg.StageMeasurement(1e-3, 1e-3))
    with pytest.raises(ValueError, match="every"):
        T.RecalConfig(every=-1)
