"""The port's ``configs/shapes.py``, ``SKIP_CELLS`` and ``serving/kv_cache.py``
against the reference's: the input shapes, the skipped cells with their
reasons, the cache policy and the cache's bytes for every configuration
over tensor-parallel widths, batches and data-axis sizes."""

import dataclasses
import itertools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import configs as RC  # noqa: E402
from repro.configs import shapes as RS  # noqa: E402
from repro.serving import kv_cache as RK  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.configs import shapes as TS  # noqa: E402
from repro_torch.serving import kv_cache as TK  # noqa: E402

TPS, BATCHES, DATA = (1, 2, 16), (1, 32, 128), (1, 16)


def test_shapes_equal_reference():
    assert list(TS.SHAPES) == list(RS.SHAPES)
    for name, shape in TS.SHAPES.items():
        assert dataclasses.astuple(shape) == dataclasses.astuple(RS.SHAPES[name])


def test_skip_cells_equal_reference():
    assert TC.SKIP_CELLS == RC.SKIP_CELLS
    for arch, shape in itertools.product(TC.ARCH_NAMES, TS.SHAPES):
        assert TC.cell_is_skipped(arch, shape) == RC.cell_is_skipped(arch, shape)


@pytest.mark.parametrize("arch", RC.ARCH_NAMES)
def test_cache_policy_and_bytes_equal_reference(arch):
    """Every (tp, batch, data) cell: the same policy, and the same global
    bytes at each input shape's sequence length."""
    rcfg, tcfg = RC.get_config(arch), TC.get_config(arch)
    for tp, batch, data in itertools.product(TPS, BATCHES, DATA):
        rp, tp_ = RK.choose_cache_policy(rcfg, tp, batch, data), TK.choose_cache_policy(tcfg, tp, batch, data)
        assert dataclasses.astuple(tp_) == dataclasses.astuple(rp), (tp, batch, data)
        for shape in RS.SHAPES.values():
            assert TK.cache_bytes(tcfg, tp_, batch, shape.seq_len) == RK.cache_bytes(rcfg, rp, batch, shape.seq_len)
