"""The inverse SWT's long-axis branches on the CPU == the JAX package:
past ``_ISWT_PINV_MAX_N`` = 2048 samples the least-squares merge runs as
an FFT merge in the circular modes and as banded normal equations in the
others, along W (thin wide images) and along H; the inverse and the
gradients against ``jax.vjp`` within 2e-5 (beyond JAX's own float64
error, see ``tests/torch_parity.py:swt_parity``), and the banded branch's
float64 round trip within 1e-10 (the JAX suite's, tests/test_swt.py:81)."""
import numpy as np
import pytest
import torch

from pytorch_wavelets_tpu_torch.transforms import dwt as pdwt
from tests.torch_parity import swt_parity

torch.set_num_threads(1)

LONG = pdwt._ISWT_PINV_MAX_N + 8


def _branch(mode, n):
    taps = tuple(pdwt._tup(pdwt._rev(t)) for t in pdwt.dec_filters("db3")[:2])
    return type(pdwt._merge_plan(taps, 1, mode, n, torch.device("cpu"),
                                 torch.float32)).__name__


@pytest.mark.parametrize("mode", ["periodization", "periodic", "symmetric"])
def test_long_rows(mode):
    swt_parity((1, 2, 8, LONG), "db3", mode, 2, grads=True)
    assert _branch(mode, LONG) == ("_FFTMerge" if mode.startswith("period")
                                   else "_OperatorMerge")


@pytest.mark.parametrize("mode", ["periodization", "reflect"])
def test_long_columns(mode):
    swt_parity((1, 1, LONG, 6), "db2", mode, 1, grads=True)


def test_banded_round_trip_float64():
    """(After test_long_rows, whose float64 reference built the same
    operators.)"""
    x = torch.from_numpy(np.random.RandomState(11).randn(1, 1, 8, LONG))
    c = pdwt.swt2d(x, "db3", J=2, mode="symmetric")
    rec = pdwt.iswt2d(c, "db3", mode="symmetric")
    assert rec.dtype == torch.float64
    assert float((rec - x).abs().max()) <= 1e-10
