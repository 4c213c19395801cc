"""The port's SWT gradients on the CPU == ``jax.vjp`` of the JAX package's
SWT (which it differentiates by autodiff): x.grad of the forward and the
stacks' gradients of the exact inverse, within 2e-5, in every mode,
including the LL band that the next level reads as a view (J = 3); and
both autograd Functions are exact transposes (the dot-product test in
float64): ``_AFB2DAtrous`` in every mode, ``_LSMerge`` in each of its
three branches (dense pinv, FFT and banded least squares) along both
axes."""
import numpy as np
import pytest
import torch

from chip_smoke import adjoint_error
from pytorch_wavelets_tpu_torch.transforms import dwt as pdwt
from tests.torch_parity import SWT_MODES, swt_parity

torch.set_num_threads(1)


@pytest.mark.parametrize("wave", ["db2", "bior2.4"])
@pytest.mark.parametrize("mode", SWT_MODES)
def test_swt_gradients(mode, wave):
    swt_parity((1, 2, 13, 11), wave, mode, 2, grads=True)


@pytest.mark.parametrize("path", ["conv", "matmul"])
def test_swt_gradients_three_levels(path):
    """Level j + 1 reads level j's LL band as a view: its cotangent is the
    user's plus the next level's."""
    swt_parity((2, 2, 16, 16), "db4", "periodization", 3, path, grads=True)


def _r(shape, seed):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape))


@pytest.mark.parametrize("mode", SWT_MODES)
def test_afb2d_atrous_is_adjoint(mode):
    """The level Function at dilation 2 on a strided input, float64."""
    taps = tuple(pdwt._rev(t) for t in pdwt.dec_filters("db4"))
    x = _r((2, 3, 4, 11, 9), 1)[:, :, 1].requires_grad_()
    y = pdwt._AFB2DAtrous.apply(x, taps, mode, 2)
    g = _r(y.shape, 2)
    gx = torch.autograd.grad(y, x, g)[0]
    assert adjoint_error([y], [g], [x], [gx]) < 1e-12


@pytest.mark.parametrize("mode,n", [("symmetric", 12), ("periodization", 12),
                                    ("periodization", 2056),
                                    ("symmetric", 2056)])
@pytest.mark.parametrize("axis", [2, 3])
def test_ls_merge_is_adjoint(mode, n, axis):
    """Dense pinv (n = 12), FFT (circular, n > 2048) and banded least
    squares (non-circular, n > 2048), float64."""
    taps = tuple(pdwt._tup(pdwt._rev(t)) for t in pdwt.dec_filters("db3")[:2])
    shape = [1, 2, 3, 5]
    shape[axis] = n
    lo, hi = (_r(shape, s).requires_grad_() for s in (3, 4))
    z = pdwt.ls_merge(lo, hi, taps, 2, axis, mode)
    assert type(pdwt._merge_plan(taps, 2, mode, n, torch.device("cpu"),
                                 torch.float64)).__name__ == (
        "_FFTMerge" if n > 2048 and mode == "periodization"
        else "_OperatorMerge")
    g = _r(z.shape, 5)
    grads = torch.autograd.grad(z, [lo, hi], g)
    assert adjoint_error([z], [g], [lo, hi], list(grads)) < 1e-12
