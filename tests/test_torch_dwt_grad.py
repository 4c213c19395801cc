"""The port's DWT on the CPU == the JAX package for bior2.2 (unequal
analysis and synthesis filters), forward, inverse and both gradients, in
every mode, against both JAX paths; and the four autograd Functions'
backwards: the adjoint of their forwards in 'zero' mode (float64), where
the reference's backward is the true adjoint, and not in 'symmetric'."""
import numpy as np
import pytest
import torch

from chip_smoke import adjoint_error
from pytorch_wavelets_tpu_torch.transforms import dwt as pdwt
from tests.torch_parity import dwt_grid, dwt_parity, jax_path  # noqa: F401

torch.set_num_threads(1)


@pytest.mark.parametrize("jax_path,wave,mode,shape",
                         dwt_grid(["bior2.2"]), indirect=["jax_path"])
def test_dwt2d_bior(jax_path, wave, mode, shape):
    dwt_parity(shape, wave, mode, 3, jax_path)


def _r(shape, seed):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape))


def _adjoint(wave, mode, shape):
    """Relative dot-product test of each Function against its backward,
    float64: forward then inverse, 2-D (2 levels) and 1-D."""
    errs = []
    for fwd, inv, x in ((pdwt.dwt2d, pdwt.idwt2d, _r(shape, 1)),
                        (pdwt.dwt1d, pdwt.idwt1d, _r(shape[:3], 2))):
        x = x.requires_grad_()
        yl, yh = fwd(x, wave, 2, mode)
        outs = [yl, *yh]
        gs = [_r(o.shape, 3 + k) for k, o in enumerate(outs)]
        gx = torch.autograd.grad(outs, x, gs)[0]
        errs.append(adjoint_error(outs, gs, [x], [gx]))
        leaves = [o.detach().requires_grad_() for o in outs]
        rec = inv((leaves[0], leaves[1:]), wave, mode)
        g = _r(rec.shape, 9)
        grads = torch.autograd.grad(rec, leaves, g)
        errs.append(adjoint_error([rec], [g], leaves, grads))
    return errs


@pytest.mark.parametrize("wave,shape", [("db4", (2, 3, 33, 29)),
                                        ("bior2.2", (1, 2, 24, 40))])
def test_backward_is_adjoint_in_zero_mode(wave, shape):
    assert max(_adjoint(wave, "zero", shape)) < 1e-13


def test_backward_is_not_adjoint_in_symmetric_mode():
    """The reference's backward ignores the boundary fold: autograd of the
    forward would differ from it."""
    assert min(_adjoint("db4", "symmetric", (1, 1, 32, 32))) > 1e-4
