"""The port's DTCWT module options (CPU, plain path) == the JAX package's
modules with its operator path forced, at the JAX suite's own tolerances:
other filter banks, skip_hps / include_scale, level-1 modes, J=0, None
highs, coeff_dtype, custom taps, CPU gradients and the reference's
errors."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pytorch_wavelets_tpu as tw
from pytorch_wavelets_tpu.transforms.dtcwt_xfm import dtcwt_fwd_filters

import pytorch_wavelets_tpu_torch as tt
from pytorch_wavelets_tpu_torch.convert import filters_from_jax
from tests.torch_parity import (  # noqa: F401
    FWD_ATOL, INV_ATOL, both, cmp, rand, force_jax_matmul,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("biort,qshift", [("near_sym_b", "qshift_b"),
                                          ("legall", "qshift_c")])
def test_other_banks(biort, qshift):
    both((1, 2, 32, 48), J=2, biort=biort, qshift=qshift,
         inv_kw=dict(biort=biort, qshift=qshift))


def test_skip_hps_and_include_scale():
    both((1, 2, 32, 32), seed=2, J=3, skip_hps=[True, False, False],
         include_scale=[False, True, True])


def test_mode_zero_level1():
    both((1, 2, 32, 32), seed=3, J=2, mode="zero", inv_kw=dict(mode="zero"))


def test_j0_is_identity():
    x = rand((1, 2, 16, 16), 4)
    yl, yh = tt.DTCWTForward(J=0, device="cpu")(torch.from_numpy(x))
    assert yh is None
    np.testing.assert_array_equal(yl.numpy(), x)


def test_none_highs_into_inverse():
    x, jy, py = both((1, 1, 32, 32), seed=5, J=3)
    ji, pi = tw.DTCWTInverse(), tt.DTCWTInverse(device="cpu")
    cmp(pi((None, py[1])), ji((None, jy[1])), INV_ATOL)
    cmp(pi((py[0], [None, py[1][1], None])),
         ji((jy[0], [None, jy[1][1], None])), INV_ATOL)
    empty = torch.zeros(0)
    cmp(pi((py[0], [empty, py[1][1], py[1][2]])),
         ji((jy[0], [None, jy[1][1], jy[1][2]])), INV_ATOL)


def test_coeff_dtype_bfloat16():
    x, jy, py = both((1, 2, 32, 32), seed=6, J=2, coeff_dtype="bfloat16")
    assert all(h.dtype == torch.bfloat16 for h in py[1])
    assert py[0].dtype == torch.float32
    cmp(tt.DTCWTInverse(device="cpu")(py), tw.DTCWTInverse()(jy), INV_ATOL)


def test_perfect_reconstruction():
    x = torch.from_numpy(rand((2, 3, 64, 64), 7))
    f, i = tt.DTCWTForward(J=3, device="cpu"), tt.DTCWTInverse(device="cpu")
    assert (i(f(x)) - x).abs().max().item() <= 1e-5


def test_custom_taps_through_filters_from_jax():
    r = np.random.RandomState(8)
    biort = (r.randn(7, 1) / 3, r.randn(9, 1) / 3)   # O(1) outputs
    qshift = tuple(r.randn(10, 1) / 3 for _ in range(4))
    x = rand((1, 2, 32, 32), 9)
    jy = tw.DTCWTForward(J=2, biort=biort, qshift=qshift)(jnp.asarray(x))
    custom = tt.DTCWTForward(J=2, biort=biort, qshift=qshift, device="cpu")
    cmp(custom(torch.from_numpy(x)), jy, FWD_ATOL)
    # the same taps loaded as a state dict into a module of equal lengths
    loaded = tt.DTCWTForward(J=2, biort=(np.zeros(7), np.zeros(9)),
                             qshift=tuple(np.zeros(10) for _ in range(4)),
                             device="cpu")
    loaded.load_state_dict(filters_from_jax(dtcwt_fwd_filters(biort,
                                                              qshift)))
    cmp(loaded(torch.from_numpy(x)), jy, FWD_ATOL)


def test_gradient_on_cpu_matches_jax():
    x = rand((1, 2, 32, 32), 10)
    f = tw.DTCWTForward(J=2)
    jg = jax.grad(lambda z: jnp.sum(f(z)[0]) +
                  sum(jnp.sum(h ** 2) for h in f(z)[1]))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    yl, yh = tt.DTCWTForward(J=2, device="cpu")(xt)
    (yl.sum() + sum((h ** 2).sum() for h in yh)).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), atol=1e-4)


def test_errors():
    with pytest.raises(ValueError, match="different dimensions"):
        tt.DTCWTForward(o_dim=2, ri_dim=2, device="cpu")
    with pytest.raises(NotImplementedError):
        tt.DTCWTForward(batch_chunk=8, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError):
        tt.DTCWTInverse(mesh=object(), device="cpu")
    i = tt.DTCWTInverse(device="cpu")
    bad = torch.zeros(1, 1, 5, 4, 4, 2)
    with pytest.raises(ValueError, match="6 orientations"):
        i((torch.zeros(1, 1, 4, 4), [torch.zeros(1, 1, 6, 4, 4, 2), bad]))
    with pytest.raises(ValueError, match="complex"):
        i((None, [torch.zeros(1, 1, 6, 4, 4, 3)]))
