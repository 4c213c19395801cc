"""Higher-order gradients that the port once raised on, against the JAX
package's nested reverse-mode derivatives on the same seeded inputs,
within 2e-5 * max(1, max |JAX|):

- the second derivative of a level-1 DTCWT inverse without bands on the
  per-level path in a mode other than 'symmetric' (its backward filters
  the lowpass in the mode, so its transpose is the lowpass synthesis in
  the mode);
- a third-order directional derivative through ScatLayerj2 (the
  magnitude's second derivative, K18, differentiated once more).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pytorch_wavelets_tpu as tw
from pytorch_wavelets_tpu.ops import banded as jbanded

import pytorch_wavelets_tpu_torch as tt
from pytorch_wavelets_tpu_torch.ops import banded as pbanded
from tests.torch_parity import FAST, rand

torch.set_num_threads(1)

REL = 2e-5


def _close(mine, ref):
    assert tuple(mine.shape) == ref.shape
    atol = REL * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(mine.detach().numpy(), ref, atol=atol, rtol=0)


@pytest.fixture
def per_level():
    """Both packages on their per-level DTCWT path."""
    jbanded.set_operator_matmul(False)
    pbanded.set_operator_matmul(False)
    yield
    jbanded.set_operator_matmul(None)
    pbanded.set_operator_matmul(None)


@pytest.mark.parametrize("mode", ["zero", "periodization", "reflect"])
def test_level1_inverse_lowpass_hvp(per_level, mode):
    """Hessian-vector product of sum(y^3), y = DTCWTInverse((yl, [None]))
    on 2x2x16x20, against jax.grad of jax.grad."""
    yl, v = rand((2, 2, 16, 20), 1), rand((2, 2, 16, 20), 2)
    ji, pi = tw.DTCWTInverse(mode=mode), tt.DTCWTInverse(mode=mode,
                                                        device="cpu")

    def jloss(z):
        return jnp.sum(ji((z, [None])) ** 3)

    def jhvp(z, w):
        return jax.grad(lambda s: jnp.vdot(jax.grad(jloss)(s), w))(z)
    ref = np.asarray(jax.jit(jhvp, compiler_options=FAST)(
        jnp.asarray(yl), jnp.asarray(v)))
    zt = torch.from_numpy(yl).requires_grad_()
    g, = torch.autograd.grad((pi((zt, [None])) ** 3).sum(), zt,
                             create_graph=True)
    hv, = torch.autograd.grad((g * torch.from_numpy(v)).sum(), zt)
    _close(hv, ref)


@pytest.fixture(params=["plain", "kernel_like"])
def mag_kernels(request, monkeypatch):
    """The magnitude's plain versions as the CPU runs them, or wrapped as
    the card's kernels behave: no autograd graph through their results,
    so every order past the second must come from the Functions."""
    if request.param == "kernel_like":
        from pytorch_wavelets_tpu_torch.transforms import scatternet as ps
        for name in ("scat_mag_fwd", "scat_mag_bwd", "scat_mag_bwd2"):
            fn = getattr(ps, name)

            def raw(*args, _fn=fn):
                with torch.no_grad():
                    return _fn(*args)
            monkeypatch.setattr(ps, name, raw)
    return request.param


def test_scatlayerj2_third_order(mag_kernels):
    """grad_x <grad_x <grad_x sum(Z^3), v>, w> through ScatLayerj2 on
    2x3x32x32 (JAX on its operator path, the port's counterpart)."""
    x, v, w = (rand((2, 3, 32, 32), s) for s in (3, 4, 5))
    jl, pl = tw.ScatLayerj2(), tt.ScatLayerj2(device="cpu")

    def jloss(z):
        return jnp.sum(jl(z) ** 3)

    def j3(z, a, b):
        def hv(s):
            return jnp.vdot(jax.grad(lambda r: jnp.vdot(
                jax.grad(jloss)(r), a))(s), b)
        return jax.grad(hv)(z)
    jbanded.set_operator_matmul(True)
    try:
        ref = np.asarray(jax.jit(j3, compiler_options=FAST)(
            jnp.asarray(x), jnp.asarray(v), jnp.asarray(w)))
    finally:
        jbanded.set_operator_matmul(None)
    xt = torch.from_numpy(x).requires_grad_()
    g1, = torch.autograd.grad((pl(xt) ** 3).sum(), xt, create_graph=True)
    g2, = torch.autograd.grad((g1 * torch.from_numpy(v)).sum(), xt,
                              create_graph=True)
    g3, = torch.autograd.grad((g2 * torch.from_numpy(w)).sum(), xt)
    _close(g3, ref)
