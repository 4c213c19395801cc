"""Second-order gradients through the port's modules on the CPU == the
JAX package's reverse-over-reverse Hessian-vector product
``jax.grad(lambda w: vdot(jax.grad(loss)(w), v))`` on the same seeded
inputs, within 2e-5 * max(1, max |JAX|).  The port's product is
``torch.autograd.grad`` of ``(grad * v).sum()`` where ``grad`` was taken
with ``create_graph=True``: every backward on the path (the pyramids, the
DTCWT levels, the DWT steps, the SWT levels and merges, the magnitudes
and the pool) differentiated once more."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pytorch_wavelets_tpu as tw
from pytorch_wavelets_tpu.ops import banded as jbanded
from pytorch_wavelets_tpu.transforms import dtcwt_alt as ja

import pytorch_wavelets_tpu_torch as tt
from pytorch_wavelets_tpu_torch.ops import banded as pbanded
from pytorch_wavelets_tpu_torch.transforms import dtcwt_alt as pa
from tests.torch_parity import FAST, rand

torch.set_num_threads(1)

REL = 2e-5


def _leaves(out):
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _leaves(o)]
    return [] if out is None else [out]


def _cubic(out):
    return sum((o ** 3).sum() for o in _leaves(out))


def _coeff(out):
    return sum((o ** 2).sum() for o in _leaves(out))


def _jax_cubic(out):
    return sum(jnp.sum(o ** 3) for o in jax.tree.leaves(out))


def _jax_coeff(out):
    return sum(jnp.sum(o ** 2) for o in jax.tree.leaves(out))


def _hvp(jfn, pfn, jloss, ploss, shape, seed):
    """Both packages' Hessian-vector product of loss(fn(x)) at a seeded x
    along a seeded v, compared at REL of JAX's largest value."""
    x, v = rand(shape, seed), rand(shape, seed + 1)

    def jhvp(z, w):
        return jax.grad(lambda u: jnp.vdot(
            jax.grad(lambda s: jloss(jfn(s)))(u), w))(z)
    ref = np.asarray(jax.jit(jhvp, compiler_options=FAST)(
        jnp.asarray(x), jnp.asarray(v)))
    xt = torch.from_numpy(x).requires_grad_()
    g, = torch.autograd.grad(ploss(pfn(xt)), xt, create_graph=True)
    hv, = torch.autograd.grad((g * torch.from_numpy(v)).sum(), xt)
    assert hv.shape == ref.shape
    atol = REL * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(hv.numpy(), ref, atol=atol, rtol=0)


@pytest.fixture
def jax_matmul():
    """The JAX package's operator path (the port's counterpart)."""
    jbanded.set_operator_matmul(True)
    yield
    jbanded.set_operator_matmul(None)


@pytest.mark.parametrize("mode", ["zero", "symmetric", "periodization"])
def test_dwt(mode):
    """DWTForward's coefficients and DWTInverse's reconstruction of them:
    the reference's backwards of both, differentiated again."""
    kw = dict(wave="db2", mode=mode)
    jf, ji = tw.DWTForward(J=2, **kw), tw.DWTInverse(**kw)
    pf, pi = tt.DWTForward(J=2, device="cpu", **kw), tt.DWTInverse(
        device="cpu", **kw)

    def jfn(x):
        c = jf(x)
        return c, ji(c)

    def pfn(x):
        c = pf(x)
        return c, pi(c)
    _hvp(jfn, pfn, _jax_cubic, _cubic, (1, 2, 18, 17), 1)


def test_dwt1d():
    kw = dict(J=2, wave="db3", mode="symmetric")
    _hvp(tw.DWT1DForward(**kw), tt.DWT1DForward(device="cpu", **kw),
         _jax_cubic, _cubic, (2, 3, 37), 3)


@pytest.mark.parametrize("per_level", [False, True])
def test_dtcwt(jax_matmul, per_level):
    """The composed pyramids, and the level Functions with the operator
    route off in the port (the JAX side on its operator path)."""
    kw = dict(J=2)
    pbanded.set_operator_matmul(False if per_level else None)
    try:
        _hvp(tw.DTCWTForward(**kw), tt.DTCWTForward(device="cpu", **kw),
             _jax_cubic, _cubic, (2, 3, 16, 16), 5)
    finally:
        pbanded.set_operator_matmul(None)


@pytest.mark.parametrize("per_level", [False, True])
def test_dtcwt_round_trip(jax_matmul, per_level):
    """DTCWTInverse of the squared coefficients of DTCWTForward in 'zero'
    mode: the inverse pyramid's and inverse levels' backwards
    differentiated again."""
    kw = dict(mode="zero")
    jf, ji = tw.DTCWTForward(J=3, **kw), tw.DTCWTInverse(**kw)
    pf = tt.DTCWTForward(J=3, device="cpu", **kw)
    pi = tt.DTCWTInverse(device="cpu", **kw)

    def jfn(x):
        yl, yh = jf(x)
        return ji((yl * yl, [h * h for h in yh]))

    def pfn(x):
        yl, yh = pf(x)
        return pi((yl * yl, [h * h for h in yh]))
    pbanded.set_operator_matmul(False if per_level else None)
    try:
        _hvp(jfn, pfn, _jax_cubic, _cubic, (1, 2, 16, 24), 13)
    finally:
        pbanded.set_operator_matmul(None)


def test_swt_round_trip():
    """SWTForward's levels and SWTInverse's least-squares merges."""
    kw = dict(wave="db2", mode="periodization")
    jf, ji = tw.SWTForward(J=2, **kw), tw.SWTInverse(**kw)
    pf = tt.SWTForward(J=2, device="cpu", **kw)
    pi = tt.SWTInverse(device="cpu", **kw)

    def jfn(x):
        ys = jf(x)
        return ys, ji([y * y for y in ys])

    def pfn(x):
        ys = pf(x)
        return ys, pi([y * y for y in ys])
    _hvp(jfn, pfn, _jax_cubic, _cubic, (1, 2, 16, 16), 7)


@pytest.mark.parametrize("kw", [
    {}, dict(biort="near_sym_b_bp", qshift="qshift_b_bp"),
    dict(combine_colour=True)], ids=["default", "bp", "colour"])
def test_scatlayerj2(jax_matmul, kw):
    _hvp(tw.ScatLayerj2(**kw), tt.ScatLayerj2(device="cpu", **kw),
         _jax_coeff, _coeff, (1, 3, 16, 16), 9)


def test_dtcwt_forward2():
    _hvp(ja.DTCWTForward2(J=2), pa.DTCWTForward2(J=2, device="cpu"),
         _jax_cubic, _cubic, (1, 2, 16, 20), 11)
