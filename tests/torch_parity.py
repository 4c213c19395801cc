"""Shared helpers of the port's module parity tests
(tests/test_torch_*.py): one input through the JAX package and the
port, compared at the JAX suite's own tolerances (tests/test_dtcwt.py)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pytorch_wavelets_tpu as tw
from pytorch_wavelets_tpu.ops import banded as jbanded

import pytorch_wavelets_tpu_torch as tt

FWD_ATOL = 1e-5
INV_ATOL = 2e-5


@pytest.fixture(autouse=True)
def force_jax_matmul():
    """The JAX package's operator path: the path the port carries."""
    jbanded.set_operator_matmul(True)
    yield
    jbanded.set_operator_matmul(None)


@pytest.fixture(params=["matmul", "conv"])
def jax_path(request):
    """The JAX package's operator path (the port's counterpart), then its
    conv path (its CPU default)."""
    jbanded.set_operator_matmul(True if request.param == "matmul" else None)
    yield request.param
    jbanded.set_operator_matmul(None)


def rand(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _np(a):
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, dtype=np.float32)


def cmp(mine, ref, atol):
    """Same structure (None where None), same shapes, values within atol."""
    if ref is None:
        assert mine is None
        return
    if isinstance(ref, (list, tuple)):
        assert len(mine) == len(ref)
        for a, b in zip(mine, ref):
            cmp(a, b, atol)
        return
    assert tuple(mine.shape) == tuple(ref.shape)
    np.testing.assert_allclose(_np(mine), _np(ref), atol=atol)


def both(shape, seed=0, inv_kw=None, **kw):
    """Forward (and, with ``inv_kw``, inverse) of one input through both
    packages, compared; returns (x, JAX coefficients, port coefficients)."""
    x = rand(shape, seed)
    jf, pf = tw.DTCWTForward(**kw), tt.DTCWTForward(device="cpu", **kw)
    jy, py = jf(jnp.asarray(x)), pf(torch.from_numpy(x))
    cmp(py, jy, FWD_ATOL)
    if inv_kw is not None:
        ji = tw.DTCWTInverse(**inv_kw)
        pi = tt.DTCWTInverse(device="cpu", **inv_kw)
        cmp(pi(py), ji(jy), INV_ATOL)
    return x, jy, py


# ---------------------------------------------------------------------------
# DWT: one jitted JAX program per case (forward, its vjp, inverse, its vjp)
# ---------------------------------------------------------------------------

DWT_ATOL = 1e-5      # the JAX suite's DWT tolerance (tests/test_dwt.py:18)
DWT_MODES = ("zero", "symmetric", "reflect", "periodization", "periodic")


def _jax_dwt_case(x, cts, ct_rec, wave, mode, J, path, one_d):
    """JAX's forward, the forward's vjp of ``cts``, the inverse and the
    inverse's vjp of ``ct_rec``.  ``path`` is static so that each JAX path
    (read while tracing) gets its own trace."""
    from pytorch_wavelets_tpu.transforms import dwt as jdwt
    fwd, inv = ((jdwt.dwt1d, jdwt.idwt1d) if one_d
                else (jdwt.dwt2d, jdwt.idwt2d))
    (yl, yh), vf = jax.vjp(lambda v: fwd(v, wave, J, mode), x)
    gx, = vf(cts)
    rec, vi = jax.vjp(lambda c: inv(c, wave, mode), (yl, yh))
    (gyl, gyh), = vi(ct_rec)
    return (yl, yh), gx, rec, (gyl, gyh)


# Each case is a new program of a few small convolutions, whose XLA
# compile time dominates its run: compiled without LLVM's optimisation
# passes (for these programs only).
_jax_dwt_jit = jax.jit(_jax_dwt_case, static_argnums=(3, 4, 5, 6, 7),
                       compiler_options={
                           "xla_backend_optimization_level": 0,
                           "xla_llvm_disable_expensive_passes": True})


DWT_SHAPES = ((2, 3, 32, 32), (1, 2, 33, 29))


def dwt_grid(waves):
    """(jax_path, wave, mode, shape) cases: the conv path (the JAX package's
    CPU default and the semantics source) at both DWT_SHAPES, the operator
    path at the square even one, since its operator probes (one per axis
    length and level) dominate the JAX side's time."""
    return [(path, wave, mode, shape) for wave in waves for mode in DWT_MODES
            for path, shape in (("conv", DWT_SHAPES[0]),
                                ("conv", DWT_SHAPES[1]),
                                ("matmul", DWT_SHAPES[0]))]


def dwt_parity(shape, wave, mode, J, path, one_d=False, seed=0):
    """One input (and random cotangents) through the JAX package and the
    port's CPU modules: forward, inverse, the forward's gradient and the
    inverse's gradients (the reference-semantics backwards), compared at
    DWT_ATOL.  ``wave`` must be hashable (a name or a tuple of tuples)."""
    x = rand(shape, seed)
    fcls, icls = ((tt.DWT1DForward, tt.DWT1DInverse) if one_d
                  else (tt.DWTForward, tt.DWTInverse))
    f = fcls(J=J, wave=wave, mode=mode, device="cpu")
    i = icls(wave=wave, mode=mode, device="cpu")
    xt = torch.from_numpy(x).requires_grad_()
    yl, yh = f(xt)
    outs = [yl, *yh]
    cts = [rand(o.shape, seed + 1 + k) for k, o in enumerate(outs)]
    gx = torch.autograd.grad(outs, xt, [torch.from_numpy(c) for c in cts])[0]
    leaves = [o.detach().requires_grad_() for o in outs]
    rec = i((leaves[0], leaves[1:]))
    ct_rec = rand(rec.shape, seed + 99)
    grads = torch.autograd.grad(rec, leaves, torch.from_numpy(ct_rec))

    jcts = (jnp.asarray(cts[0]), [jnp.asarray(c) for c in cts[1:]])
    (jyl, jyh), jgx, jrec, (jgyl, jgyh) = _jax_dwt_jit(
        jnp.asarray(x), jcts, jnp.asarray(ct_rec), wave, mode, J, path,
        one_d)
    cmp(outs, [jyl, *jyh], DWT_ATOL)
    cmp(gx, jgx, DWT_ATOL)
    cmp(rec, jrec, DWT_ATOL)
    cmp(list(grads), [jgyl, *jgyh], DWT_ATOL)
