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
# the JAX references compiled without LLVM optimisation: the same
# arithmetic, compiled in a fraction of the time (compiling dominates
# their run at these sizes)
FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}


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
    ji = None if inv_kw is None else tw.DTCWTInverse(**inv_kw)

    def jax_side(v):           # one XLA program
        jy = jf(v)
        return jy, (None if ji is None else ji(jy))
    jy, jrec = jax.jit(jax_side, compiler_options=FAST)(jnp.asarray(x))
    py = pf(torch.from_numpy(x))
    cmp(py, jy, FWD_ATOL)
    if inv_kw is not None:
        pi = tt.DTCWTInverse(device="cpu", **inv_kw)
        cmp(pi(py), jrec, INV_ATOL)
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


# ---------------------------------------------------------------------------
# SWT: one jitted JAX program per case (forward, inverse and, with grads,
# the vjp of each)
# ---------------------------------------------------------------------------

SWT_MODES = ("zero", "symmetric", "reflect", "periodic", "periodization",
             "replicate")
SWT_PR_ATOL = 2e-4   # round trip, the JAX suite's (tests/test_swt.py:53)


def _jax_swt_case(x, cts, ct_rec, wave, mode, J, path, grads):
    """JAX's swt2d and iswt2d of its output; with ``grads`` also the vjp of
    ``cts`` through the forward and of ``ct_rec`` through the inverse.
    ``path`` is static so that each JAX path gets its own trace."""
    from pytorch_wavelets_tpu.transforms import dwt as jdwt
    if not grads:
        ys = jdwt.swt2d(x, wave, J, mode)
        return ys, None, jdwt.iswt2d(ys, wave, mode), None
    ys, vf = jax.vjp(lambda v: jdwt.swt2d(v, wave, J, mode), x)
    gx, = vf(cts)
    rec, vi = jax.vjp(lambda c: jdwt.iswt2d(c, wave, mode), ys)
    gc, = vi(ct_rec)
    return ys, gx, rec, gc


_jax_swt_jit = jax.jit(_jax_swt_case, static_argnums=(3, 4, 5, 6, 7),
                       compiler_options={
                           "xla_backend_optimization_level": 0,
                           "xla_llvm_disable_expensive_passes": True})


def iswt_ref64(ys, wave, mode):
    """The least-squares inverse SWT of the stacks ``ys`` in float64 numpy,
    built from the JAX package's own host-side operators (``_iswt_pinv``,
    ``_iswt_fft_filters``, ``_iswt_banded_ls``, the same branch per axis as
    its ``_ls_merge``) and none of the port: the reference that says how
    far each fp32 inverse is from the exact one."""
    from pytorch_wavelets_tpu.transforms import dwt as jdwt
    h0c, h1c, h0r, h1r = jdwt.dec_filters(wave)
    tc = (jdwt._tup(jdwt._rev(h0c)), jdwt._tup(jdwt._rev(h1c)))
    tr = (jdwt._tup(jdwt._rev(h0r)), jdwt._tup(jdwt._rev(h1r)))
    circular = mode in ("per", "periodization", "periodic")

    def apply(op, x, axis):                      # op along ``axis``
        return np.moveaxis(np.tensordot(op, np.moveaxis(x, axis, 0), 1),
                           0, axis)

    def merge(lo, hi, taps, d, axis):
        n = lo.shape[axis]
        if n <= jdwt._ISWT_PINV_MAX_N:
            return apply(jdwt._iswt_pinv(*taps, mode, d, n, False),
                         np.concatenate([lo, hi], axis), axis)
        if circular:
            g0, g1 = jdwt._iswt_fft_filters(*taps, d, n)
            shape = [1] * lo.ndim
            shape[axis] = -1
            z = (g0.reshape(shape) * np.fft.fft(lo, axis=axis)
                 + g1.reshape(shape) * np.fft.fft(hi, axis=axis))
            return np.fft.ifft(z, axis=axis).real
        Tt, Ginv = jdwt._iswt_banded_ls(*taps, mode, d, n, False)
        return apply(Ginv, apply(Tt, np.concatenate([lo, hi], axis), axis),
                     axis)

    ys = [np.asarray(y, np.float64) for y in ys]
    ll = ys[-1][:, :, 0]
    for j in range(len(ys) - 1, -1, -1):
        y, d = ys[j], 2 ** j
        lo = merge(ll, y[:, :, 1], tc, d, 2)
        hi = merge(y[:, :, 2], y[:, :, 3], tc, d, 2)
        ll = merge(lo, hi, tr, d, 3)
    return ll


def swt_parity(shape, wave, mode, J, path="conv", grads=False, seed=0):
    """One input through the JAX package (its conv path, or its operator
    path with ``path="matmul"``) and the port's CPU SWT modules: the
    stacks within DWT_ATOL; the port's inverse of JAX's stacks within
    INV_ATOL of the exact inverse of the same stacks (``iswt_ref64``, built
    from the JAX package's operators alone), and within INV_ATOL plus
    JAX's own distance to that exact inverse of JAX's inverse (its fp32
    rounding, which the least-squares merge amplifies where the operator
    is ill-conditioned, as in 'reflect' at J = 3 on a 16x16 image); the
    port's own round trip within SWT_PR_ATOL.  With ``grads``, the
    gradient w.r.t. x of the forward and w.r.t. the stacks of the inverse
    against ``jax.vjp``, within INV_ATOL."""
    x = rand(shape, seed)
    N, C, H, W = shape
    cts = [rand((N, C, 4, H, W), seed + 1 + k) for k in range(J)]
    ct_rec = rand(shape, seed + 99)
    jbanded.set_operator_matmul(True if path == "matmul" else None)
    try:
        jys, jgx, jrec, jgc = _jax_swt_jit(
            jnp.asarray(x), [jnp.asarray(c) for c in cts],
            jnp.asarray(ct_rec), wave, mode, J, path, grads)
    finally:
        jbanded.set_operator_matmul(None)
    f = tt.SWTForward(J=J, wave=wave, mode=mode, device="cpu")
    i = tt.SWTInverse(wave=wave, mode=mode, device="cpu")
    xt = torch.from_numpy(x).requires_grad_(grads)
    ys = f(xt)
    cmp(ys, jys, DWT_ATOL)
    with torch.no_grad():
        np.testing.assert_allclose(_np(i(ys)), x, atol=SWT_PR_ATOL)
    leaves = [torch.from_numpy(np.array(y)).requires_grad_(grads)
              for y in jys]
    rec = i(leaves)
    ref = iswt_ref64(jys, wave, mode)
    cmp(rec, ref, INV_ATOL)
    jax_err = float(np.abs(np.asarray(jrec, np.float64) - ref).max())
    cmp(rec, jrec, INV_ATOL + jax_err)
    if grads:
        gx = torch.autograd.grad(ys, xt, [torch.from_numpy(c)
                                          for c in cts])[0]
        cmp(gx, jgx, INV_ATOL)
        gc = torch.autograd.grad(rec, leaves, torch.from_numpy(ct_rec))
        cmp(list(gc), list(jgc), INV_ATOL)
