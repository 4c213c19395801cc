"""The port's DTCWT gradients (CPU, plain path, through the pyramids'
autograd Functions) == the JAX package's ``jax.vjp``, at the JAX suite's
DTCWT tolerance, with the JAX operator path forced (the counterpart) and
with its conv path; and the two Functions' own backwards checked by
float64 gradcheck and by the adjoint identity."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pytorch_wavelets_tpu as tw

import pytorch_wavelets_tpu_torch as tt
from pytorch_wavelets_tpu_torch.ops import fused_dtcwt
from pytorch_wavelets_tpu_torch.transforms import dtcwt as pdt
from pytorch_wavelets_tpu_torch.transforms.dtcwt_xfm import (
    dtcwt_fwd_filters, dtcwt_inv_filters,
)
from chip_smoke import adjoint_error
from tests.torch_parity import jax_path, rand  # noqa: F401

torch.set_num_threads(1)

ATOL = 2e-5          # the JAX suite's DTCWT tolerance (tests/test_dtcwt.py)
CPU = torch.device("cpu")


def _leaves(tree):
    """The arrays of a nested (list/tuple) output, None entries skipped."""
    if tree is None:
        return []
    if isinstance(tree, (list, tuple)):
        return [a for t in tree for a in _leaves(t)]
    return [tree]


def _close(mine, ref):
    assert tuple(mine.shape) == tuple(ref.shape)
    np.testing.assert_allclose(mine.detach().numpy(), np.asarray(ref),
                               atol=ATOL)


def _jax_vjp(fn, primals, cts_of):
    """JAX outputs and the gradients of sum(out * ct) w.r.t. ``primals``."""
    out = jax.eval_shape(fn, *primals)
    cts = cts_of(out)

    def f(*p):
        o, vjp = jax.vjp(fn, *p)
        return o, vjp(cts)
    return jax.jit(f)(*primals)


def _cts(seed, drop=()):
    """Cotangents for an output tree, made from a numpy seed: zeros for the
    leaves numbered in ``drop`` (the port leaves those out of the loss)."""
    def make(out):
        leaves, treedef = jax.tree.flatten(out)
        cts = [jnp.zeros(a.shape, a.dtype) if k in drop
               else jnp.asarray(rand(a.shape, seed + k))
               for k, a in enumerate(leaves)]
        return jax.tree.unflatten(treedef, cts)
    return make


def _loss(outs, cts, drop=()):
    return sum((o * torch.from_numpy(np.array(c))).sum()
               for k, (o, c) in enumerate(zip(outs, cts)) if k not in drop)


@pytest.mark.parametrize("shape,kw,drop", [
    ((2, 3, 32, 32), dict(J=2), ()),
    ((1, 2, 32, 32), dict(J=2, o_dim=1, ri_dim=3), ()),
    ((1, 2, 32, 32), dict(J=3, include_scale=[True, False, True]), ()),
    # a band cotangent that is absent (leaf 1 = yh[0]) and a skipped level
    ((1, 2, 32, 32), dict(J=3, skip_hps=[False, True, False]), (1,)),
    ((1, 2, 30, 34), dict(J=2), ()),           # odd pads
])
def test_forward_gradient(jax_path, shape, kw, drop):
    x = rand(shape, 1)
    jf, pf = tw.DTCWTForward(**kw), tt.DTCWTForward(device="cpu", **kw)
    jout, (jgx,) = _jax_vjp(jf, (jnp.asarray(x),), _cts(10, drop))
    xt = torch.from_numpy(x).requires_grad_()
    pout = _leaves(pf(xt))
    jleaves = _leaves(jout)
    for a, b in zip(pout, jleaves):
        _close(a, b)
    _loss(pout, _leaves(_cts(10, drop)(jout)), drop).backward()
    _close(xt.grad, jgx)


@pytest.mark.parametrize("kw,drop_level", [
    (dict(), None), (dict(o_dim=1, ri_dim=3), 1)])
def test_inverse_gradient(jax_path, kw, drop_level):
    x = rand((1, 2, 32, 32), 2)
    yl, yh = tt.DTCWTForward(J=3, device="cpu", **kw)(torch.from_numpy(x))
    yl = yl.numpy()
    yh = [None if j == drop_level else h.numpy() for j, h in enumerate(yh)]
    ji, pi = tw.DTCWTInverse(**kw), tt.DTCWTInverse(device="cpu", **kw)
    jin = (jnp.asarray(yl), [None if h is None else jnp.asarray(h)
                             for h in yh])
    jout, (jg,) = _jax_vjp(ji, (jin,), _cts(20))
    pl = torch.from_numpy(yl).requires_grad_()
    ph = [None if h is None else torch.from_numpy(h).requires_grad_()
          for h in yh]
    rec = pi((pl, ph))
    _close(rec, jout)
    (rec * torch.from_numpy(rand(rec.shape, 20))).sum().backward()
    for mine, ref in zip([pl] + [h for h in ph if h is not None],
                         _leaves(jg)):
        _close(mine.grad, ref)


def test_round_trip_gradient_bf16_bands(jax_path):
    """x -> forward (bf16 band storage) -> inverse, odd size: the bf16
    cotangent is upcast before the pyramid's backward."""
    x = rand((1, 2, 30, 34), 3)
    kw = dict(J=2, coeff_dtype="bfloat16")
    jf, ji = tw.DTCWTForward(**kw), tw.DTCWTInverse()
    _, (jg,) = _jax_vjp(lambda z: ji(jf(z)), (jnp.asarray(x),), _cts(30))
    xt = torch.from_numpy(x).requires_grad_()
    rec = tt.DTCWTInverse(device="cpu")(tt.DTCWTForward(device="cpu",
                                                        **kw)(xt))
    (rec * torch.from_numpy(rand(rec.shape, 30))).sum().backward()
    _close(xt.grad, jg)     # both round the same values to bf16


def _ops16():
    f, g = dtcwt_fwd_filters(), dtcwt_inv_filters()
    fwd = fused_dtcwt.analysis_operators(pdt._fwd_pyramid_plan(
        f["h0o"], f["h1o"], f["h0a"], f["h1a"], f["h0b"], f["h1b"], 2,
        (False, False), (True, False), "symmetric", 16, 16), CPU)
    inv = pdt.inv_pyramid_operators(
        g["g0o"], g["g1o"], g["g0a"], g["g1a"], g["g0b"], g["g1b"],
        "symmetric", (8, 8), ((8, 8), (4, 4)), CPU)
    return fwd, inv


def _analysis(ops):
    def fn(x):
        lls, yh = fused_dtcwt.analysis_pyramid(x, ops, 2, 5)
        return tuple(_leaves(lls) + _leaves(yh))
    return fn


def test_gradcheck_float64():
    fwd, inv = _ops16()
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 1, 16, 16, generator=g, dtype=torch.float64,
                    requires_grad=True)
    assert torch.autograd.gradcheck(_analysis(fwd), (x,), eps=1e-6,
                                    atol=1e-6, fast_mode=True)
    ins = [torch.randn(s, generator=g, dtype=torch.float64,
                       requires_grad=True)
           for s in ((1, 1, 8, 8), (1, 1, 6, 8, 8, 2), (1, 1, 6, 4, 4, 2))]
    assert torch.autograd.gradcheck(
        lambda ll, h1, h2: fused_dtcwt.synthesis_pyramid(ll, [h1, h2], inv),
        ins, eps=1e-6, atol=1e-6, fast_mode=True)


def test_adjoint_identity():
    """<A x, g> == <x, A^T g> for both pyramids in fp32, within 1e-6."""
    fwd, inv = _ops16()
    x = torch.from_numpy(rand((2, 3, 16, 16), 4)).requires_grad_()
    outs = _analysis(fwd)(x)
    gs = [torch.from_numpy(rand(o.shape, 5 + k)) for k, o in
          enumerate(outs)]
    grads = torch.autograd.grad(outs, x, gs)
    assert adjoint_error(outs, gs, [x], grads) <= 1e-6
    ins = [torch.from_numpy(rand(s, 6 + k)).requires_grad_() for k, s in
           enumerate(((2, 3, 8, 8), (2, 3, 6, 8, 8, 2), (2, 3, 6, 4, 4, 2)))]
    y = fused_dtcwt.synthesis_pyramid(ins[0], ins[1:], inv)
    gy = torch.from_numpy(rand(y.shape, 9))
    grads = torch.autograd.grad(y, ins, gy)
    assert adjoint_error([y], [gy], ins, grads) <= 1e-6


def test_zero_stride_cotangents():
    """.sum() hands the backwards expanded (zero-stride) cotangents; they
    give what the same cotangents in contiguous memory give."""
    x = torch.from_numpy(rand((1, 2, 16, 16), 7))
    f, i = tt.DTCWTForward(J=2, device="cpu"), tt.DTCWTInverse(device="cpu")

    def grad(reduce):
        xt = x.clone().requires_grad_()
        yl, yh = f(xt)
        (reduce(i((yl, yh))) + reduce(yh[1]) + reduce(yl)).backward()
        return xt.grad

    torch.testing.assert_close(
        grad(torch.sum), grad(lambda t: (t * torch.ones_like(t)).sum()),
        rtol=0, atol=0)
