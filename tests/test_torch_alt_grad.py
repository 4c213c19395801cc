"""The port's Selesnick DTCWT gradients on the CPU == ``jax.vjp`` of the
JAX package's: ``cplxdual2d`` (``mag`` on and off) and ``icplxdual2d``
(the DWT Functions' reference backwards, as the JAX custom VJPs),
``DTCWTForward2`` / ``DTCWTInverse2``, and the quad analyses, whose
autodiff in JAX is the true transpose (``quad_afb2d``'s backward is K14's
adjoint, ``quad_afb2d_nonsep``'s too); within 2e-5."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_wavelets_tpu.filters import qshift as jqshift
from pytorch_wavelets_tpu.transforms import dtcwt_alt as ja
from pytorch_wavelets_tpu_torch.transforms import dtcwt_alt as pa
from tests.torch_parity import cmp, rand

torch.set_num_threads(1)

ATOL = 2e-5
_FAST = {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True}


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _flat(o)]
    return [out]


def _parity(jfn, pfn, x, seed):
    """x.grad of sum over outputs of out * G (random G) through both."""
    xt = torch.from_numpy(x).requires_grad_()
    outs = _flat(pfn(xt))
    cts = [rand(o.shape, seed + k) for k, o in enumerate(outs)]
    gx, = torch.autograd.grad(outs, xt, [torch.from_numpy(c) for c in cts])

    def both(v, cs):           # one XLA program: eager vjps are slower
        jouts, vjp = jax.vjp(jfn, v)
        leaves, tree = jax.tree.flatten(jouts)
        return leaves, vjp(jax.tree.unflatten(tree, cs))[0]
    leaves, jgx = jax.jit(both, compiler_options=_FAST)(
        jnp.asarray(x), [jnp.asarray(c) for c in cts])
    cmp(outs, leaves, ATOL)
    cmp(gx, jgx, ATOL)


@pytest.mark.parametrize("mode", ["periodization", "symmetric", "zero"])
@pytest.mark.parametrize("mag", [False, True])
def test_cplxdual2d_gradients(mode, mag):
    x = rand((2, 2, 24, 20), 30)
    _parity(lambda v: ja.cplxdual2d(v, 2, mode=mode, mag=mag),
            lambda v: pa.cplxdual2d(v, 2, mode=mode, mag=mag), x, 31)


@pytest.mark.parametrize("mode", ["periodization", "symmetric"])
def test_icplxdual2d_gradients(mode):
    """The gradient w.r.t. every coefficient of the inverse."""
    x = rand((1, 2, 24, 28), 32)
    lows, yh = ja.cplxdual2d(jnp.asarray(x), 2, mode=mode)
    leaves, tree = jax.tree.flatten((lows, yh))
    ct = rand(x.shape, 33)

    def inv_vjp(c, g):
        r, vjp = jax.vjp(lambda v: ja.icplxdual2d(*v, mode=mode), c)
        return r, jax.tree.leaves(vjp(g))
    jrec, jg = jax.jit(inv_vjp, compiler_options=_FAST)((lows, yh),
                                                        jnp.asarray(ct))
    mine = [torch.from_numpy(np.array(v)).requires_grad_() for v in leaves]
    pl, py = jax.tree.unflatten(tree, mine)
    rec = pa.icplxdual2d(pl, py, mode=mode)
    cmp(rec, jrec, ATOL)
    cmp(list(torch.autograd.grad(rec, mine, torch.from_numpy(ct))), jg, ATOL)


@pytest.mark.parametrize("kw", [dict(), dict(qshift="qshift_b",
                                             mode="periodization", J=2)])
def test_dtcwt2_module_gradients(kw):
    """The round trip's gradient (all coefficients and the
    reconstruction) w.r.t. x, through the modules."""
    inv_kw = {k: v for k, v in kw.items() if k != "J"}
    jf, ji = ja.DTCWTForward2(**kw), ja.DTCWTInverse2(**inv_kw)
    pf = pa.DTCWTForward2(device="cpu", **kw)
    pi = pa.DTCWTInverse2(device="cpu", **inv_kw)
    x = rand((1, 2, 32, 28), 34)
    _parity(lambda v: (jf(v), ji(jf(v))), lambda v: (pf(v), pi(pf(v))), x,
            35)


@pytest.mark.parametrize("mode", ["zero", "symmetric", "reflect",
                                  "periodization"])
@pytest.mark.parametrize("nonsep", [False, True])
@pytest.mark.parametrize("shape", [(2, 2, 22, 18), (1, 2, 9, 7),
                                   (1, 2, 5, 8)])
def test_quad_gradients(mode, nonsep, shape):
    """quad_afb2d (backward K14's adjoint on the separable split's plan,
    whose 'periodization' axes shorter than the filter fold once: W in
    9x7, both axes in 5x8) and quad_afb2d_nonsep."""
    h0a, h0b, _, _, h1a, h1b, _, _ = jqshift("qshift_a")
    bank = (h0a, h1a, h0b, h1b)
    jfn, pfn = ((ja.quad_afb2d_nonsep, pa.quad_afb2d_nonsep) if nonsep
                else (ja.quad_afb2d, pa.quad_afb2d))
    _parity(lambda v: jfn(v, *bank, mode=mode),
            lambda v: pfn(v, *bank, mode=mode), rand(shape, 36), 37)


@pytest.mark.parametrize("mode", ["zero", "symmetric", "reflect",
                                  "periodization"])
@pytest.mark.parametrize("shape", [(2, 2, 13, 10), (1, 2, 5, 3)])
def test_afb2d_gradients(mode, shape):
    """The public afb2d, whose backward is quad_afb2d's (K14's adjoint on
    the separable split's plan): db4 columns and db2 rows (Ly != Lx), the
    single fold of 'periodization' on both axes of 5x3."""
    from pytorch_wavelets_tpu.filters import wavelet
    from pytorch_wavelets_tpu.ops import afb_sfb as jafb
    from pytorch_wavelets_tpu_torch.ops import afb_sfb as pafb
    c, r = wavelet("db4"), wavelet("db2")
    bank = (c.dec_lo, c.dec_hi, r.dec_lo, r.dec_hi)
    _parity(lambda v: jafb.afb2d(v, *bank, mode=mode),
            lambda v: pafb.afb2d(v, *bank, mode=mode), rand(shape, 38), 39)


@pytest.mark.parametrize("mode,shape", [
    *[(m, (2, 2, 4, 9, 7)) for m in ("zero", "symmetric", "reflect",
                                     "periodization")],
    ("periodization", (1, 2, 4, 2, 3))])
def test_sfb2d_gradients(mode, shape):
    """The public sfb2d (backward K15's adjoint on the separable plan),
    w.r.t. the 4 bands: db4 columns and db2 rows, and on 2x3 bands the
    'periodization' tail of db4 longer than the 4 rows it wraps onto."""
    from pytorch_wavelets_tpu.filters import wavelet
    from pytorch_wavelets_tpu.ops import afb_sfb as jafb
    from pytorch_wavelets_tpu_torch.ops import afb_sfb as pafb
    c, r = wavelet("db4"), wavelet("db2")
    bank = (c.rec_lo, c.rec_hi, r.rec_lo, r.rec_hi)
    _parity(lambda v: jafb.sfb2d(*(v[:, :, i] for i in range(4)), *bank,
                                 mode=mode),
            lambda v: pafb.sfb2d(*v.unbind(2), *bank, mode=mode),
            rand(shape, 40), 41)


@pytest.mark.parametrize("mode", ["zero", "symmetric", "periodization"])
@pytest.mark.parametrize("axis", [2, 3])
def test_atrous_split_gradients(mode, axis):
    """The public afb1d_atrous and afb2d_atrous (backward K12's adjoint)
    at dilation 2."""
    from pytorch_wavelets_tpu.filters import wavelet
    from pytorch_wavelets_tpu.ops import afb_sfb as jafb
    from pytorch_wavelets_tpu_torch.ops import afb_sfb as pafb
    w = wavelet("db3")
    x = rand((2, 2, 11, 9), 42)
    _parity(lambda v: jafb.afb1d_atrous(v, w.dec_lo, w.dec_hi, mode, axis, 2),
            lambda v: pafb.afb1d_atrous(v, w.dec_lo, w.dec_hi, mode, axis, 2),
            x, 43)
    bank = (w.dec_lo, w.dec_hi) * 2
    _parity(lambda v: jafb.afb2d_atrous(v, *bank, mode, axis - 1),
            lambda v: pafb.afb2d_atrous(v, *bank, mode, axis - 1), x, 44)
