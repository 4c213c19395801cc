"""The port's non-separable filterbanks (``afb2d_nonsep`` / ``sfb2d_nonsep``,
K14/K15's plain versions) and the à trous merge (``sfb1d_atrous`` /
``sfb2d_atrous``, K16's) on the CPU against the JAX package: outputs and
``jax.vjp`` gradients within 1e-5, every mode, odd sizes, Ly != Lx,
dilations 1, 2 and 4; the reconstructions JAX gives; the separable
equality; and the fp64 adjoint identity of the three autograd
Functions."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import adjoint_error
from pytorch_wavelets_tpu.ops import afb_sfb as jafb
from pytorch_wavelets_tpu_torch.filters import wavelet
from pytorch_wavelets_tpu_torch.ops import afb_sfb, nonsep
from tests.torch_parity import SWT_MODES, cmp, rand

torch.set_num_threads(1)

ATOL = 1e-5
NONSEP_MODES = ("zero", "symmetric", "reflect", "periodization")
_FAST = {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True}


def _tup(*fs):
    return tuple(tuple(float(v) for v in np.ravel(f)) for f in fs)


def _jax_nonsep_case(x, ct, c, ct2, fa, fs, mode):
    y, vf = jax.vjp(lambda v: jafb.afb2d_nonsep(v, *fa, mode=mode), x)
    z, vs = jax.vjp(lambda v: jafb.sfb2d_nonsep(v, *fs, mode=mode), c)
    return y, vf(ct)[0], z, vs(ct2)[0]


_jax_nonsep = jax.jit(_jax_nonsep_case, static_argnums=(4, 5, 6),
                      compiler_options=_FAST)


def nonsep_parity(shape, fa, fs, mode, seed=0):
    """afb2d_nonsep of x and sfb2d_nonsep of random bands of its output's
    shape, and the vjp of each, through both packages."""
    x = rand(shape, seed)
    xt = torch.from_numpy(x).requires_grad_()
    y = afb_sfb.afb2d_nonsep(xt, *fa, mode=mode)
    ct = rand(y.shape, seed + 1)
    c = rand(y.shape, seed + 2)
    ctt = torch.from_numpy(c).requires_grad_()
    z = afb_sfb.sfb2d_nonsep(ctt, *fs, mode=mode)
    ct2 = rand(z.shape, seed + 3)
    gx, = torch.autograd.grad(y, xt, torch.from_numpy(ct))
    gc, = torch.autograd.grad(z, ctt, torch.from_numpy(ct2))
    jy, jgx, jz, jgc = _jax_nonsep(jnp.asarray(x), jnp.asarray(ct),
                                   jnp.asarray(c), jnp.asarray(ct2),
                                   _tup(*fa), _tup(*fs), mode)
    cmp([y, gx, z, gc], [jy, jgx, jz, jgc], ATOL)
    return x, y


@pytest.mark.parametrize("mode", NONSEP_MODES)
@pytest.mark.parametrize("wave", ["db1", "db4", "bior2.2"])
@pytest.mark.parametrize("shape", [(2, 3, 16, 16), (1, 2, 13, 9)])
def test_nonsep_matches_jax(shape, wave, mode):
    w = wavelet(wave)
    nonsep_parity(shape, (w.dec_lo, w.dec_hi), (w.rec_lo, w.rec_hi), mode)


@pytest.mark.parametrize("mode", NONSEP_MODES)
def test_nonsep_rectangular_psfs(mode):
    """Column and row filters of different lengths (Ly = 8, Lx = 6)."""
    c, r = wavelet("db4"), wavelet("bior2.2")
    nonsep_parity((1, 2, 15, 18), (c.dec_lo, c.dec_hi, r.dec_lo, r.dec_hi),
                  (c.rec_lo, c.rec_hi, r.rec_lo, r.rec_hi), mode, seed=5)


@pytest.mark.parametrize("mode", NONSEP_MODES)
@pytest.mark.parametrize("wave", ["db1", "db4"])
def test_nonsep_equals_separable_and_reconstructs(wave, mode):
    """afb2d_nonsep equals the separable afb2d band for band, and
    sfb2d_nonsep inverts it, as in the JAX package."""
    w = wavelet(wave)
    x = torch.from_numpy(rand((2, 3, 32, 24), 7))
    y = afb_sfb.afb2d_nonsep(x, w.dec_lo, w.dec_hi, mode=mode)
    sep = afb_sfb.afb2d(x, w.dec_lo, w.dec_hi, w.dec_lo, w.dec_hi, mode)
    cmp(y, sep, ATOL)
    rec = afb_sfb.sfb2d_nonsep(y, w.rec_lo, w.rec_hi, mode=mode)
    cmp(rec, x, ATOL)


def _jax_atrous_case(lo, hi, st, ct, ct2, g, mode, d):
    z1, v1 = jax.vjp(lambda a, b: jafb.sfb1d_atrous(a, b, *g[:2], mode, 3,
                                                    d), lo, hi)
    z2 = jafb.sfb1d_atrous(lo, hi, *g[:2], mode, 2, d)
    z, vs = jax.vjp(lambda s: jafb.sfb2d_atrous(s, *g, mode, d), st)
    return z1, v1(ct), z2, z, vs(ct2)[0]


_jax_atrous = jax.jit(_jax_atrous_case, static_argnums=(5, 6, 7),
                      compiler_options=_FAST)


@pytest.mark.parametrize("mode", SWT_MODES)
@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("wave", ["db4", "bior2.2"])
def test_sfb_atrous_matches_jax(wave, d, mode):
    """sfb1d_atrous along W and H and sfb2d_atrous, with the vjps of the
    first and the last, on odd sizes (pads up to 16 samples on 11)."""
    w = wavelet(wave)
    g = (w.rec_lo, w.rec_hi, w.rec_lo, w.rec_hi)
    shape = (1, 2, 13, 11)
    lo, hi, ct = (rand(shape, s) for s in (10, 11, 12))
    st, ct2 = rand((1, 2, 4, 13, 11), 13), rand(shape, 14)
    lt, ht, stt = (torch.from_numpy(v).requires_grad_() for v in (lo, hi, st))
    z1 = afb_sfb.sfb1d_atrous(lt, ht, *g[:2], mode, 3, d)
    z2 = afb_sfb.sfb1d_atrous(lt, ht, *g[:2], mode, 2, d)
    z = afb_sfb.sfb2d_atrous(stt, *g, mode, d)
    g1 = torch.autograd.grad(z1, (lt, ht), torch.from_numpy(ct))
    gs, = torch.autograd.grad(z, stt, torch.from_numpy(ct2))
    jz1, jg1, jz2, jz, jgs = _jax_atrous(
        *(jnp.asarray(v) for v in (lo, hi, st, ct, ct2)), _tup(*g), mode, d)
    cmp([z1, list(g1), z2, z, gs], [jz1, list(jg1), jz2, jz, jgs], ATOL)


@pytest.mark.parametrize("d", [1, 2, 4])
def test_sfb2d_atrous_inverts_in_periodization(d):
    """The classic shift-averaged synthesis inverts the à trous analysis
    for a periodic extension only (the JAX package's own finding)."""
    w = wavelet("db4")
    x = torch.from_numpy(rand((2, 3, 32, 24), 15))
    y = afb_sfb.afb2d_atrous(x, w.dec_lo, w.dec_hi, w.dec_lo, w.dec_hi,
                             "periodization", d)
    rec = afb_sfb.sfb2d_atrous(y, w.rec_lo, w.rec_hi, w.rec_lo, w.rec_hi,
                               "periodization", d)
    cmp(rec, x, ATOL)


def _r(shape, seed):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape))


@pytest.mark.parametrize("mode", NONSEP_MODES)
@pytest.mark.parametrize("K,Ly,Lx,shape", [(4, 8, 6, (2, 3, 11, 9)),
                                           (16, 10, 10, (1, 2, 6, 13))])
def test_nonsep_functions_are_adjoint(mode, K, Ly, Lx, shape):
    """NonsepAFB on a strided input and NonsepSFB, float64: the backward
    is the exact transpose (pads longer than 6 samples included)."""
    f = np.random.RandomState(16).randn(K, Ly, Lx)
    x = _r((shape[0], shape[1], 2, *shape[2:]), 17)[:, :, 1]
    x.requires_grad_()
    y = nonsep.NonsepAFB.apply(x, f, mode)
    g = _r(y.shape, 18)
    gx, = torch.autograd.grad(y, x, g)
    assert adjoint_error([y], [g], [x], [gx]) < 1e-12
    smode = "periodic" if mode == "reflect" else mode
    c = _r((shape[0], shape[1], 4, 7, 8), 19).requires_grad_()
    z = nonsep.NonsepSFB.apply(c, f[:4], smode)
    g = _r(z.shape, 20)
    gc, = torch.autograd.grad(z, c, g)
    assert adjoint_error([z], [g], [c], [gc]) < 1e-12


@pytest.mark.parametrize("mode", SWT_MODES)
@pytest.mark.parametrize("axis", [2, 3])
def test_sfb_atrous_function_is_adjoint(mode, axis):
    """_SFB1DAtrous at dilation 4 on two bands of a stack, float64."""
    g0, g1 = np.random.RandomState(21).randn(2, 6)
    st = _r((2, 3, 4, 9, 7), 22).requires_grad_()
    z = afb_sfb._SFB1DAtrous.apply(st[:, :, 2], st[:, :, 0], g0, g1, mode,
                                   axis, 4)
    g = _r(z.shape, 23)
    gs, = torch.autograd.grad(z, st, g)
    assert adjoint_error([z], [g], [st[:, :, (2, 0)]],
                         [gs[:, :, (2, 0)]]) < 1e-12
