"""The DWT slice's host pieces: the port's wavelet tables == the JAX
package's, bit for bit; B9's index map == numpy.pad; the index plans that
kernels K6/K7 evaluate == their plain versions (emulated in numpy); the
filterbank ops == the JAX ops; taps carried over from JAX modules; the
module API (exports, aliases, device, mesh)."""
import functools
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pytorch_wavelets_tpu as tw
from pytorch_wavelets_tpu.filters import dwt_coeffs as jcoeffs
from pytorch_wavelets_tpu.ops import afb_sfb as jafb

import pytorch_wavelets_tpu_torch as tt
from pytorch_wavelets_tpu_torch.convert import dwt_filters_from_jax
from pytorch_wavelets_tpu_torch.filters import dwt_coeffs as pcoeffs
from pytorch_wavelets_tpu_torch.ops import afb_sfb
from pytorch_wavelets_tpu_torch.ops.pad import PAD_CODES, pad1d, pad_index
from pytorch_wavelets_tpu_torch.utils import dwt_coeff_len
from tests.torch_parity import DWT_ATOL, DWT_MODES, FAST, cmp, rand

torch.set_num_threads(1)

_NP_MODE = {"zero": "constant", "symmetric": "symmetric",
            "reflect": "reflect", "periodic": "wrap", "replicate": "edge"}


def test_wavelist_equal():
    assert pcoeffs.wavelist() == jcoeffs.wavelist()
    assert len(pcoeffs.wavelist()) == 88


@pytest.mark.parametrize("name", jcoeffs.wavelist())
def test_wavelet_bit_equal(name):
    a, b = jcoeffs.wavelet(name), pcoeffs.wavelet(name)
    assert a.name == b.name
    for f in ("dec_lo", "dec_hi", "rec_lo", "rec_hi"):
        u, v = getattr(a, f), getattr(b, f)
        assert u.dtype == v.dtype and u.shape == v.shape
        assert u.tobytes() == v.tobytes()


@pytest.mark.parametrize("mode", list(_NP_MODE))
def test_pad_index_matches_numpy(mode):
    """Every pad size up to 3n + 76 (db38's 76 taps on a tiny axis): the
    reflections repeat with numpy's periods."""
    for n in range(1, 13):
        a = np.arange(n)
        pads = sorted(set(range(0, 3 * n + 77, 5)) | {3 * n + 76})
        for front in pads:
            for back in pads:
                if mode == "zero":
                    want = np.pad(a + 1, (front, back)) - 1
                else:
                    want = np.pad(a, (front, back), mode=_NP_MODE[mode])
                np.testing.assert_array_equal(
                    pad_index(n, front, back, mode), want)


@pytest.mark.parametrize("mode", ["zero", "symmetric", "reflect",
                                  "periodic", "replicate"])
def test_pad1d(mode):
    x = torch.from_numpy(rand((1, 2, 5, 3), 1))
    y = pad1d(x, 7, 11, 2, mode)
    idx = pad_index(5, 7, 11, mode)
    want = x[:, :, np.maximum(idx, 0)] * torch.from_numpy(
        (idx >= 0).astype(np.float32))[:, None]
    assert torch.equal(y, want)


def _afb_emulated(x, h0, h1, mode):
    """K6's index math (afb_plan + pad_index) on a 1-D signal."""
    n, L = len(x), len(h0)
    out, front, ne, pmode, shift, fold = afb_sfb.afb_plan(n, L, mode)
    idx = pad_index(ne, front, 2 * out + L + 2 * ne, pmode)

    def X(q):
        p = idx[q]
        return np.where(p >= 0, x[np.minimum((p + shift) % ne, n - 1)], 0.)
    q = 2 * np.arange(out)[:, None] + np.arange(L)
    fold_q = (np.arange(out) < fold)[:, None] * X(q + ne)
    return np.stack([((X(q) + fold_q) * h).sum(1) for h in (h0, h1)])


def _sfb_emulated(lo, hi, g0, g1, mode):
    """K7's index math (sfb_plan, polyphase) on 1-D coefficients."""
    nin, L = len(lo), len(g0)
    out, s, wrap, r0, fold = afb_sfb.sfb_plan(nin, L, mode)

    def Y(u):
        j = np.arange(max(0, (u - L + 2) // 2), min(nin - 1, u // 2) + 1)
        return (lo[j] * g0[u - 2 * j] + hi[j] * g1[u - 2 * j]).sum()
    t = (np.arange(out) + r0) % wrap if wrap else np.arange(out)
    return np.array([Y(v + s) + (Y(v + s + wrap) if v < fold else 0.)
                     for v in t])


@pytest.mark.parametrize("mode", DWT_MODES)
def test_kernel_index_plans(mode):
    """The formulas K6/K7 evaluate per tap equal their plain versions
    (float64), at every length 1..13 and 33 against filters of 2 to 76
    taps, the long-filter single folds included."""
    rs = np.random.RandomState(PAD_CODES.get(mode, 5))
    for n in list(range(1, 14)) + [33]:
        for L in (2, 3, 4, 8, 13, 20, 76):
            h0, h1, x = rs.randn(L), rs.randn(L), rs.randn(n)
            want = afb_sfb.afb1d_corr_plain(
                torch.from_numpy(x).view(1, 1, 1, n), h0, h1, mode, 3)
            want = want[0, 0, :, 0].numpy()
            np.testing.assert_allclose(_afb_emulated(x, h0, h1, mode), want,
                                       rtol=1e-12, atol=1e-12)
            nin = dwt_coeff_len(n, L, mode)
            assert want.shape[1] == nin
            lo, hi = rs.randn(nin), rs.randn(nin)
            want = afb_sfb.sfb1d_conv_plain(
                torch.from_numpy(lo).view(1, 1, 1, nin),
                torch.from_numpy(hi).view(1, 1, 1, nin), h0, h1, mode, 3)
            np.testing.assert_allclose(_sfb_emulated(lo, hi, h0, h1, mode),
                                       want[0, 0, 0].numpy(), rtol=1e-12,
                                       atol=1e-12)


@pytest.mark.parametrize("mode", DWT_MODES)
def test_filterbank_ops(mode):
    """afb1d / sfb1d / afb2d / sfb2d == the JAX package's, at an odd
    size, with bior2.2's unequal filters."""
    w = tt.filters.wavelet("bior2.2")
    x = rand((2, 3, 19, 14), 3)
    band = jnp.asarray(x)

    @functools.partial(jax.jit, compiler_options=FAST)
    def ref(x):
        y1 = jafb.afb1d(x, w.dec_lo, w.dec_hi, mode, 2)
        y2 = jafb.afb2d(x, w.dec_lo, w.dec_hi, w.dec_lo, w.dec_hi, mode)
        s1 = jafb.sfb1d(x, x, w.rec_lo, w.rec_hi, mode, 3)
        s2 = jafb.sfb2d(x, x, x, x, w.rec_lo, w.rec_hi, w.rec_lo, w.rec_hi,
                        mode)
        return y1, y2, s1, s2
    xt = torch.from_numpy(x)
    mine = (afb_sfb.afb1d(xt, w.dec_lo, w.dec_hi, mode, 2),
            afb_sfb.afb2d(xt, w.dec_lo, w.dec_hi, w.dec_lo, w.dec_hi, mode),
            afb_sfb.sfb1d(xt, xt, w.rec_lo, w.rec_hi, mode, 3),
            afb_sfb.sfb2d(xt, xt, xt, xt, w.rec_lo, w.rec_hi, w.rec_lo,
                          w.rec_hi, mode))
    cmp(list(mine), list(ref(band)), DWT_ATOL)


def test_out_len_crops():
    x = torch.from_numpy(rand((1, 2, 9, 12), 4))
    h = np.random.RandomState(5).randn(2, 6)
    full = afb_sfb.afb1d_corr(x, h[0], h[1], "symmetric", 3)
    assert torch.equal(afb_sfb.afb1d_corr(x, h[0], h[1], "symmetric", 3, 4),
                       full[..., :4])
    full = afb_sfb.sfb1d_conv(x, x, h[0], h[1], "periodization", 2)
    assert torch.equal(afb_sfb.sfb1d_conv(x, x, h[0], h[1], "periodization",
                                          2, 5), full[:, :, :5])


@pytest.mark.parametrize("one_d", [False, True])
def test_filters_from_jax_modules(one_d):
    """The JAX modules' _filters, loaded into port modules built for
    another wavelet of the same length, give the JAX outputs."""
    fj, ij = ((tw.DWT1DForward, tw.DWT1DInverse) if one_d
              else (tw.DWTForward, tw.DWTInverse))
    fp, ip = ((tt.DWT1DForward, tt.DWT1DInverse) if one_d
              else (tt.DWTForward, tt.DWTInverse))
    jf, ji = fj(J=2, wave="sym4", mode="zero"), ij(wave="sym4", mode="zero")
    pf = fp(J=2, wave="db4", mode="zero", device="cpu")
    pi = ip(wave="db4", mode="zero", device="cpu")
    pf.load_state_dict(dwt_filters_from_jax(jf._filters))
    pi.load_state_dict(dwt_filters_from_jax(ji._filters, synthesis=True))
    x = rand((2, 3, 30) if one_d else (2, 3, 20, 18), 6)
    jy, jr = jax.jit(lambda x: (jf(x), ji(jf(x))),
                     compiler_options=FAST)(jnp.asarray(x))
    py = pf(torch.from_numpy(x))
    cmp(py, jy, DWT_ATOL)
    cmp(pi(py), jr, DWT_ATOL)
    with pytest.raises(ValueError, match="2- or 4-tuple"):
        dwt_filters_from_jax(jf._filters[:1])


def test_exports_and_aliases():
    for name in ("DWTForward", "DWTInverse", "DWT1DForward", "DWT1DInverse",
                 "DWT", "IDWT", "DWT2D", "IDWT2D", "DWT1D", "IDWT1D"):
        assert name in tt.__all__ and hasattr(tw, name)
    assert tt.DWT is tt.DWT2D is tt.DWTForward
    assert tt.IDWT is tt.IDWT2D is tt.DWTInverse
    assert tt.DWT1D is tt.DWT1DForward and tt.IDWT1D is tt.DWT1DInverse
    m = tt.DWTForward(J=2, wave="db2", device="cpu")
    assert sorted(m.state_dict()) == ["h0_col", "h0_row", "h1_col",
                                      "h1_row"]
    assert m.h0_col.dtype == torch.float64
    assert sorted(tt.DWT1DInverse(device="cpu").state_dict()) == ["g0", "g1"]


def test_device_and_mesh(monkeypatch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tt.DWTForward(device="cpu", mesh=object())
    with pytest.raises(ValueError, match="is on cpu"):
        tt.DWTForward(device="cpu")(torch.zeros(1, 1, 8, 8, device="meta"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (tt.DWTForward, tt.DWTInverse, tt.DWT1DForward,
                tt.DWT1DInverse):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls()
