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
from tests.test_torch_nonsep_plans import _merge_window
from tests.test_torch_stencil_plans import _src, stage_row
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


def _k7_src(j, nin, per):
    """csrc/dwt_sfb.cu:pair_src, line by line."""
    if 0 <= j < nin:
        return j
    return j + nin if per and -nin <= j < 0 else -1


def _k7_out(u, per, off, nin):
    """csrc/dwt_sfb.cu:pair_out, line by line."""
    n = u - off
    if per:
        n = n + 2 * nin if n < 0 else (n - 2 * nin if n >= 2 * nin else n)
    return n


def _k7_taps(g0, g1, A):
    """The entry's tap table: T[i][p][e] = g_i[2 (A - 1 - e) + p], 0 past
    L (input i, phase p, window element e)."""
    L = len(g0)
    T = np.zeros((2, 2, A))
    for i, g in enumerate((g0, g1)):
        for p in (0, 1):
            for e in range(A):
                k = 2 * (A - 1 - e) + p
                T[i, p, e] = g[k] if k < L else 0.0
    return T


def _k7_columns(lo, hi, g0, g1, mode, m_out, V):
    """pair_col_kernel along one column: chunks of R pairs (R =
    SFB_COL_PAIRS[V]) from m_lo, each input's register window over X(m0 -
    A + 1 + e) (the edge map per loaded row), both phases of each pair
    stored where pair_out lands inside the first m_out outputs; every
    output written once."""
    nin = len(lo)
    A, per, off, m_lo, npairs = afb_sfb.sfb_pairs(nin, len(g0), mode, m_out)
    R = afb_sfb.SFB_COL_PAIRS[V]
    T = _k7_taps(g0, g1, A)
    out = np.full(m_out, np.nan)
    for ch in range(-(-npairs // R)):
        m0 = m_lo + ch * R
        acc = sum(_merge_window(
            lambda e, x=x: (x[r] if (r := _k7_src(m0 - A + 1 + e, nin, per))
                            >= 0 else 0.0), T[i], R)
            for i, x in enumerate((lo, hi)))
        for o in range(R):
            if m0 + o >= m_lo + npairs:
                continue
            for p in (0, 1):
                n = _k7_out(2 * (m0 + o) + p, per, off, nin)
                if 0 <= n < m_out:
                    assert np.isnan(out[n])
                    out[n] = acc[p, o]
    return out


def _k7_rows(lo, hi, g0, g1, mode, m_out, unit=True):
    """pair_row_kernel along one row: segments of S pairs (sfb_row_pairs),
    each staged with its A - 1 samples of halo (row_run's walk inside the
    axis, which the edge map must agree with; row_gather maps each
    sample), a lane's SFB_ROW_STEP pairs at a time from its staged row,
    the outputs through a shared row of odd pitch, in the staged rows'
    space, and out as one run per segment; the 32 lanes (rows) of a warp
    read and write on distinct banks."""
    nin = len(lo)
    A, per, off, m_lo, npairs = afb_sfb.sfb_pairs(nin, len(g0), mode, m_out)
    RS, PR = afb_sfb.sfb_row_pairs(npairs), afb_sfb.SFB_ROW_STEP
    assert RS % PR == 0 and RS <= afb_sfb.SFB_ROW_PAIRS
    assert -(-npairs // RS) == -(-npairs // afb_sfb.SFB_ROW_PAIRS)
    seg = RS + A - 1
    assert 2 * (seg | 1) >= (2 * RS) | 1    # the outputs fit the rows' space
    for pitch in (seg | 1, (2 * RS) | 1):
        assert len({lane * pitch % 32 for lane in range(32)}) == 32
    T = _k7_taps(g0, g1, A)
    out = np.full(m_out, np.nan)
    for tile in range(-(-npairs // RS)):
        P0 = m_lo + tile * RS
        j0 = P0 - (A - 1)
        staged = [stage_row(x, lambda e: _k7_src(j0 + e, nin, per),
                            j0 if unit else None, seg) for x in (lo, hi)]
        out_s = np.full(2 * RS, np.nan)
        for item in range(RS // PR):
            acc = sum(_merge_window(lambda e, st=st: st[item * PR + e],
                                    T[i], PR) for i, st in enumerate(staged))
            for o in range(PR):
                out_s[2 * (item * PR + o):2 * (item * PR + o) + 2] = acc[:, o]
        for e in range(2 * min(RS, m_lo + npairs - P0)):
            n = _k7_out(2 * P0 + e, per, off, nin)
            if 0 <= n < m_out:
                assert np.isnan(out[n])
                out[n] = out_s[e]
    return out


def _k6_src(i, n, ne, mode):
    """csrc/dwt_afb.cu:afb_src, line by line (``mode`` the plan's)."""
    if 0 <= i < ne:
        r = i
    elif mode == "zero":
        return -1
    elif mode == "symmetric" and -ne <= i < 2 * ne:
        r = -1 - i if i < 0 else 2 * ne - 1 - i
    elif mode == "periodic" and -ne <= i < 2 * ne:
        r = i + ne if i < 0 else i - ne
    elif mode == "reflect" and -ne < i < 2 * ne - 1:
        r = -i if i < 0 else 2 * ne - 2 - i
    else:
        r = _src(i, ne, mode)
    return min(r, n - 1)


def _k6_setup(x, h0, h1, mode):
    """K6's tile plan: (A, front, X) with X(i) the sample position i reads
    (afb_src, 0 where -1), and the entry's tap table T[e][i][a] = h_i[2 a
    + e], 0 past L (window e, output i)."""
    n, L = len(x), len(h0)
    _, front, ne, pmode, shift, fold = afb_sfb.afb_plan(n, L, mode)
    assert shift == fold == 0
    A = (L + 1) // 2
    T = np.zeros((2, 2, A))
    for e in (0, 1):
        for i, h in enumerate((h0, h1)):
            for a in range(A):
                T[e, i, a] = h[2 * a + e] if 2 * a + e < L else 0.0

    def src(i):
        return _k6_src(i, n, ne, pmode)
    return A, front, T, src


def _k6_columns(x, h0, h1, mode, m_out, V):
    """afb_col_kernel along one column: chunks of R outputs (R =
    AFB_COL_OUTS[V]), the even and odd windows over X(2 (m0 + u) + e -
    front) (the edge map per loaded row), both feeding lo and hi; every
    output written once."""
    A, front, T, src = _k6_setup(x, h0, h1, mode)
    R = afb_sfb.AFB_COL_OUTS[V]
    out = np.full((2, m_out), np.nan)
    for m0 in range(0, m_out, R):
        acc = sum(_merge_window(
            lambda u, e=e: (x[r] if (r := src(2 * (m0 + u) + e - front))
                            >= 0 else 0.0), T[e], R) for e in (0, 1))
        for o in range(min(R, m_out - m0)):
            assert np.isnan(out[:, m0 + o]).all()
            out[:, m0 + o] = acc[:, o]
    return out


def _k6_rows(x, h0, h1, mode, m_out, unit=True):
    """afb_row_kernel along one row: segments of S outputs
    (afb_row_outs), each staged with its halo, 2 S + 2 A - 2 samples
    (row_run's walk inside the axis, which the edge map must agree with;
    row_gather maps each sample), a lane's AFB_ROW_STEP outputs at a time
    from its staged row (reads 2 apart), lo and hi through shared rows of
    odd pitch in the staged rows' space, and out as one run each; the 32
    lanes (rows) of a warp read and write on distinct banks."""
    A, front, T, src = _k6_setup(x, h0, h1, mode)
    S, PR = afb_sfb.afb_row_outs(m_out), afb_sfb.AFB_ROW_STEP
    assert S % PR == 0 and S <= afb_sfb.AFB_ROW_OUTS
    assert -(-m_out // S) == -(-m_out // afb_sfb.AFB_ROW_OUTS)
    seg = 2 * S + 2 * A - 2
    for pitch in (seg | 1, S | 1):
        assert len({lane * pitch % 32 for lane in range(32)}) == 32
    out = np.full((2, m_out), np.nan)
    for M0 in range(0, m_out, S):
        first = 2 * M0 - front
        staged = stage_row(x, lambda e, first=first: src(first + e),
                           first if unit else None, seg)
        out_s = np.full((2, S), np.nan)
        for item in range(S // PR):
            out_s[:, item * PR:(item + 1) * PR] = sum(_merge_window(
                lambda u, e=e: staged[e + 2 * item * PR + 2 * u], T[e], PR)
                for e in (0, 1))
        cnt = min(S, m_out - M0)
        assert np.isnan(out[:, M0:M0 + cnt]).all()
        out[:, M0:M0 + cnt] = out_s[:, :cnt]
    return out


def _k6_plan_case(plan, mode):
    rs = np.random.RandomState(PAD_CODES.get(mode, 5) + 60)
    for n, L in PLAN_CASES:
        h0, h1, x = rs.randn(L), rs.randn(L), rs.randn(n)
        want = afb_sfb.afb1d_corr_plain(torch.from_numpy(x).view(1, 1, 1, n),
                                        h0, h1, mode, 3)[0, 0, :, 0].numpy()
        full = want.shape[1]
        # the wrapper's pick for views of these lengths along the axis
        views = ({"row_run": torch.zeros(2, 3, 5, n + 2)[..., 1:n + 1],
                  "row_gather": torch.zeros(2, 3, n, 5).transpose(2, 3)}
                 if plan == "rows" else
                 {"col_float4": torch.zeros(2, 3, n, 8),
                  "col_scalar": torch.zeros(2, 3, n, 9)[..., 1:4]})
        folds = afb_sfb.afb_plan(n, L, mode)[5] > 0
        for name, v in views.items():
            if n == 1 and name == "row_gather":
                name = "row_run"    # one sample a row: stride 1 or not
            assert afb_sfb.afb_instantiation(
                3 if plan == "rows" else 2, n, L, mode, v) == (
                    "long_fold" if folds else name)
        if folds:   # the per-output kernel
            assert mode == "periodization" and L > n + n % 2
            np.testing.assert_allclose(_afb_emulated(x, h0, h1, mode), want,
                                       rtol=1e-12, atol=1e-12)
            continue
        for m_out in sorted({full, max(full - 3, 1)}):   # and a crop
            for got in ([_k6_columns(x, h0, h1, mode, m_out, V)
                         for V in (1, 4)] if plan == "columns" else
                        [_k6_rows(x, h0, h1, mode, m_out, unit)
                         for unit in (True, False)]):
                np.testing.assert_allclose(got, want[:, :m_out], rtol=1e-12,
                                           atol=1e-12, err_msg=f"{n} {L}")


# (length, L) of the tile plans: lengths 1, 2, odd, 70, 133, 259; L = 2,
# 3 (odd: a window position -1, or a zero tap), 8 (db4), 10 (farras /
# qshift_a), 13, 76 (db38: periodization's single fold of a long filter or
# tail on short axes)
PLAN_CASES = [(1, 2), (2, 3), (5, 8), (3, 10), (1, 8), (70, 8), (133, 10),
            (259, 8), (7, 13), (20, 76), (4, 76), (9, 3)]


def _k7_plan_case(plan, mode):
    rs = np.random.RandomState(PAD_CODES.get(mode, 5) + 40)
    for nin, L in PLAN_CASES:
        g0, g1, lo, hi = rs.randn(L), rs.randn(L), rs.randn(nin), rs.randn(nin)
        full = afb_sfb.sfb_plan(nin, L, mode)[0]
        if full < 1:
            continue
        t = [torch.from_numpy(v).view(1, 1, 1, nin) for v in (lo, hi)]
        want = afb_sfb.sfb1d_conv_plain(*t, g0, g1, mode, 3)[0, 0, 0].numpy()
        # the wrapper's pick for views of these lengths along the axis
        views = ({"row_run": torch.zeros(2, 3, 5, nin + 2)[..., 1:nin + 1],
                  "row_gather": torch.zeros(2, 3, nin, 5).transpose(2, 3)}
                 if plan == "rows" else
                 {"col_float4": torch.zeros(2, 3, nin, 8),
                  "col_scalar": torch.zeros(2, 3, nin, 9)[..., 1:4]})
        pairs = afb_sfb.sfb_pairs(nin, L, mode, full)
        for name, v in views.items():
            if nin == 1 and name == "row_gather":
                name = "row_run"    # one sample a row: stride 1 or not
            assert afb_sfb.sfb_instantiation(
                3 if plan == "rows" else 2, nin, L, mode, v, v) == (
                    name if pairs else "long_fold")
        if pairs is None:   # the per-output kernel
            assert L - 2 > 2 * nin
            np.testing.assert_allclose(_sfb_emulated(lo, hi, g0, g1, mode),
                                       want, rtol=1e-12, atol=1e-12)
            continue
        for m_out in sorted({full, max(full - 3, 1)}):   # and a crop
            for got in ([_k7_columns(lo, hi, g0, g1, mode, m_out, V)
                         for V in (1, 4)] if plan == "columns" else
                        [_k7_rows(lo, hi, g0, g1, mode, m_out, unit)
                         for unit in (True, False)]):
                np.testing.assert_allclose(got, want[:m_out], rtol=1e-12,
                                           atol=1e-12, err_msg=f"{nin} {L}")


@pytest.mark.parametrize("mode", DWT_MODES)
@pytest.mark.parametrize("plan", ["taps", "columns", "rows"])
def test_kernel_index_plans(plan, mode):
    """The formulas K6/K7 evaluate equal their plain versions (float64).
    ``taps``: per tap, at every length 1..13 and 33 against filters of 2
    to 76 taps, the long-filter single folds included (K6's and K7's
    long_fold).  ``columns`` / ``rows``: K6's polyphase tiles and K7's
    pair tiles (column chunks of 4 and 8 outputs or pairs; row segments
    with their halo, run and gather staging), the division-free edge and
    output maps in every mode, full outputs and crops, at lengths 1 to
    259, and the instantiation the wrapper picks for a view."""
    if plan != "taps":
        _k6_plan_case(plan, mode)
        _k7_plan_case(plan, mode)
        return
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
    with pytest.raises(TypeError, match="DeviceMesh"):
        tt.DWTForward(device="cpu", mesh=object())
    with pytest.raises(ValueError, match="is on cpu"):
        tt.DWTForward(device="cpu")(torch.zeros(1, 1, 8, 8, device="meta"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (tt.DWTForward, tt.DWTInverse, tt.DWT1DForward,
                tt.DWT1DInverse):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls()
