"""The index maps of kernels K8-K11 and of K2/K3's per-level mode,
emulated in numpy exactly as the CUDA sources (``csrc/dtcwt_filt.cu``,
``dtcwt_dfilt.cu``, ``dtcwt_ifilt.cu``, ``avg_pool2.cu``, ``q2c_pack.cu``,
``c2q_unpack.cu``) compute each output, against their plain versions
(the JAX conv path, ``ops/dtcwt_fb.py`` and ``ops/pool.py``) on the CPU:
the kernels' arithmetic is tested here without a card, at every axis
length 1..24 (K8; its column and row tiles also past one and two tiles),
4..24 (K9, multiples of 4; its column and row tiles also at 128 to
260), 2..24 (K10, even; its column and row tiles also past one and two
tiles) and every q-shift length, both parities of
m // 2 included."""
import numpy as np
import pytest
import torch

from pytorch_wavelets_tpu_torch.filters import qshift
from pytorch_wavelets_tpu_torch.ops import dtcwt_fb, pool, quad
from pytorch_wavelets_tpu_torch.ops.pad import pad_index

ULP2 = 2.5e-7   # two fp32 roundings of O(1) values: multiply vs divide

QSHIFTS = ("qshift_06", "qshift_a", "qshift_b", "qshift_c", "qshift_d",
           "qshift_32", "qshift_b_bp")


def _src(i, n, mode):
    """pad_src (csrc/dwt_index.cuh) at one position: ops/pad.py's
    pad_index, its host twin, for a padded position relative to x[0]."""
    front = max(0, -i)
    return int(pad_index(n, front, max(0, i - n + 1), mode)[i + front])


def pad_src_near(i, n, mode):
    """csrc/dwt_index.cuh:pad_src_near, line by line."""
    if 0 <= i < n:
        return i
    if mode == "zero":
        return -1
    return -1 - i if i < 0 else 2 * n - 1 - i


def test_pad_src_near():
    """The stencils' division-free reflection equals pad_src (the closed
    form of numpy.pad) wherever they take it: -n <= i < 2n."""
    for n in range(1, 13):
        for mode in ("symmetric", "zero"):
            ref = pad_index(n, n, n, mode)
            assert [pad_src_near(i, n, mode) for i in range(-n, 2 * n)] \
                == list(ref)


def _x(n, seed):
    return np.random.RandomState(seed).randn(n)


def _plain_1d(fn, x, *args):
    """A plain version along W of a (1, 1, 1, n) float64 tensor."""
    y = fn(torch.from_numpy(x).reshape(1, 1, 1, -1), *args)
    return y.reshape(-1).numpy()


def emulate_filt(x, t, mode):
    """K8: y[i] = sum_k t[k] x[src(i + k - m)], n + (L even) outputs."""
    n, L = len(x), len(t)
    m = L // 2
    out = np.zeros(n + 1 - L % 2)
    for i in range(len(out)):
        for k in range(L):
            r = _src(i - m + k, n, "symmetric" if mode == "symmetric"
                     else "zero")
            if r >= 0:
                out[i] += t[k] * x[r]
    return out


def emulate_dfilt(x, ha, hb, highpass):
    """K9: y[o] = sum_k h_s[k] x[src(4r + 2 + s + 2k - m)], s = hp ^ o&1."""
    n, m = len(x), len(ha)
    out = np.zeros(n // 2)
    for o in range(n // 2):
        s = int(highpass) ^ (o & 1)
        h = hb if s else ha
        s0 = 4 * (o >> 1) + 2 + s - m
        out[o] = sum(h[k] * x[_src(s0 + 2 * k, n, "symmetric")]
                     for k in range(m))
    return out


def emulate_ifilt(x, ha, hb, highpass):
    """K10: y[o] = sum_k h_f[2k + par] x[src(start + 2q + 2k - m/2)]."""
    n, m = len(x), len(ha)
    plan = dtcwt_fb.ifilt_plan(m, highpass)
    out = np.zeros(2 * n)
    for o in range(2 * n):
        f = o & 3
        start, par = plan[f]
        h = hb if f & 1 else ha
        s0 = start + 2 * (o >> 2) - m // 2
        out[o] = sum(h[2 * k + par] * x[_src(s0 + 2 * k, n, "symmetric")]
                     for k in range(m // 2))
    return out


# csrc/dtcwt_filt.cu's tiles: a column thread walks R outputs; a row
# block takes TW outputs of a row, staged in segments of TW + LT samples
R, TW = 8, 128


def filt_src(s, n, mode):
    """dtcwt_filt.cu:filt_src: pad_src_near within one axis length,
    pad_src past it."""
    if 0 <= s < n:
        return s
    if -n <= s < 2 * n:
        return pad_src_near(s, n, mode)
    return _src(s, n, mode)


def emulate_filt_col(x, t, mode):
    """K8's column kernel along one column: tiles of R outputs, the 2R
    rows of a block of R taps in registers, the next R loaded before the
    block's FMAs (rows never loaded are NaN: a read of one shows)."""
    n, L = len(x), len(t)
    m, nout = L // 2, n + 1 - L % 2

    def row(s):
        r = filt_src(s, n, mode)
        return x[r] if r >= 0 else 0.0
    out = np.full(nout, np.nan)
    for ti in range(-(-nout // R)):
        s0 = ti * R - m
        w = np.full(2 * R, np.nan)
        w[:R] = [row(s0 + o) for o in range(R)]
        acc = np.zeros(R)
        for kb in range(0, L, R):
            for q in range(R, 2 * R):
                if kb + q <= L + R - 2:
                    w[q] = row(s0 + kb + q)
            for kk in range(R):
                if kb + kk < L:
                    acc += t[kb + kk] * w[kk:kk + R]
            w[:R], w[R:] = w[R:], np.nan
        n_o = min(R, nout - ti * R)
        out[ti * R:ti * R + n_o] = acc[:n_o]
    return out


def emulate_filt_row(x, t, mode):
    """K8's row kernel along one row: blocks of TW outputs, each staging
    TW + LT samples from a0 = J0 - m - d (a multiple of 4; the chunks
    inside the row copied as they are, the rest mapped per sample), the
    taps shifted by d, each thread's 4 outputs from two float4 chunks."""
    n, L = len(x), len(t)
    m, nout = L // 2, n + 1 - L % 2
    d = (-m) % 4
    LT = -(-(L + d) // 4) * 4
    ts = np.zeros(LT)
    ts[d:d + L] = t
    out = np.full(nout, np.nan)
    for J0 in range(0, nout, TW):
        a0 = J0 - m - d
        assert a0 % 4 == 0
        seg = np.empty(TW + LT)
        for e in range(0, TW + LT, 4):
            pos = a0 + e
            if pos >= 0 and pos + 4 <= n:    # the 16-byte copy
                assert all(filt_src(pos + u, n, mode) == pos + u
                           for u in range(4))
                seg[e:e + 4] = x[pos:pos + 4]
            else:
                for u in range(4):
                    r = filt_src(pos + u, n, mode)
                    seg[e + u] = x[r] if r >= 0 else 0.0
        chunks = seg.reshape(-1, 4)
        for tx in range(TW // 4):
            j = J0 + 4 * tx
            if j >= nout:
                continue
            acc = np.zeros(4)
            cw = chunks[tx]
            for cb in range(LT // 4):
                nw = chunks[tx + cb + 1]
                e = np.concatenate([cw, nw])
                for kk in range(4):
                    if d <= 4 * cb + kk < d + L:
                        acc += ts[4 * cb + kk] * e[kk:kk + 4]
                cw = nw
            n_o = min(4, nout - j)
            out[j:j + n_o] = acc[:n_o]
    return out


FILT_PLANS = {"taps": emulate_filt, "columns": emulate_filt_col,
              "rows": emulate_filt_row}


@pytest.mark.parametrize("plan", list(FILT_PLANS))
@pytest.mark.parametrize("mode", ["symmetric", "zero"])
@pytest.mark.parametrize("L", [1, 2, 4, 5, 7, 13, 19, 30])
def test_filt_index_map(mode, L, plan):
    """K8 on every axis length 1..24, and its tiles' edges (one and two
    tiles of columns, a row block and one past it), as the taps define it
    and as the column and row kernels compute it."""
    t = _x(L, 100 + L)
    lengths = list(range(1, 25))
    if plan != "taps":
        lengths += [2 * R + 1, 127, 128, 129, 130, 257]
    for n in lengths:
        x = _x(n, n)
        np.testing.assert_allclose(
            FILT_PLANS[plan](x, t, mode),
            _plain_1d(dtcwt_fb.dtcwt_filt_plain, x, t, 3, mode),
            rtol=1e-12, atol=1e-12, err_msg=f"n={n}")


def _qtaps(name):
    q = qshift(name)
    # correlation order, as the level functions pass them
    return [dtcwt_fb.prep_taps(q[i]) for i in (0, 1, 4, 5)]


def _dfilt_windows(ha, hb):
    """K9's four quarter-phase windows w = 2 s + e: (A, d, T), tap j of
    output pair r reading sample 4 (r + j) + d[w] with T[w][0][j] = h_s[2
    j + e] (0 past m), as the entry builds them."""
    m = len(ha)
    A = (m + 1) // 2
    d = [2 + (w >> 1) + 2 * (w & 1) - m for w in range(4)]
    T = np.zeros((4, 1, A))
    for w in range(4):
        h = hb if w >> 1 else ha
        for j in range(A):
            k = 2 * j + (w & 1)
            T[w, 0, j] = h[k] if k < m else 0.0
    return A, d, T


def emulate_dfilt_col(x, ha, hb, highpass, V=1):
    """K9's column kernel along one column: chunks of R output pairs (R =
    DFILT_COL_PAIRS[V]), the four windows over rows 4 (r0 + e) + d[w] in
    turn (the symmetric map per loaded row), stream s stored at 2 r + (s
    ^ highpass); every output written once."""
    n = len(x)
    A, d, T = _dfilt_windows(ha, hb)
    R, npairs = dtcwt_fb.DFILT_COL_PAIRS[V], n // 4

    def row(s):
        return x[filt_src(s, n, "symmetric")]
    out = np.full(n // 2, np.nan)
    for r0 in range(0, npairs, R):
        acc = np.zeros((2, R))
        for w in range(4):
            acc[w >> 1] += _ifilt_window(
                lambda e, w=w: row(4 * (r0 + e) + d[w]), T[w], A, R)[0]
        for o in range(min(R, npairs - r0)):
            for s in (0, 1):
                i = 2 * (r0 + o) + (s ^ int(highpass))
                assert np.isnan(out[i])
                out[i] = acc[s, o]
    return out


def emulate_dfilt_row(x, ha, hb, highpass):
    """K9's row kernel along one row: segments of S output pairs
    (dfilt_row_pairs), each staged with its halo, 4 S + 2 m - 4 samples
    from 4 P0 + d[0] (row_run's walk inside the axis, which the map must
    agree with; row_gather's map of each sample gives the same values), a
    lane's DFILT_ROW_STEP pairs at a time from its staged row (reads 4
    apart), the interleave fixed per launch, the outputs through a shared
    row of odd pitch in the staged rows' space; the 32 lanes (rows) of a
    warp read and write on distinct banks."""
    n = len(x)
    A, d, T = _dfilt_windows(ha, hb)
    npairs, PR = n // 4, dtcwt_fb.DFILT_ROW_STEP
    S = dtcwt_fb.dfilt_row_pairs(npairs)
    assert S % PR == 0 and S <= dtcwt_fb.DFILT_ROW_PAIRS
    cmin = min(d)
    assert cmin == d[0]
    seg = max(d) + 4 * (A - 1) - cmin + 4 * (S - 1) + 1
    for pitch in (seg | 1, (2 * S) | 1):
        assert len({lane * pitch % 32 for lane in range(32)}) == 32
    hp = int(highpass)
    out = np.full(n // 2, np.nan)
    for P0 in range(0, npairs, S):
        first = 4 * P0 + cmin
        staged = stage_row(
            x, lambda e, first=first: filt_src(first + e, n, "symmetric"),
            first, seg)
        out_s = np.full(2 * S, np.nan)
        for item in range(S // PR):
            acc = np.zeros((2, PR))
            for w in range(4):
                base = d[w] - cmin + 4 * item * PR
                acc[w >> 1] += _ifilt_window(
                    lambda e, base=base: staged[base + 4 * e], T[w], A,
                    PR)[0]
            for o in range(PR):
                out_s[2 * (item * PR + o) + hp] = acc[0, o]
                out_s[2 * (item * PR + o) + (hp ^ 1)] = acc[1, o]
        cnt = 2 * min(S, npairs - P0)
        assert np.isnan(out[2 * P0:2 * P0 + cnt]).all()
        out[2 * P0:2 * P0 + cnt] = out_s[:cnt]
    return out


DFILT_PLANS = {
    "taps": emulate_dfilt,
    "columns": lambda *a: [emulate_dfilt_col(*a, V) for V in (1, 4)],
    "rows": lambda *a: [emulate_dfilt_row(*a)]}


@pytest.mark.parametrize("plan", list(DFILT_PLANS))
@pytest.mark.parametrize("name", QSHIFTS)
@pytest.mark.parametrize("highpass", [False, True])
def test_dfilt_index_map(name, highpass, plan):
    """K9 on every axis length 4..24 (multiples of 4) as the taps define
    it, and as its column tiles (chunks of 4 and 8 pairs) and row tiles
    (segments with their halo) compute it, also at 132 and 260 (one and
    two row segments, chunk and segment tails), and with 9 random taps
    (an odd m)."""
    h0a, h0b, h1a, h1b = _qtaps(name)
    ha, hb = (h1b, h1a) if highpass else (h0b, h0a)
    cases = [(n, ha, hb) for n in range(4, 25, 4)]
    if plan != "taps":
        cases += [(n, ha, hb) for n in (132, 260)]
        if name == QSHIFTS[0]:   # an odd m: the odd windows a tap short
            rs = np.random.RandomState(9)
            cases += [(n, rs.randn(9), rs.randn(9)) for n in (12, 132)]
    for n, ha, hb in cases:
        x = _x(n, n)
        want = _plain_1d(dtcwt_fb.dtcwt_dfilt_plain, x, ha, hb, highpass, 3)
        got = DFILT_PLANS[plan](x, ha, hb, highpass)
        for g in (got if plan != "taps" else [got]):
            np.testing.assert_allclose(g, want, rtol=1e-12, atol=1e-12,
                                       err_msg=f"n={n} m={len(ha)}")


# csrc/dtcwt_ifilt.cu's tiles: a column thread walks RC values of q; a row
# block takes TS values of q of 32 rows, a thread RQ of them
RC, RQ, TS = 4, 8, 32


def _ifilt_window(z, taps, Lz, R):
    """The window loop of K10's kernels for one pass: R values of q, the
    2R samples of a block of R taps, the next R read before the block's
    FMAs (samples never read are NaN: a use of one shows).  ``z(e)``
    gives window element e; ``taps`` the pass's two tap rows."""
    w = np.full(2 * R, np.nan)
    w[:R] = [z(o) for o in range(R)]
    acc = np.zeros((2, R))
    for kb in range(0, Lz, R):
        for q in range(R, 2 * R):
            if kb + q <= Lz + R - 2:
                w[q] = z(kb + q)
        for kk in range(R):
            if kb + kk < Lz:
                acc += taps[:, kb + kk:kb + kk + 1] * w[kk:kk + R]
        w[:R], w[R:] = w[R:], np.nan
    return acc


def emulate_ifilt_col(x, ha, hb, highpass):
    """K10's column kernel along one column: tiles of RC values of q, two
    passes (phases pi and pi + 2) over rows p + 2 (q + a + j), the
    symmetric map applied per loaded row."""
    n = len(x)
    passes, T = dtcwt_fb.ifilt_tap_rows(ha, hb, highpass)
    nq = (2 * n + 3) // 4

    def row(s):
        r = filt_src(s, n, "symmetric")
        return x[r] if r >= 0 else 0.0
    out = np.full(2 * n, np.nan)
    for q0 in range(0, nq, RC):
        for pi, (p, a, Lz, _) in enumerate(passes):
            s0 = p + 2 * (q0 + a)
            acc = _ifilt_window(lambda e: row(s0 + 2 * e),
                                T[[pi, pi + 2]], Lz, RC)
            for o in range(RC):
                for h in (0, 1):
                    r = 4 * (q0 + o) + pi + 2 * h
                    if r < 2 * n:
                        out[r] = acc[h, o]
    return out


def stage_row(x, src, first, count):
    """The row tiles' staging of one row: ``count`` samples, sample e from
    its source ``src(e)`` (0 where -1; row_gather); a segment inside the
    axis is row_run's walk first + e, which the map must agree with."""
    if first is not None and first >= 0 and first + count <= len(x):
        assert all(src(e) == first + e for e in range(count))
    return np.array([x[r] if r >= 0 else 0.0
                     for r in map(src, range(count))])


def emulate_ifilt_row(x, ha, hb, highpass):
    """K10's row kernel along one row: tiles of TS values of q, the
    segment staged with the symmetric map per sample (row_gather; inside
    the axis row_run's walk, which must agree), each thread's RQ values of
    q from its own
    row's samples 2 apart, the outputs through a shared row of 4 TS; the
    32 lanes (rows) of a warp read and write their rows on distinct banks
    (odd pitches)."""
    n = len(x)
    passes, T = dtcwt_fb.ifilt_tap_rows(ha, hb, highpass)
    cmin = min(p + 2 * a for p, a, _, _ in passes)
    seg = max(p + 2 * (a + Lz - 1) for p, a, Lz, _ in passes) - cmin + \
        2 * (TS - 1) + 1
    for pitch in (seg | 1, 4 * TS + 1):
        assert len({lane * pitch % 32 for lane in range(32)}) == 32
    nq = (2 * n + 3) // 4
    out = np.full(2 * n, np.nan)
    for Q0 in range(0, nq, TS):
        first = 2 * Q0 + cmin
        staged = stage_row(
            x, lambda e, first=first: filt_src(first + e, n, "symmetric"),
            first, seg)
        out_s = np.full(4 * TS, np.nan)
        for item in range(TS // RQ):
            for pi, (p, a, Lz, _) in enumerate(passes):
                base = p + 2 * a - cmin + 2 * item * RQ
                acc = _ifilt_window(lambda e: staged[base + 2 * e],
                                    T[[pi, pi + 2]], Lz, RQ)
                for o in range(RQ):
                    out_s[4 * (item * RQ + o) + pi] = acc[0, o]
                    out_s[4 * (item * RQ + o) + pi + 2] = acc[1, o]
        for e in range(4 * TS):
            if 4 * Q0 + e >= 2 * n:
                break
            out[4 * Q0 + e] = out_s[e]
    return out


IFILT_PLANS = {"taps": emulate_ifilt, "columns": emulate_ifilt_col,
               "rows": emulate_ifilt_row}


@pytest.mark.parametrize("plan", list(IFILT_PLANS))
@pytest.mark.parametrize("name", QSHIFTS)
@pytest.mark.parametrize("highpass", [False, True])
def test_ifilt_index_map(name, highpass, plan):
    """K10 on every even axis length 2..24, and its tiles' edges (one and
    two column tiles of RC values of q, one row tile and one past it), as
    the taps define it and as the column and row kernels compute it."""
    h0a, h0b, h1a, h1b = _qtaps(name)
    ha, hb = (h1b, h1a) if highpass else (h0b, h0a)
    lengths = list(range(2, 25, 2))
    if plan != "taps":
        lengths += [2 * TS, 2 * TS + 2, 4 * TS + 2]
    for n in lengths:
        x = _x(n, n)
        np.testing.assert_allclose(
            IFILT_PLANS[plan](x, ha, hb, highpass),
            _plain_1d(dtcwt_fb.dtcwt_ifilt_plain, x, ha, hb, highpass, 3),
            rtol=1e-12, atol=1e-12, err_msg=f"n={n}")


def test_ifilt_plan_parities():
    """Both branches of the plain version are reached: m // 2 odd for
    10/14/18-tap banks, even for qshift_c's 16 and qshift_32's 32."""
    assert {len(_qtaps(q)[0]) // 2 % 2 for q in QSHIFTS} == {0, 1}
    with pytest.raises(ValueError, match="even length"):
        dtcwt_fb.ifilt_plan(7, False)


def test_plain_versions_write_into_out():
    """The plain versions' ``out`` / ``accumulate``: the per-level
    inverse's sums in the order of the JAX package's."""
    x = torch.from_numpy(np.random.RandomState(1).randn(1, 2, 8, 6))
    t = _x(5, 2)
    a = dtcwt_fb.dtcwt_filt_plain(x, t, 2, "symmetric")
    wide = torch.zeros(1, 2, 8, 9, dtype=torch.float64)
    dtcwt_fb.dtcwt_filt_plain(x, t, 2, "symmetric", out=wide[..., 1:7])
    dtcwt_fb.dtcwt_filt_plain(x, t, 2, "symmetric", out=wide[..., 1:7],
                              accumulate=True)
    assert torch.equal(wide[..., 1:7], a + a)
    assert float(wide[..., 0].abs().max()) == 0.0
    with pytest.raises(ValueError, match="does not fit"):
        dtcwt_fb.dtcwt_filt_plain(x, t, 2, "symmetric", out=wide)


def emulate_pool(x):
    """K11: 0.25 * ((x00 + x01) + (x10 + x11)) in float32, the order the
    kernel's rounded intrinsics fix."""
    f = np.float32
    top = (x[..., 0::2, 0::2] + x[..., 0::2, 1::2]).astype(f)
    bot = (x[..., 1::2, 0::2] + x[..., 1::2, 1::2]).astype(f)
    return ((top + bot).astype(f) * f(0.25)).astype(f)


def test_pool_index_map():
    x = np.random.RandomState(3).randn(2, 3, 6, 10).astype(np.float32)
    assert np.array_equal(pool.avg_pool2_fwd_plain(torch.from_numpy(x))
                          .numpy(), emulate_pool(x))
    g = np.random.RandomState(4).randn(2, 3, 3, 5).astype(np.float32)
    dx = pool.avg_pool2_bwd_plain(torch.from_numpy(g)).numpy()
    ii, jj = np.indices((6, 10))
    assert np.array_equal(dx, g[..., ii >> 1, jj >> 1] * np.float32(0.25))
    with pytest.raises(ValueError, match="not even"):
        pool.avg_pool2_fwd(torch.zeros(1, 1, 5, 4))


def test_quad_interleaved_index_maps():
    """K2/K3's per-level addressing (member stride, 2 * the row and
    column strides, corner offsets 0, sw, sh, sh + sw, scale 1/sqrt2),
    emulated on flat storage, against the JAX q2c / c2q slicing.  The
    kernels multiply by fp32(1/sqrt2), as PyTorch divides by a scalar on
    the card; the CPU's plain versions divide: one rounding apart."""
    f = np.float32
    s = f(dtcwt_fb.INV_SQRT2)
    N, C, m, k = 2, 3, 4, 5
    orients = ((0, 5), (2, 3), (1, 4))
    wide = np.random.RandomState(5).randn(N, C, 3, 2 * m, 2 * k + 3) \
        .astype(f)
    y = wide[..., 1:1 + 2 * k]                      # a strided view
    out = torch.zeros(N, C, 6, m, k, 2)
    quad.q2c_pack(torch.from_numpy(y), out, orients, interleaved=True)
    flat = wide.ravel()
    st = np.array(y.strides) // 4
    off0 = 1                                        # y[0, 0, 0, 0, 0]
    for t, (o1, o2) in enumerate(orients):
        for i in range(m):
            for j in range(k):
                base = off0 + t * st[2] + i * 2 * st[3] + j * 2 * st[4]
                a, b, c, d = (flat[base + o] * s for o in
                              (0, st[4], st[3], st[3] + st[4]))
                want = (a - d, b + c, a + d, b - c)
                got = (out[0, 0, o1, i, j, 0], out[0, 0, o1, i, j, 1],
                       out[0, 0, o2, i, j, 0], out[0, 0, o2, i, j, 1])
                np.testing.assert_allclose([float(v) for v in got],
                                           [float(v) for v in want],
                                           rtol=ULP2, atol=ULP2)
    xq = quad.c2q_unpack(out, orients, interleaved=True).numpy()
    assert xq.shape == (N, C, 3, 2 * m, 2 * k)
    h = out.numpy()
    for t, (o1, o2) in enumerate(orients):
        w1r, w1i = h[:, :, o1, ..., 0], h[:, :, o1, ..., 1]
        w2r, w2i = h[:, :, o2, ..., 0], h[:, :, o2, ..., 1]
        for (p, q), v in (((0, 0), (w1r + w2r) * s),
                          ((0, 1), (w1i + w2i) * s),
                          ((1, 0), (w1i - w2i) * s),
                          ((1, 1), (w2r - w1r) * s)):
            np.testing.assert_allclose(xq[:, :, t, p::2, q::2], v,
                                       rtol=ULP2, atol=ULP2)
