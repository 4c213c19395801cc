"""The index maps of kernels K14 (``csrc/nonsep_afb.cu``), K15
(``csrc/nonsep_sfb.cu``; both run ``csrc/nonsep_tile.cuh``'s tiles) and
K16 (``csrc/swt_atrous.cu``: ``swt_sfb`` and its adjoint), emulated in
numpy exactly as the CUDA sources compute each output (the axis maps'
``src`` / ``cot``, the windows, the edge scans; the staged tiles and
parity planes, run by K14's forward through the pads and by K15's
adjoint through the synthesis's output map; the polyphase tiles, K14's
adjoint and K15's forward (the roll wrapped at the store), with the
edge bands read from the host's image tables; K16's column and row
tiles over d-strided subsequences and its adjoint's band from the
host's table), against their plain versions (the JAX code, and
autograd's transposes of it) on the CPU in float64: every mode, odd
sizes, filters longer than the axis, rectangular PSF stacks."""
import numpy as np
import pytest
import torch

from pytorch_wavelets_tpu_torch.ops import afb_sfb, nonsep
from pytorch_wavelets_tpu_torch.ops.pad import pad_index
from tests.test_torch_stencil_plans import stage_row

torch.set_num_threads(1)

TOL = dict(rtol=1e-12, atol=1e-12)


class AfbAxis:
    """csrc/nonsep_stencil.cuh:AfbAxis, line by line (src, cot), with the
    plan it is built from."""

    def __init__(self, n, L, mode, separable=False):
        self.out, self.front, self.code, self.per, self.shift = \
            nonsep.afb_axis_plan(n, L, mode, separable)
        self.n, self.L = n, L
        # the gather's virtual input: twice the rows under a single fold
        self.virtual = 2 * self.out if self.per == 2 else self.out
        self.umax = 2 * (self.virtual - 1) + L - 1

    def src(self, u):
        return int(nonsep.afb_axis_src(self.n, self.front, self.code,
                                       self.per, self.shift, u - self.front))

    def cot(self, j):
        return j if j < self.out else j - self.out


class SfbAxis:
    """csrc/nonsep_stencil.cuh:SfbAxis, line by line (src, cot)."""

    def __init__(self, nin, L, mode, separable=False):
        self.plan = nonsep._sfb_axis_plan(nin, L, mode, separable)
        self.out, self.s, self.wrap, self.r0, self.fold = self.plan
        self.per = mode in ("per", "periodization")
        self.virtual = None

    def cot(self, j):
        return j

    def src(self, u):
        if not self.per:
            v = u - self.s
            return v if 0 <= v < self.out else -1
        t = u
        if t >= self.wrap:
            t -= self.wrap
            if t >= self.fold or t >= self.wrap:
                return -1
        return (t - self.r0) % self.wrap


def gather_window(g, taps, ay, ax, u, v):
    """nonsep_stencil.cuh:gather_window: the taps of position (u, v)'s
    parities over the windows inside the (virtual) input, its rows and
    columns read through the maps' cot()."""
    K, Ly, Lx = taps.shape
    Hi, Wi = (a.virtual or n for a, n in zip((ay, ax), g.shape[1:]))
    acc = 0.0
    a0, a1 = max(u & 1, u - 2 * (Hi - 1)), min(Ly - 1, u)
    b0, b1 = max(v & 1, v - 2 * (Wi - 1)), min(Lx - 1, v)
    for a in range(a0, a1 + 1, 2):
        for b in range(b0, b1 + 1, 2):
            acc += (taps[:, a, b] * g[:, ay.cot((u - a) >> 1),
                                      ax.cot((v - b) >> 1)]).sum()
    return acc


PY = 4      # csrc/nonsep_tile.cuh: positions / quads a thread, along rows


def _padded_taps(f):
    """The taps as K14 stages them: Ly x Lx x KMAX, zeros past K."""
    K = f.shape[0]
    tp = np.zeros((*f.shape[1:], 4 if K <= 4 else 16))
    tp[..., :K] = f.transpose(1, 2, 0)
    return tp


def staged_tile(x, f, ay, ax, Ho, Wo, bx, by):
    """csrc/nonsep_tile.cuh:afb_tile_kernel on one (H, W) plane, tile by
    tile: the window staged (the axis maps' src applied per row and
    column, -1 as zero) into parity planes of ``_fwd_pitch``, each
    thread's PY rows of positions read back from it tap by tap; its first
    warp's reads fall on 32 distinct banks.  The pitch padding is NaN: a
    read of it shows."""
    K, Ly, Lx = f.shape
    tp = _padded_taps(f)
    rows, cols = 2 * PY * by + Ly - 2, 2 * bx + Lx - 2
    pitch = nonsep._fwd_pitch(cols, bx)
    plane = rows * pitch
    assert nonsep._fwd_smem(tp.shape[2], Ly, Lx, bx, by) == 4 * (
        tp.size + rows + cols + 2 * plane)
    ty, tx, i = np.meshgrid(range(by), range(bx), range(PY), indexing="ij")
    lane = ty * bx + tx
    for p in range(PY):     # the first warp, one read each
        offs = ((2 * (ty + by * i) * pitch + tx)[lane < 32])[
            i[lane < 32] == p]
        assert len(set(offs % 32)) == len(offs)
    out = np.full((K, Ho, Wo), np.nan)
    for oy0 in range(0, Ho, PY * by):
        for ox0 in range(0, Wo, bx):
            rs = [ay.src(2 * oy0 + r) for r in range(rows)]
            cs = [ax.src(2 * ox0 + q) for q in range(cols)]
            win = np.full(2 * plane, np.nan)
            for r in range(rows):
                for q in range(cols):
                    win[(q & 1) * plane + r * pitch + (q >> 1)] = (
                        x[rs[r], cs[q]] if rs[r] >= 0 and cs[q] >= 0
                        else 0.0)
            acc = np.zeros((by, bx, PY, tp.shape[2]))
            for a in range(Ly):
                for b in range(Lx):
                    v = win[(b & 1) * plane + (2 * (ty + by * i) + a) * pitch
                            + tx + (b >> 1)]
                    acc += v[..., None] * tp[a, b]
            oy, ox = oy0 + ty + by * i, ox0 + tx
            ok = (oy < Ho) & (ox < Wo)
            out[:, oy[ok], ox[ok]] = acc[ok][:, :K].T
    return out


def k14_forward(x, f, mode):
    """K14's forward: the staged tile through AfbAxis (the pads), the
    tile of afb_tile."""
    K, Ly, Lx = f.shape
    H, W = x.shape
    ay, ax = AfbAxis(H, Ly, mode), AfbAxis(W, Lx, mode)
    return staged_tile(x, f, ay, ax, ay.out, ax.out,
                       *nonsep.afb_tile(K, Ly, Lx, ay.out, ax.out))


def poly_tile(g, f, H, W, fy, fx, U0, nU, V0, nV, rot, bx, by):
    """csrc/nonsep_tile.cuh:afb_adjoint_tile_kernel on one (K, Hi, Wi)
    stack: quads U0 .. U0 + nU - 1 (x V), 2 x 2 positions each from the
    window staged K innermost (zero outside the stack), position u
    written to pixel u - fy (under rot wrapped once into [0, H), else
    only inside it); every pixel written once."""
    K, Ly, Lx = f.shape
    tp = _padded_taps(f)
    kmax = tp.shape[2]
    Ay, Ax = (Ly + 1) // 2, (Lx + 1) // 2
    rows, cols = PY * by + Ay - 1, bx + Ax - 1
    assert nonsep._adj_smem(kmax, Ly, Lx, bx, by) == 4 * (
        tp.size + kmax * rows * cols)
    gk = np.zeros((kmax, *g.shape[1:]))
    gk[:K] = g
    ty, tx, i = np.meshgrid(range(by), range(bx), range(PY), indexing="ij")
    out = np.full((H, W), np.nan)

    def pixel(u, n):
        if rot:
            u = np.where(u < 0, u + n, np.where(u >= n, u - n, u))
        return u, (u >= 0) & (u < n)
    for Ut in range(U0, U0 + nU, PY * by):
        for Vt in range(V0, V0 + nV, bx):
            o = Ut - (Ay - 1) + np.arange(rows)
            q = Vt - (Ax - 1) + np.arange(cols)
            okr = (o >= 0) & (o < g.shape[1])
            okc = (q >= 0) & (q < g.shape[2])
            w = np.zeros((kmax, rows, cols))
            w[:, okr[:, None] & okc[None, :]] = gk[:, o[okr]][
                :, :, q[okc]].reshape(kmax, -1)
            w = w.reshape(kmax // 4, 4, rows, cols).transpose(0, 2, 3, 1)
            acc = np.zeros((2, 2, by, bx, PY))
            for al in range(Ay):
                for be in range(Ax):
                    d = w[:, ty + by * i + Ay - 1 - al,
                          tx + Ax - 1 - be]     # (kmax/4, ..., 4)
                    d = np.moveaxis(d, 0, -2).reshape(*ty.shape, kmax)
                    for du in (0, 1):
                        for dv in (0, 1):
                            if 2 * al + du < Ly and 2 * be + dv < Lx:
                                acc[du, dv] += d @ tp[2 * al + du,
                                                      2 * be + dv]
            U, V = Ut + ty + by * i, Vt + tx
            for du in (0, 1):
                for dv in (0, 1):
                    ii, oki = pixel(2 * U + du - fy, H)
                    jj, okj = pixel(2 * V + dv - fx, W)
                    ok = (U < U0 + nU) & (V < V0 + nV) & oki & okj
                    assert np.isnan(out[ii[ok], jj[ok]]).all()
                    out[ii[ok], jj[ok]] = acc[du, dv][ok]
    assert not np.isnan(out).any()
    return out


def k14_adjoint(g, f, mode, H, W, separable=False):
    """csrc/nonsep_afb.cu's adjoint on one (K, Ho, Wo) cotangent: the
    polyphase tiles (afb_adjoint_tile_kernel: 2 x 2 pixels a quad, from
    the cotangent window staged K innermost, zero outside) write every
    pixel's direct-position sum; then the band (afb_adjoint_band_kernel)
    adds each pixel's other image pairs outside adjoint_interior, from
    band_images' tables; on a per-2 axis the band is every pixel and
    writes the whole gather.  Checks that each interior pixel has its
    direct position for only image."""
    K, Ly, Lx = f.shape
    ay, ax = AfbAxis(H, Ly, mode, separable), AfbAxis(W, Lx, mode, separable)
    iy = nonsep.adjoint_interior(H, Ly, mode, separable)
    ix = nonsep.adjoint_interior(W, Lx, mode, separable)
    for a, n, ii in ((ay, H, iy), (ax, W, ix)):
        u = np.arange(a.umax + 1)
        src = nonsep.afb_axis_src(n, a.front, a.code, a.per, a.shift,
                                  u - a.front)
        for t in range(*(ii or (0, 0))):
            assert list(u[src == t]) == [t + a.front]
    poly = iy is not None and ix is not None
    out = np.full((H, W), np.nan)
    if poly:
        fy, fx = ay.front, ax.front
        U0, V0 = fy // 2, fx // 2
        nU, nV = (H - 1 + fy) // 2 - U0 + 1, (W - 1 + fx) // 2 - V0 + 1
        out = poly_tile(g, f, H, W, fy, fx, U0, nU, V0, nV, False,
                        *nonsep.adjoint_tile(K, Ly, Lx, H, W, fy, fx))
    y0, y1 = iy or (0, 0)
    x0, x1 = ix or (0, 0)
    tab_y = nonsep.band_images(H, Ly, mode, separable)
    tab_x = nonsep.band_images(W, Lx, mode, separable)

    def images(t, lo, hi, front, tab):
        if lo <= t < hi:
            return [t + front]
        row = tab[t if t < lo else lo + t - hi]
        return list(row[row >= 0])
    for ty_ in range(H):
        for tx_ in range(W):
            if y0 <= ty_ < y1 and x0 <= tx_ < x1:
                continue
            uy, vx = ty_ + ay.front, tx_ + ax.front
            acc = sum(gather_window(g, f, ay, ax, u, v)
                      for u in images(ty_, y0, y1, ay.front, tab_y)
                      for v in images(tx_, x0, x1, ax.front, tab_x)
                      if not (poly and u == uy and v == vx))
            out[ty_, tx_] = out[ty_, tx_] + acc if poly else acc
    return out


def _sfb_positions(a, n, L, mode):
    """Along one axis of K15's forward: each pixel's positions, the direct
    one (the one the polyphase tile writes to it) first, as the band
    kernel reads them (its own for an interior pixel, else the row of
    sfb_band_images); checks the interior claim (one position each) and
    that the lists are exactly the positions src maps to the pixel."""
    f, U0, nU, rot = nonsep.sfb_quads(n, L, mode)
    assert rot == a.per
    lo, hi = nonsep.sfb_interior(n, L, mode)
    tab = nonsep.sfb_band_images(n, L, mode)
    u = np.arange(2 * n + L - 2)
    src = np.array([a.src(v) for v in u])
    lists = []
    for t in range(a.out):
        direct = (t + f) % a.out if rot else t + f
        assert 2 * U0 <= direct < 2 * (U0 + nU)
        if lo <= t < hi:
            row = [direct]
        else:
            row = tab[t if t < lo else lo + t - hi]
            assert (row[list(row).index(-1) if -1 in row else len(row):]
                    == -1).all()
            row = [int(v) for v in row if v >= 0]
            assert len(row) > 1
        assert row[0] == direct and sorted(row) == list(u[src == t])
        lists.append(row)
    return lists


def k15_forward(c, f, mode):
    """K15's forward on one (4, Ny, Nx) stack: the polyphase tile over
    the bands (sfb_quads: positions [s, s + out) outside 'periodization',
    every position of [0, wrap) once under the roll, wrapped at the
    store; the tile of sfb_tile), then the band: each pixel outside the
    interior rectangle adds the windows of its position pairs other than
    the direct one (gather_window over the host's lists)."""
    _, Ly, Lx = f.shape
    _, Ny, Nx = c.shape
    ay, ax = SfbAxis(Ny, Ly, mode), SfbAxis(Nx, Lx, mode)
    (fy, U0, nU, rot), (fx, V0, nV, _) = (nonsep.sfb_quads(Ny, Ly, mode),
                                          nonsep.sfb_quads(Nx, Lx, mode))
    out = poly_tile(c, f, ay.out, ax.out, fy, fx, U0, nU, V0, nV, rot,
                    *nonsep.sfb_tile(Ly, Lx, nU, nV))
    ly = _sfb_positions(ay, Ny, Ly, mode)
    lx = _sfb_positions(ax, Nx, Lx, mode)
    for ty in range(ay.out):
        for tx in range(ax.out):
            out[ty, tx] += sum(gather_window(c, f, ay, ax, u, v)
                               for i, u in enumerate(ly[ty])
                               for j, v in enumerate(lx[tx]) if i or j)
    return out


def k15_adjoint(g, f, mode, Ny, Nx, separable=False):
    """K15's adjoint on one (Hout, Wout) cotangent: K14's staged tile
    with SfbAxis (each staged row's and column's output sample, the
    separable plan's single fold included), the tile of afb_tile."""
    _, Ly, Lx = f.shape
    ay = SfbAxis(Ny, Ly, mode, separable)
    ax = SfbAxis(Nx, Lx, mode, separable)
    return staged_tile(g, f, ay, ax, Ny, Nx,
                       *nonsep.afb_tile(4, Ly, Lx, Ny, Nx))


def _f(K, Ly, Lx, seed):
    return np.random.RandomState(seed).randn(K, Ly, Lx)


CASES = [  # (K, Ly, Lx, H, W)
    (4, 2, 2, 6, 7), (4, 8, 8, 9, 12), (4, 8, 2, 7, 5), (16, 4, 6, 5, 8),
    (4, 12, 10, 3, 4), (1, 3, 5, 6, 6)]


@pytest.mark.parametrize("mode", ["zero", "symmetric", "reflect",
                                  "periodization"])
@pytest.mark.parametrize("K,Ly,Lx,H,W", CASES)
def test_k14_index_plans(mode, K, Ly, Lx, H, W):
    """K14's staged forward tiles and its polyphase adjoint with the edge
    band: odd axes (periodization's evening), filters longer than the
    axis (pads of several periods), Ly != Lx, K = 1, 4, 16, odd
    lengths."""
    f = _f(K, Ly, Lx, 1)
    x = np.random.RandomState(2).randn(H, W)
    want = nonsep.nonsep_afb_plain(torch.from_numpy(x)[None, None], f,
                                   mode)[0, 0].numpy()
    np.testing.assert_allclose(k14_forward(x, f, mode), want, **TOL)
    g = np.random.RandomState(3).randn(*want.shape)
    want = nonsep.nonsep_afb_adjoint_plain(
        torch.from_numpy(g)[None, None], f, mode, H, W)[0, 0].numpy()
    np.testing.assert_allclose(k14_adjoint(g, f, mode, H, W), want, **TOL)


@pytest.mark.parametrize("mode", ["zero", "symmetric", "reflect",
                                  "periodization"])
@pytest.mark.parametrize("K,Ly,Lx,H,W", CASES + [(16, 10, 10, 9, 5),
                                                (4, 12, 3, 10, 1)])
def test_k14_separable_adjoint_plan(mode, K, Ly, Lx, H, W):
    """K14's adjoint on the separable split's plan (quad_afb2d's
    backward): the same as the plain plan except where 'periodization'
    meets a filter longer than the evened axis (the single fold, on one
    axis or both); and the plain map it transposes is the separable
    split itself for outer products."""
    f = _f(K, Ly, Lx, 8)
    ay, ax = AfbAxis(H, Ly, mode, True), AfbAxis(W, Lx, mode, True)
    g = np.random.RandomState(9).randn(K, ay.out, ax.out)
    want = nonsep.nonsep_afb_adjoint_plain(
        torch.from_numpy(g)[None, None], f, mode, H, W, True)[0, 0].numpy()
    np.testing.assert_allclose(k14_adjoint(g, f, mode, H, W, True), want,
                               **TOL)
    r = np.random.RandomState(10)
    h = [r.randn(L) for L in (Ly, Ly, Lx, Lx)]
    outer = np.stack([np.outer(h[i], h[2 + j]) for j in (0, 1)
                      for i in (0, 1)])
    x = torch.from_numpy(r.randn(2, 3, H, W))
    torch.testing.assert_close(
        nonsep.nonsep_afb_plain(x, outer, mode, separable=True),
        afb_sfb._afb2d_corr(x, *h, mode), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("mode", ["zero", "symmetric", "periodic",
                                  "periodization"])
@pytest.mark.parametrize("Ly,Lx,Ny,Nx", [(2, 2, 3, 4), (8, 8, 5, 4),
                                         (8, 4, 4, 6), (6, 10, 4, 5),
                                         (12, 6, 7, 3), (8, 8, 3, 3)])
def test_k15_index_plans(mode, Ly, Lx, Ny, Nx):
    """K15's forward (the polyphase tiles over the bands, the roll
    wrapped at the store, the wrap-add's second positions added by the
    band from the host's tables) and its adjoint (K14's staged tile
    through the inverse map), the periodization wrap-add of tails as
    long as the output (8 taps on 3 samples; the other modes have no
    output there)."""
    if mode != "periodization" and min(2 * Ny - Ly, 2 * Nx - Lx) + 2 < 1:
        with pytest.raises(RuntimeError):
            nonsep.nonsep_sfb_plain(torch.zeros(1, 1, 4, Ny, Nx),
                                    _f(4, Ly, Lx, 0), mode)
        return
    f = _f(4, Ly, Lx, 4)
    c = np.random.RandomState(5).randn(4, Ny, Nx)
    ay, ax = SfbAxis(Ny, Ly, mode), SfbAxis(Nx, Lx, mode)
    want = nonsep.nonsep_sfb_plain(torch.from_numpy(c)[None, None], f,
                                   mode)[0, 0].numpy()
    assert want.shape == (ay.out, ax.out)
    np.testing.assert_allclose(k15_forward(c, f, mode), want, **TOL)
    g = np.random.RandomState(6).randn(*want.shape)
    want = nonsep.nonsep_sfb_adjoint_plain(
        torch.from_numpy(g)[None, None], f, mode, Ny, Nx)[0, 0].numpy()
    np.testing.assert_allclose(k15_adjoint(g, f, mode, Ny, Nx), want, **TOL)
    # the host map (the tests' and chip_smoke.py's) is the device one
    u = np.arange(ay.plan[0] + Ly + 2 * Ny)
    assert list(nonsep.sfb_axis_src(ay.plan, ay.per, u)) == [ay.src(v)
                                                              for v in u]


@pytest.mark.parametrize("mode,Ly,Lx,Ny,Nx", [
    *[("periodization", *c) for c in ((8, 8, 2, 3), (12, 6, 2, 2),
                                      (10, 4, 3, 1))],
    *[(m, 8, 4, 5, 6) for m in ("zero", "symmetric", "periodic",
                                "periodization")]])
def test_k15_separable_plan(mode, Ly, Lx, Ny, Nx):
    """K15's adjoint on the separable merge's plan (sfb2d's backward): a
    'periodization' tail longer than the output folds once and the rest
    is cut, as K7 does, in K14's staged tile through SfbAxis; one-tap
    axes (sfb1d's backward: Ly or Lx = 2 with a zero row); the plain map
    is the separable merge itself for outer products, in every mode."""
    f = _f(4, Ly, Lx, 11)
    c = np.random.RandomState(12).randn(4, Ny, Nx)
    ay, ax = SfbAxis(Ny, Ly, mode, True), SfbAxis(Nx, Lx, mode, True)
    want = nonsep.nonsep_sfb_plain(torch.from_numpy(c)[None, None], f, mode,
                                   True)[0, 0].numpy()
    g = np.random.RandomState(13).randn(*want.shape)
    for psfs in (f, afb_sfb._one_axis_psfs(f[:2, :, 0], 2, 4),
                 afb_sfb._one_axis_psfs(f[:2, 0], 3, 4)):
        # sfb1d's backward: the one-tap axis' cotangent twice as long
        g_ = g if psfs is f else np.random.RandomState(15).randn(*(
            nonsep._sfb_axis_plan(n, L, mode, True)[0]
            for n, L in zip((Ny, Nx), psfs.shape[1:])))
        want = nonsep.nonsep_sfb_adjoint_plain(
            torch.from_numpy(g_)[None, None], psfs, mode, Ny, Nx,
            True)[0, 0].numpy()
        np.testing.assert_allclose(k15_adjoint(g_, psfs, mode, Ny, Nx, True),
                                   want, **TOL)
    u = np.arange(ay.plan[0] + Ly + 2 * Ny)
    assert list(nonsep.sfb_axis_src(ay.plan, ay.per, u)) == [ay.src(v)
                                                              for v in u]
    r = np.random.RandomState(14)
    gs = [r.randn(L) for L in (Ly, Ly, Lx, Lx)]
    x = torch.from_numpy(r.randn(2, 3, 4, Ny, Nx))
    torch.testing.assert_close(
        nonsep.nonsep_sfb_plain(x, nonsep.outer_filters(*gs), mode, True),
        afb_sfb._sfb2d_conv(*x.unbind(2), *gs, mode), rtol=1e-12,
        atol=1e-12)


def test_sfb_long_filter_raises():
    """'periodization' with a tail longer than the output fails in the
    JAX package (its wrap-add slices); the port raises the same way."""
    with pytest.raises(ValueError, match="longer"):
        nonsep._sfb_axis_plan(2, 8, "periodization")
    with pytest.raises(ValueError, match="longer"):
        nonsep.nonsep_sfb_plain(torch.zeros(1, 1, 4, 2, 2),
                                _f(4, 8, 8, 0), "periodization")


def _src(q, n, mode):
    front = max(0, -q)
    return int(pad_index(n, front, max(0, q - n + 1), mode)[q + front])


def merge_src(q, n, mode):
    """csrc/swt_atrous.cu:merge_src, line by line: one reflection or wrap
    within an axis length of the signal, pad_src past it."""
    if 0 <= q < n:
        return q
    if -n <= q < 2 * n:
        if mode in ("zero", "constant"):
            return -1
        if mode == "symmetric":
            return -1 - q if q < 0 else 2 * n - 1 - q
        if mode in ("periodic", "periodization"):
            return q + n if q < 0 else q - n
        if mode == "replicate":
            return 0 if q < 0 else n - 1
        r = 0 if n == 1 else (-q if q < 0 else 2 * n - 2 - q)
        if 0 <= r < n:
            return r
    return _src(q, n, mode)


@pytest.mark.parametrize("mode", ["zero", "symmetric", "reflect", "periodic",
                                  "periodization", "replicate"])
def test_merge_src(mode):
    """K16's boundary map equals pad_index (numpy.pad's closed form) at
    every position, its division-free branch included, n = 1..12."""
    for n in range(1, 13):
        q = np.arange(-3 * n - 2, 4 * n + 2)
        want = pad_index(n, -q[0], q[-1] - n + 1, mode)
        assert [merge_src(int(v), n, mode) for v in q] == list(want)


def emulate_swt_sfb(lo, hi, k0, k1, mode, d):
    """swt_sfb along one axis: y[m] = sum_k k0[k] LO(m + k d - front) +
    k1[k] HI(...), taps halved by the wrapper."""
    n, L = len(lo), len(k0)
    front, _, _, m_out = afb_sfb.atrous_merge_plan(n, L, d, mode)
    y = np.zeros(m_out)
    for m in range(m_out):
        for k in range(L):
            r = _src(m + k * d - front, n, mode)
            if r >= 0:
                y[m] += 0.5 * k0[k] * lo[r] + 0.5 * k1[k] * hi[r]
    return y


def emulate_swt_sfb_adjoint(g, k0, k1, mode, d):
    """swt_sfb_adjoint in closed form: each sample's images, its direct
    position and the pad positions whose source it is (the first
    design's edge scan), and their windows."""
    n, L = len(g), len(k0)
    front, back, _, m = afb_sfb.atrous_merge_plan(n, L, d, mode)
    out = np.zeros((2, n))
    for t in range(n):
        qs = [t] + [q for q in range(-front, 0) if _src(q, n, mode) == t]
        qs += [q for q in range(n, n + back) if _src(q, n, mode) == t]
        for q in qs:
            for k in range(L):
                u = q + front - k * d
                if 0 <= u < m:
                    out[0, t] += 0.5 * k0[k] * g[u]
                    out[1, t] += 0.5 * k1[k] * g[u]
    return out


# csrc/swt_atrous.cu's tiles: a column thread walks MRC outputs of a
# residue class, a row-tile thread MR
MR, MRC = 8, 4


def _merge_window(z, T, R):
    """The window loop of K16's kernels for one input: R outputs, the 2R
    samples of a block of R taps, the next R read before the block's FMAs
    (samples never read are NaN).  T: (NO, L) taps."""
    L = T.shape[1]
    w = np.full(2 * R, np.nan)
    w[:R] = [z(o) for o in range(R)]
    acc = np.zeros((T.shape[0], R))
    for kb in range(0, L, R):
        for q in range(R, 2 * R):
            if kb + q <= L + R - 2:
                w[q] = z(kb + q)
        for kk in range(R):
            if kb + kk < L:
                acc += T[:, kb + kk:kb + kk + 1] * w[kk:kk + R]
        w[:R], w[R:] = w[R:], np.nan
    return acc


def _merge_x(x, n, mode):
    """X(q): merge_src read, 0 where -1."""
    def X(q):
        r = merge_src(q, n, mode)
        return x[r] if r >= 0 else 0.0
    return X


def merge_col(xs, T, F, mode, d, m=None):
    """merge_col_kernel along one column: tiles (residue r, chunk) of MRC
    outputs r + d (chunk MRC + o), each input's window over X(m0 - F +
    d e), the pad map per loaded row.  T: (NI, NO, L); the inputs' n
    samples, ``m`` outputs (n by default)."""
    n = len(xs[0])
    m = n if m is None else m
    RW = MRC
    nres, nch = min(d, m), -(-(-(-m // d)) // RW)
    out = np.full((T.shape[1], m), np.nan)
    for ti in range(nres * nch):
        m0 = ti % nres + d * RW * (ti // nres)
        acc = sum(_merge_window(lambda e, X=_merge_x(x, n, mode):
                                X(m0 - F + d * e), T[i], RW)
                  for i, x in enumerate(xs))
        for o in range(RW):
            if m0 + d * o < m:
                assert np.isnan(out[:, m0 + d * o]).all()
                out[:, m0 + d * o] = acc[:, o]
    return out


def merge_row(xs, T, F, mode, d, m=None):
    """merge_row_kernel along one row (the inputs' n samples, ``m``
    outputs, n by default): tiles of G residues x S positions
    (merge_row_tile), the samples X(q0 + g + d k) staged as e = k G + g
    (where the tile is one run, G = d, inside the axis row_run's walk
    along the segment at q0, which must agree), each thread's MR outputs of
    residue g from its window over staged samples G apart, the outputs
    through a shared row (one run from d P0 where G = d); the 32 lanes
    (rows) of a warp read and write their rows on distinct banks (odd
    pitches) and stage and store along a row on consecutive words."""
    n = len(xs[0])
    m = n if m is None else m
    NI, NO, L = T.shape
    G, S = afb_sfb.merge_row_tile(m, L, d, NI, NO)
    gs = G.bit_length() - 1
    assert G == 1 << gs and S % MR == 0
    seg = G * (S + L - 1)
    pin, pout = seg | 1, (G * S) | 1
    assert afb_sfb.merge_row_smem(G, S, L, NI, NO) == 4 * (
        NI * NO * L + NI * 32 * pin + NO * 32 * pout)
    for pitch in (pin, pout):
        assert len({lane * pitch % 32 for lane in range(32)}) == 32
    nres = min(d, m)
    ngroups = -(-nres // G)
    out = np.full((NO, m), np.nan)
    for tile in range(ngroups * -(-(-(-m // d)) // S)):
        rho0, P0 = (tile % ngroups) * G, tile // ngroups * S
        q0 = rho0 - F + d * P0

        def src(e, n=n):
            return merge_src(q0 + e if G == d else
                             q0 + (e & (G - 1)) + d * (e >> gs), n, mode)
        staged = [stage_row(x, src, q0 if G == d else None, seg)
                  for x in xs]
        out_s = np.full((NO, G * S), np.nan)
        for item in range(G * (S // MR)):
            g, ch = item & (G - 1), item >> gs
            acc = sum(_merge_window(
                lambda e, st=st: st[(ch * MR + e) * G + g], T[i], MR)
                for i, st in enumerate(staged))
            for o in range(MR):
                out_s[:, (ch * MR + o) * G + g] = acc[:, o]
        for e in range(G * S):
            g = e & (G - 1)
            u = rho0 + g + d * (P0 + (e >> gs))
            if G == d:
                assert u == d * P0 + e
            if rho0 + g >= nres or u >= m:
                continue
            assert np.isnan(out[:, u]).all()
            out[:, u] = out_s[:, e]
    return out


def band_table(n, L, d, mode, kind):
    """merge_band_images of ``kind``'s plan, checked against pad_index:
    its rows are the samples t with a pad image, ascending, each listing
    every padded position outside the axis whose source is t, ascending,
    then -1 to the end."""
    plan = {"merge": afb_sfb.atrous_merge_plan,
            "split": afb_sfb.atrous_plan}[kind]
    front, back, _, _ = plan(n, L, d, mode)
    tab = afb_sfb.merge_band_images(n, L, d, mode, kind)
    src = pad_index(n, front, back, mode)
    pads = np.r_[0:front, front + n:front + n + back]
    want = {t: pads[src[pads] == t] for t in np.unique(src[pads])
            if t >= 0}
    if tab is None:
        assert not want
        return None
    assert list(tab[:, 0]) == sorted(want)
    for row in tab:
        us = row[1:][row[1:] >= 0]
        assert (np.diff(us) > 0).all() and (row[1 + len(us):] < 0).all()
        np.testing.assert_array_equal(us, want[row[0]])
    return tab


def merge_band(out, ins, T, n, d, mode, kind):
    """merge_band_kernel<NI, NO>: add, for each row of the band table of
    ``kind``'s plan (t, then padded positions u0 = q + front), sum_i sum_k
    T[i][o][k] in_i[u0 - k d] to output o at t (the inputs' m samples).
    T: (NI, NO, L), the taps unreversed."""
    tab = band_table(n, T.shape[2], d, mode, kind)
    if tab is None:
        return out
    m = len(ins[0])
    for row in tab:
        us = row[1:][row[1:] >= 0]
        acc = np.zeros(T.shape[1])
        for u0 in us:
            for k in range(T.shape[2]):
                u = u0 - k * d
                if u < 0:
                    break
                if u < m:
                    for i, g in enumerate(ins):
                        acc += T[i, :, k] * g[u]
        out[:, row[0]] += acc
    return out


def k16_forward(plan, lo, hi, k0, k1, mode, d):
    """swt_sfb by the column or row tile: (NI, NO) = (2, 1), the halved
    taps, F = front, the mode's pads."""
    front = afb_sfb.atrous_merge_plan(len(lo), len(k0), d, mode)[0]
    T = 0.5 * np.stack([k0, k1])[:, None]
    return plan([lo, hi], T, front, mode, d)[0]


def k16_adjoint(plan, g, k0, k1, mode, d):
    """swt_sfb_adjoint: the tile on the reversed halved taps, (1, 2), F =
    back, zeros outside the axis (each sample's direct image), then the
    band."""
    n, L = len(g), len(k0)
    _, back, _, _ = afb_sfb.atrous_merge_plan(n, L, d, mode)
    T = 0.5 * np.stack([k0[::-1], k1[::-1]])[None]
    out = plan([g], T, back, "zero", d)
    return merge_band(out, [g], 0.5 * np.stack([k0, k1])[None], n, d, mode,
                      "merge")


K16_PLANS = {"columns": merge_col, "rows": merge_row}


@pytest.mark.parametrize("mode", ["zero", "symmetric", "reflect", "periodic",
                                  "periodization", "replicate"])
@pytest.mark.parametrize("L,d,n", [(2, 1, 7), (8, 1, 9), (8, 2, 6),
                                   (6, 4, 5), (4, 4, 16), (8, 1, 300),
                                   (8, 4, 261), (4, 32, 70), (3, 3, 40)])
def test_k16_index_plans(mode, L, d, n):
    """K16: the merge and its adjoint in closed form (the adjoint's edge
    scan), and as the column and row tiles compute them over the
    d-strided subsequences, the adjoint's pad images added from the
    host's table: pads up to several axis lengths (L d = 24 on 5
    samples), several row tiles and column chunks, residue groups (d =
    32 > 16), an odd L and a d that is not a power of two."""
    r = np.random.RandomState(7)
    g0, g1 = r.randn(L), r.randn(L)
    k0, k1 = g0[::-1], g1[::-1]
    lo, hi = r.randn(n), r.randn(n)

    def t(v):
        return torch.from_numpy(np.asarray(v)).reshape(1, 1, 1, -1)
    want = afb_sfb.sfb1d_atrous_conv_plain(t(lo), t(hi), g0, g1, mode, 3,
                                           d).reshape(-1).numpy()
    np.testing.assert_allclose(emulate_swt_sfb(lo, hi, k0, k1, mode, d),
                               want, **TOL)
    for name, plan in K16_PLANS.items():
        np.testing.assert_allclose(
            k16_forward(plan, lo, hi, k0, k1, mode, d), want, **TOL,
            err_msg=name)
    g = r.randn(n)
    want = afb_sfb.sfb1d_atrous_adjoint_plain(t(g), g0, g1, mode, 3,
                                              d).reshape(2, n).numpy()
    np.testing.assert_allclose(emulate_swt_sfb_adjoint(g, k0, k1, mode, d),
                               want, **TOL)
    for name, plan in K16_PLANS.items():
        np.testing.assert_allclose(
            k16_adjoint(plan, g, k0, k1, mode, d), want, **TOL,
            err_msg=name)


def k12_forward(plan, x, h0, h1, mode, d):
    """swt_afb by the column or row tile: (NI, NO) = (1, 2), T = (h0, h1),
    F = front, the mode's pads, m_out outputs of n samples."""
    front, _, _, m = afb_sfb.atrous_plan(len(x), len(h0), d, mode)
    return plan([x], np.stack([h0, h1])[None], front, mode, d, m)


def k12_adjoint(plan, glo, ghi, h0, h1, mode, d, n):
    """swt_afb_adjoint: the tile on the reversed taps, (2, 1), F = back' =
    (L - 1) d - front, zeros outside the cotangent's m_out samples, n
    outputs (each sample's direct image), then the band of the split's
    plan summing dlo's and dhi's pad images into one output."""
    L = len(h0)
    front = afb_sfb.atrous_plan(n, L, d, mode)[0]
    T = np.stack([h0[::-1], h1[::-1]])[:, None]
    out = plan([glo, ghi], T, (L - 1) * d - front, "zero", d, n)
    return merge_band(out, [glo, ghi], np.stack([h0, h1])[:, None], n, d,
                      mode, "split")[0]


@pytest.mark.parametrize("mode", ["zero", "symmetric", "reflect", "periodic",
                                  "periodization", "replicate"])
@pytest.mark.parametrize("L,d,n", [(2, 1, 7), (8, 1, 9), (8, 2, 6),
                                   (6, 4, 5), (4, 4, 16), (8, 1, 300),
                                   (8, 4, 261), (4, 32, 70), (3, 3, 40),
                                   (5, 3, 11), (3, 3, 2)])
def test_k12_tile_plans(mode, L, d, n):
    """K12 on K16's tile engine: the split at (1, 2) and the adjoint's
    direct images at (2, 1) by the column and row tiles, the adjoint's
    pad images by the band of the split's plan (its table checked
    against pad_index), against the plain versions and the closed forms
    of tests/test_torch_swt_plans.py: K16's grid, odd L d (n - 1
    outputs), pads longer than the axis (L d = 24 on 5 samples, 9 on
    2)."""
    from tests.test_torch_swt_plans import (
        emulate_swt_afb, emulate_swt_afb_adjoint,
    )
    r = np.random.RandomState(13)
    h0, h1 = r.randn(2, L)
    x = r.randn(n)

    def t(v, shape):
        return torch.from_numpy(np.asarray(v)).reshape(shape)
    m = afb_sfb.atrous_plan(n, L, d, mode)[3]
    assert m == n - (L * d) % 2
    want = afb_sfb.afb1d_atrous_corr_plain(t(x, (1, 1, 1, n)), h0, h1, mode,
                                           3, d).reshape(2, m).numpy()
    closed = n <= 64        # the closed forms' loops are slow
    if closed:
        np.testing.assert_allclose(emulate_swt_afb(x, h0, h1, mode, d),
                                   want, **TOL)
    g = r.randn(2, m)
    want_dx = afb_sfb.afb1d_atrous_adjoint_plain(
        t(g, (1, 1, 2, 1, m)), h0, h1, mode, 3, d, n).reshape(n).numpy()
    if closed:
        np.testing.assert_allclose(
            emulate_swt_afb_adjoint(g[0], g[1], h0, h1, mode, d, n),
            want_dx, **TOL)
    for name, plan in K16_PLANS.items():
        np.testing.assert_allclose(k12_forward(plan, x, h0, h1, mode, d),
                                   want, **TOL, err_msg=name)
        np.testing.assert_allclose(
            k12_adjoint(plan, g[0], g[1], h0, h1, mode, d, n), want_dx,
            **TOL, err_msg=name)
