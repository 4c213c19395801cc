"""The index maps of kernels K14 (``csrc/nonsep_afb.cu``), K15
(``csrc/nonsep_sfb.cu``, both through ``csrc/nonsep_stencil.cuh``) and
K16 (``csrc/swt_atrous.cu``: ``swt_sfb`` and its adjoint), emulated in
numpy exactly as the CUDA sources compute each output (the axis maps'
``src`` / ``images`` / ``interior``, the windows, the edge scans),
against their plain versions (the JAX code, and autograd's transposes of
it) on the CPU in float64: every mode, odd sizes, filters longer than
the axis, rectangular PSF stacks."""
import numpy as np
import pytest
import torch

from pytorch_wavelets_tpu_torch.ops import afb_sfb, nonsep
from pytorch_wavelets_tpu_torch.ops.pad import pad_index

torch.set_num_threads(1)

TOL = dict(rtol=1e-12, atol=1e-12)


class AfbAxis:
    """csrc/nonsep_stencil.cuh:AfbAxis, line by line."""

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

    def interior(self, u0, L):
        return (self.per != 2 and u0 >= self.front
                and u0 + L - 1 - self.front < self.n, -self.front)

    def cot(self, j):
        return j if j < self.out else j - self.out

    def images(self, t):
        if self.per == 2:
            ne = self.n + self.n % 2
            out = [self.front + (t - self.shift) % ne]
            if self.n % 2 and t == self.n - 1:
                out.append(self.front + (self.n - self.shift) % ne)
            return out
        out = [t + self.front]
        if not self.per and self.code == 0:
            return out
        right = max(self.umax - self.front - self.n + 1, 0)
        edge = max(self.front, right) + 1
        if edge <= t < self.n - edge:
            return out
        out += [u for u in range(self.front) if self.src(u) == t]
        out += [u for u in range(self.n + self.front, self.umax + 1)
                if self.src(u) == t]
        return out


class SfbAxis:
    """csrc/nonsep_stencil.cuh:SfbAxis, line by line."""

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

    def interior(self, u0, L):
        if not self.per:
            return u0 >= self.s and u0 + L - 1 - self.s < self.out, -self.s
        return u0 >= self.r0 and u0 + L - 1 < self.wrap, -self.r0

    def images(self, t):
        if not self.per:
            return [t + self.s]
        tt = (t + self.r0) % self.wrap
        return [tt + self.s] + ([tt + self.s + self.wrap] if tt < self.fold
                                else [])


def corr(x, taps, ay, ax, Ho, Wo):
    """nonsep_corr_kernel on one (H, W) plane: (K, Ho, Wo), taps
    (K, Ly, Lx); checks that every window called interior reads what
    src() gives."""
    K, Ly, Lx = taps.shape
    out = np.zeros((K, Ho, Wo))
    for oy in range(Ho):
        yin, sy = ay.interior(2 * oy, Ly)
        rows = [ay.src(2 * oy + a) for a in range(Ly)]
        if yin:
            assert rows == [2 * oy + a + sy for a in range(Ly)]
        for ox in range(Wo):
            xin, sx = ax.interior(2 * ox, Lx)
            cols = [ax.src(2 * ox + b) for b in range(Lx)]
            if xin:
                assert cols == [2 * ox + b + sx for b in range(Lx)]
            for a, r in enumerate(rows):
                for b, q in enumerate(cols):
                    if r >= 0 and q >= 0:
                        out[:, oy, ox] += taps[:, a, b] * x[r, q]
    return out


def gather(g, taps, ay, ax, Ho, Wo):
    """nonsep_gather_kernel on one (K, Hi, Wi) stack: (Ho, Wo), the
    virtual rows and columns read through the maps' cot()."""
    K, Ly, Lx = taps.shape
    Hi, Wi = (a.virtual or n for a, n in zip((ay, ax), g.shape[1:]))
    out = np.zeros((Ho, Wo))

    def window(u, v):
        acc = 0.0
        a0, a1 = max(u & 1, u - 2 * (Hi - 1)), min(Ly - 1, u)
        b0, b1 = max(v & 1, v - 2 * (Wi - 1)), min(Lx - 1, v)
        for a in range(a0, a1 + 1, 2):
            for b in range(b0, b1 + 1, 2):
                acc += (taps[:, a, b] * g[:, ay.cot((u - a) >> 1),
                                          ax.cot((v - b) >> 1)]).sum()
        return acc
    for ty in range(Ho):
        for tx in range(Wo):
            out[ty, tx] = sum(window(u, v) for u in ay.images(ty)
                              for v in ax.images(tx))
    return out


def _f(K, Ly, Lx, seed):
    return np.random.RandomState(seed).randn(K, Ly, Lx)


CASES = [  # (K, Ly, Lx, H, W)
    (4, 2, 2, 6, 7), (4, 8, 8, 9, 12), (4, 8, 2, 7, 5), (16, 4, 6, 5, 8),
    (4, 12, 10, 3, 4), (1, 3, 5, 6, 6)]


@pytest.mark.parametrize("mode", ["zero", "symmetric", "reflect",
                                  "periodization"])
@pytest.mark.parametrize("K,Ly,Lx,H,W", CASES)
def test_k14_index_plans(mode, K, Ly, Lx, H, W):
    """K14's forward and adjoint: odd axes (periodization's evening),
    filters longer than the axis (pads of several periods), Ly != Lx,
    K = 16, odd lengths."""
    f = _f(K, Ly, Lx, 1)
    x = np.random.RandomState(2).randn(H, W)
    ay, ax = AfbAxis(H, Ly, mode), AfbAxis(W, Lx, mode)
    want = nonsep.nonsep_afb_plain(torch.from_numpy(x)[None, None], f,
                                   mode)[0, 0].numpy()
    got = corr(x, np.ascontiguousarray(f), ay, ax, ay.out, ax.out)
    np.testing.assert_allclose(got, want, **TOL)
    g = np.random.RandomState(3).randn(*want.shape)
    want = nonsep.nonsep_afb_adjoint_plain(
        torch.from_numpy(g)[None, None], f, mode, H, W)[0, 0].numpy()
    np.testing.assert_allclose(gather(g, f, ay, ax, H, W), want, **TOL)


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
    np.testing.assert_allclose(gather(g, f, ay, ax, H, W), want, **TOL)
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
    """K15's forward (a gather over the 1-2 positions of each output
    axis) and its adjoint (the corr stencil through the inverse map),
    the periodization wrap-add of tails as long as the output (8 taps on
    3 samples; the other modes have no output there)."""
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
    np.testing.assert_allclose(gather(c, f, ay, ax, ay.out, ax.out), want,
                               **TOL)
    g = np.random.RandomState(6).randn(*want.shape)
    want = nonsep.nonsep_sfb_adjoint_plain(
        torch.from_numpy(g)[None, None], f, mode, Ny, Nx)[0, 0].numpy()
    np.testing.assert_allclose(corr(g, f, ay, ax, Ny, Nx), want, **TOL)
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
    """K15 on the separable merge's plan (sfb2d's backward): a
    'periodization' tail longer than the output folds once and the rest
    is cut, as K7 does; the plain map is the separable merge itself for
    outer products, in every mode."""
    f = _f(4, Ly, Lx, 11)
    c = np.random.RandomState(12).randn(4, Ny, Nx)
    ay, ax = SfbAxis(Ny, Ly, mode, True), SfbAxis(Nx, Lx, mode, True)
    want = nonsep.nonsep_sfb_plain(torch.from_numpy(c)[None, None], f, mode,
                                   True)[0, 0].numpy()
    np.testing.assert_allclose(gather(c, f, ay, ax, ay.out, ax.out), want,
                               **TOL)
    g = np.random.RandomState(13).randn(*want.shape)
    want = nonsep.nonsep_sfb_adjoint_plain(
        torch.from_numpy(g)[None, None], f, mode, Ny, Nx, True)[0, 0].numpy()
    np.testing.assert_allclose(corr(g, f, ay, ax, Ny, Nx), want, **TOL)
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
    """swt_sfb_adjoint: padded_images (the direct position, the edge
    scan) and window2, as the CUDA source."""
    n, L = len(g), len(k0)
    front, _, _, m = afb_sfb.atrous_merge_plan(n, L, d, mode)
    qmax = m - 1 - front + (L - 1) * d
    right = max(qmax - n + 1, 0)
    edge = max(front, right) + 1
    out = np.zeros((2, n))
    for t in range(n):
        qs = [t]
        if mode not in ("zero", "constant") and not edge <= t < n - edge:
            qs += [q for q in range(-front, 0) if _src(q, n, mode) == t]
            qs += [q for q in range(n, qmax + 1) if _src(q, n, mode) == t]
        for q in qs:
            for k in range(L):
                u = q + front - k * d
                if 0 <= u < m:
                    out[0, t] += 0.5 * k0[k] * g[u]
                    out[1, t] += 0.5 * k1[k] * g[u]
    return out


@pytest.mark.parametrize("mode", ["zero", "symmetric", "reflect", "periodic",
                                  "periodization", "replicate"])
@pytest.mark.parametrize("L,d,n", [(2, 1, 7), (8, 1, 9), (8, 2, 6),
                                   (6, 4, 5), (4, 4, 16)])
def test_k16_index_plans(mode, L, d, n):
    """K16: the merge and its adjoint gather, pads up to several axis
    lengths (L d = 24 on 5 samples)."""
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
    g = r.randn(n)
    want = afb_sfb.sfb1d_atrous_adjoint_plain(t(g), g0, g1, mode, 3, d)
    np.testing.assert_allclose(emulate_swt_sfb_adjoint(g, k0, k1, mode, d),
                               want.reshape(2, n).numpy(), **TOL)
