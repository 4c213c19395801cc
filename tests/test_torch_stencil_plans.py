"""The index maps of kernels K8-K11 and of K2/K3's per-level mode,
emulated in numpy exactly as the CUDA sources (``csrc/dtcwt_filt.cu``,
``dtcwt_dfilt.cu``, ``dtcwt_ifilt.cu``, ``avg_pool2.cu``, ``q2c_pack.cu``,
``c2q_unpack.cu``) compute each output, against their plain versions
(the JAX conv path, ``ops/dtcwt_fb.py`` and ``ops/pool.py``) on the CPU:
the kernels' arithmetic is tested here without a card, at every axis
length 1..24 (K8), 4..24 (K9, multiples of 4), 2..24 (K10, even) and
every q-shift length, both parities of m // 2 included."""
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


@pytest.mark.parametrize("mode", ["symmetric", "zero"])
@pytest.mark.parametrize("L", [1, 2, 4, 5, 7, 13, 19, 30])
def test_filt_index_map(mode, L):
    t = _x(L, 100 + L)
    for n in range(1, 25):
        x = _x(n, n)
        np.testing.assert_allclose(
            emulate_filt(x, t, mode),
            _plain_1d(dtcwt_fb.dtcwt_filt_plain, x, t, 3, mode),
            rtol=1e-12, atol=1e-12, err_msg=f"n={n}")


def _qtaps(name):
    q = qshift(name)
    # correlation order, as the level functions pass them
    return [dtcwt_fb.prep_taps(q[i]) for i in (0, 1, 4, 5)]


@pytest.mark.parametrize("name", QSHIFTS)
@pytest.mark.parametrize("highpass", [False, True])
def test_dfilt_index_map(name, highpass):
    h0a, h0b, h1a, h1b = _qtaps(name)
    ha, hb = (h1b, h1a) if highpass else (h0b, h0a)
    for n in range(4, 25, 4):
        x = _x(n, n)
        np.testing.assert_allclose(
            emulate_dfilt(x, ha, hb, highpass),
            _plain_1d(dtcwt_fb.dtcwt_dfilt_plain, x, ha, hb, highpass, 3),
            rtol=1e-12, atol=1e-12, err_msg=f"n={n}")


@pytest.mark.parametrize("name", QSHIFTS)
@pytest.mark.parametrize("highpass", [False, True])
def test_ifilt_index_map(name, highpass):
    h0a, h0b, h1a, h1b = _qtaps(name)
    ha, hb = (h1b, h1a) if highpass else (h0b, h0a)
    for n in range(2, 25, 2):
        x = _x(n, n)
        np.testing.assert_allclose(
            emulate_ifilt(x, ha, hb, highpass),
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
