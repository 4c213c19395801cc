"""Host plans and window applies of the port's sharded DWT / SWT
(``parallel/sharded_dwt.py``, ``ops/afb_sfb.py``), without processes:

- the operator constructors ``_afb_matrix`` / ``_sfb_matrix`` /
  ``_sfb_atrous_matrix`` equal the JAX package's, exactly in fp32 (probed
  and synthesized past ``DIRECT_PROBE_N``);
- the strategy planners give the JAX kinds, halos, per-rank blocks and
  logical / storage sizes (the meshes of tests/test_torch_sharded_dwt.py,
  a 'gather' level among them);
- the window plans of K6 / K7 (``afb_window_plan`` / ``sfb_window_plan``)
  and K12 / K16 (``atrous_window_plan``), emulated in numpy as the
  kernels read them, equal a plain valid correlation (the JAX
  ``_afb1d_per_sharded`` / ``_sfb1d_per_sharded`` / ``_afb1d_atrous_
  sharded`` / ``_sfb1d_atrous_sharded`` on a window), and so do the
  window applies' plain versions;
- the four window Functions' backwards are their adjoints (<A x, y> =
  <x, A^T y> within 1e-6 of the Cauchy-Schwarz scale, fp32:
  ``chip_smoke.py:adjoint_error``), and the backwards' backwards the
  Functions again."""
import numpy as np
import pytest
import torch

from chip_smoke import adjoint_error

from pytorch_wavelets_tpu.ops import afb_sfb as jafb
from pytorch_wavelets_tpu.parallel import sharded as jsh

from pytorch_wavelets_tpu_torch.ops import afb_sfb
from pytorch_wavelets_tpu_torch.ops.pad import pad_index
from pytorch_wavelets_tpu_torch.parallel import sharded_dwt as sd
from pytorch_wavelets_tpu_torch.transforms.dwt import (
    dec_filters, rec_filters,
)

torch.set_num_threads(1)


def _taps(wave, rec=False):
    f = (rec_filters if rec else dec_filters)(wave)
    if rec:
        return tuple(f[0]), tuple(f[1])
    return (tuple(np.asarray(f[0])[::-1].tolist()),
            tuple(np.asarray(f[1])[::-1].tolist()))


BUILDS = [("db2", "zero", 31), ("db3", "symmetric", 57), ("db2", "reflect",
                                                           48),
          ("db4", "periodization", 64), ("bior2.2", "symmetric", 40),
          ("db2", "symmetric", 4100)]


@pytest.mark.parametrize("wave,mode,n", BUILDS)
def test_afb_sfb_matrices_equal_jax(wave, mode, n):
    h = _taps(wave)
    got = afb_sfb._afb_matrix(*h, mode, n)
    want = np.asarray(jafb._afb_matrix(*h, mode, n))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    g = _taps(wave, rec=True)
    m = afb_sfb.dwt_coeff_len(n, len(g[0]), mode) \
        if mode != "periodization" else n // 2
    np.testing.assert_array_equal(afb_sfb._sfb_matrix(*g, mode, m),
                                  np.asarray(jafb._sfb_matrix(*g, mode, m)))


@pytest.mark.parametrize("wave,mode,d,n", [
    ("db2", "periodic", 1, 48), ("db2", "periodic", 2, 32),
    ("bior2.2", "periodization", 4, 64), ("db4", "zero", 2, 40),
    ("db2", "symmetric", 1, 4100)])
def test_sfb_atrous_matrix_equals_jax(wave, mode, d, n):
    g = _taps(wave, rec=True)
    np.testing.assert_array_equal(
        afb_sfb._sfb_atrous_matrix(*g, mode, d, n),
        np.asarray(jafb._sfb_atrous_matrix(*g, mode, d, n)))


def _same_strategy(mine, theirs):
    kind, obj = theirs
    assert mine.kind == kind
    if kind == "local":
        np.testing.assert_array_equal(mine.obj, np.asarray(obj))
    elif kind == "shard":
        op = mine.obj
        assert (op.halo_left, op.halo_right, op.col_tiles, op.wrap) == (
            obj.halo_left, obj.halo_right, tuple(obj.col_tiles), obj.wrap)
        np.testing.assert_array_equal(op.blocks, np.asarray(obj.blocks))
    else:
        T, rb, cb = mine.obj
        np.testing.assert_array_equal(T, np.asarray(obj[0]))
        assert (rb, cb) == (tuple(obj[1]), tuple(obj[2]))


# (wave, mode, n, shards, J): the sharded tests' axes
SPLITS = [("db2", "zero", 48, 2, 2), ("db2", "symmetric", 57, 2, 2),
          ("db2", "reflect", 31, 2, 2), ("db3", "zero", 48, 2, 2),
          ("db4", "zero", 57, 4, 3), ("db2", "zero", 61, 4, 3),
          ("db2", "symmetric", 31, 1, 2)]


@pytest.mark.parametrize("wave,mode,n,q,J", SPLITS)
def test_mode_strategies_equal_jax(wave, mode, n, q, J):
    h = _taps(wave)
    mine = sd._dwt_mode_split_strategies(h, mode, n, q, J)
    theirs = jsh._dwt_mode_split_strategies(h, mode, n, q, J)
    assert mine[1:] == tuple(tuple(t) for t in theirs[1:])
    for a, b in zip(mine[0], theirs[0]):
        _same_strategy(a, b)
    g = _taps(wave, rec=True)
    sizes = mine[1]
    mine = sd._dwt_mode_merge_strategies(g, mode, sizes, q)
    theirs = jsh._dwt_mode_merge_strategies(g, mode, sizes, q)
    assert mine[1] == tuple(theirs[1])
    for a, b in zip(mine[0], theirs[0]):
        _same_strategy(a, b)
    mine = sd._swt_mode_split_strategies(h, mode, n, q, 2)
    theirs = jsh._swt_mode_split_strategies(h, mode, n, q, 2)
    assert mine[1] == theirs[1]
    for a, b in zip(mine[0], theirs[0]):
        _same_strategy(a, b)


@pytest.mark.parametrize("wave,n,q,J", [("db2", 48, 2, 2), ("db2", 29, 1, 2),
                                         ("db2", 64, 4, 3), ("db4", 64, 2, 2),
                                         ("bior2.2", 48, 2, 2)])
def test_circular_strategies_equal_jax(wave, n, q, J):
    h, g = _taps(wave), _taps(wave, rec=True)
    for a, b in zip(sd._dwt_split_strategies(h, "periodization", n, q, J),
                    jsh._dwt_split_strategies(h, "periodization", n, q, J)):
        _same_strategy(a, b)
    sizes = tuple(n // 2 ** (j + 1) for j in range(J)) if n % 2 == 0 \
        else (15, 8)
    for a, b in zip(sd._dwt_merge_strategies(g, sizes, q),
                    jsh._dwt_merge_strategies(g, sizes, q)):
        _same_strategy(a, b)
    if n % q == 0:
        for a, b in zip(sd._swt_split_strategies(h, n, q, J),
                        jsh._swt_split_strategies(h, n, q, J)):
            _same_strategy(a, b)
        for a, b in zip(sd._swt_merge_strategies(g, n, q, J),
                        jsh._swt_merge_strategies(g, n, q, J)):
            _same_strategy(a, b)


def test_sharded_mm_cap():
    """The operator route is wanted up to the JAX package's cap of 32768
    samples, and not under ``set_operator_matmul(False)``."""
    from pytorch_wavelets_tpu_torch.ops import banded
    assert sd._sharded_mm_wanted(32768) and not sd._sharded_mm_wanted(32769)
    banded.set_operator_matmul(False)
    try:
        assert not sd._sharded_mm_wanted(64)
    finally:
        banded.set_operator_matmul(None)


def test_strategies_taken():
    """The sharded tests' meshes take every strategy: 'gather' at the
    deep level of db4 J=3 on 57 samples over 4 ranks (the
    'dwt_sp4_gather' case) in the analysis and the synthesis, 'shard'
    above it, 'local' on one rank."""
    split, sizes, _ = sd._dwt_mode_split_strategies(_taps("db4"), "zero",
                                                    57, 4, 3)
    merge, _ = sd._dwt_mode_merge_strategies(_taps("db4", rec=True), "zero",
                                             sizes, 4)
    assert [s.kind for s in split] == ["shard", "shard", "gather"]
    assert [s.kind for s in merge] == ["shard", "shard", "gather"]
    assert sd._dwt_mode_split_strategies(_taps("db2"), "zero", 48, 1,
                                         1)[0][0].kind == "local"


# --------------------------------------------------------------------------
# Window plans, emulated as the kernels read them
# --------------------------------------------------------------------------

def _k6_window(x, h0, h1, front, m):
    """K6 under ``afb_window_plan``: X(q) = x[pad_index(ne, front)[q]]."""
    front, ne, pmode, shift, fold = afb_sfb.afb_window_plan(len(x), front)
    assert (pmode, shift, fold) == ("zero", 0, 0)
    L = len(h0)
    idx = pad_index(ne, front, 2 * m + L, pmode)
    q = 2 * np.arange(m)[:, None] + np.arange(L)
    X = np.where(idx[q] >= 0, x[np.clip(idx[q], 0, ne - 1)], 0.0)
    return np.stack([(X * h).sum(1) for h in (h0, h1)])


def _k7_window(lo, hi, g0, g1, s, m):
    """K7 under ``sfb_window_plan``: output t is Y(t + s)."""
    s, wrap, r0, fold = afb_sfb.sfb_window_plan(s)
    assert (wrap, r0, fold) == (0, 0, 0)
    nin, L = len(lo), len(g0)

    def Y(u):
        j = np.arange(max(0, (u - L + 2) // 2), min(nin - 1, u // 2) + 1)
        return (lo[j] * g0[u - 2 * j] + hi[j] * g1[u - 2 * j]).sum()
    return np.array([Y(t + s) for t in range(m)])


WINDOWS = [("db1", 8), ("db2", 10), ("db4", 16), ("db4", 21), ("bior2.2", 30),
           ("db3", 9)]


@pytest.mark.parametrize("wave,w", WINDOWS)
def test_k6_k7_window_plans(wave, w):
    """The window of a w-sample tile: K6's split (front 0) is the valid
    stride-2 correlation, K7's merge (s = 2 hl - L//2 + L - 1) the JAX
    ``_sfb1d_per_sharded``'s valid correlation of the upsampled window;
    both equal the plain window applies."""
    rng = np.random.RandomState(w)
    h0, h1 = (np.asarray(t) for t in _taps(wave))
    L = len(h0)
    L2 = L // 2
    nw = w + L - 1 - L2 + max(L2 - 1, 0)
    xw = rng.randn(nw)
    m = (nw - L) // 2 + 1
    valid = np.stack([np.correlate(xw, h, "valid")[::2] for h in (h0, h1)])
    np.testing.assert_allclose(_k6_window(xw, h0, h1, 0, m), valid,
                               atol=1e-12)
    plain = afb_sfb.afb1d_window_plain(
        torch.from_numpy(xw)[None, None, None], h0, h1, 3, 0, m)
    np.testing.assert_allclose(plain[0, 0, :, 0].numpy(), valid, atol=1e-12)
    # the merge of a (hl, hr)-halo'd pair of windows
    g0, g1 = (np.asarray(t) for t in _taps(wave, rec=True))
    hl, hr = (L2 + 1) // 2, L2 // 2
    lo, hi = rng.randn(w + hl + hr), rng.randn(w + hl + hr)
    s = 2 * hl - L2 + L - 1
    up = np.zeros((2, 2 * len(lo)))
    up[0, ::2], up[1, ::2] = lo, hi
    start = 2 * hl - L2
    u = up[:, start:start + 2 * w + L - 1]
    want = (np.correlate(u[0], g0[::-1], "valid")
            + np.correlate(u[1], g1[::-1], "valid"))
    np.testing.assert_allclose(_k7_window(lo, hi, g0, g1, s, 2 * w), want,
                               atol=1e-12)
    t = [torch.from_numpy(a)[None, None, None] for a in (lo, hi)]
    plain = afb_sfb.sfb1d_window_plain(*t, g0, g1, 3, s, 2 * w)
    np.testing.assert_allclose(plain[0, 0, 0].numpy(), want, atol=1e-12)


@pytest.mark.parametrize("wave,d,w", [("db2", 1, 8), ("db2", 4, 12),
                                      ("db4", 2, 14), ("bior2.2", 4, 24),
                                      ("db1", 2, 5)])
def test_k12_k16_window_plans(wave, d, w):
    """K12's / K16's window: the 'zero' plan's outputs [front, front + w)
    of a window of w + (L - 1) d samples are the valid dilated
    correlations (the JAX ``_afb1d_atrous_sharded`` /
    ``_sfb1d_atrous_sharded``), and so are the window applies."""
    rng = np.random.RandomState(w + d)
    h0, h1 = (np.asarray(t) for t in _taps(wave))
    L = len(h0)
    nw = w + (L - 1) * d
    xw = rng.randn(nw)
    front, m = afb_sfb.atrous_window_plan(nw, L, d, "split")
    assert m == w
    dil = [np.zeros((L - 1) * d + 1) for _ in range(2)]
    dil[0][::d], dil[1][::d] = h0, h1
    valid = np.stack([np.correlate(xw, k, "valid") for k in dil])
    # K12's 'zero' plan: output o is sum_k h[k] X(o + k d - front)
    fz, bz, _, out_len = afb_sfb.atrous_plan(nw, L, d, "zero")
    idx = pad_index(nw, fz, bz, "zero")
    q = np.arange(out_len)[:, None] + d * np.arange(L)
    X = np.where(idx[q] >= 0, xw[np.clip(idx[q], 0, nw - 1)], 0.0)
    zero = np.stack([(X * h).sum(1) for h in (h0, h1)])
    np.testing.assert_allclose(zero[:, front:front + m], valid, atol=1e-12)
    got = afb_sfb.atrous_split_window(torch.from_numpy(xw)[None, None, None],
                                      h0, h1, 3, d)
    np.testing.assert_allclose(got[0, 0, :, 0].numpy(), valid, atol=1e-12)
    g0, g1 = (np.asarray(t) for t in _taps(wave, rec=True))
    lo, hi = rng.randn(nw), rng.randn(nw)
    front, m = afb_sfb.atrous_window_plan(nw, L, d, "merge")
    assert m == w
    k = [np.zeros((L - 1) * d + 1) for _ in range(2)]
    k[0][::d], k[1][::d] = g0[::-1], g1[::-1]
    want = 0.5 * (np.correlate(lo, k[0], "valid")
                  + np.correlate(hi, k[1], "valid"))
    got = afb_sfb.atrous_merge_window(
        *(torch.from_numpy(a)[None, None, None] for a in (lo, hi)), g0, g1,
        3, d)
    np.testing.assert_allclose(got[0, 0, 0].numpy(), want, atol=1e-12)


# --------------------------------------------------------------------------
# The window Functions' adjoints
# --------------------------------------------------------------------------

def _rand(shape, seed):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape)
                            .astype(np.float32))


def _functions(axis):
    """(name, forward on its inputs, input shapes) of the four window
    Functions on a (2, 3, 13, 14)-ish window along ``axis``."""
    h = tuple(np.asarray(t) for t in _taps("db4"))
    g = tuple(np.asarray(t) for t in _taps("db4", rec=True))
    b = tuple(np.asarray(t) for t in _taps("bior2.2"))
    shape = [2, 3, 9, 11]

    def along(n):
        s = list(shape)
        s[axis] = n
        return tuple(s)
    return [
        ("split", lambda x: afb_sfb.split_window(x, *h, axis, 0, 5),
         [along(16)]),
        ("split_front", lambda x: afb_sfb.split_window(x, *h, axis, 3, 7),
         [along(12)]),
        ("merge", lambda lo, hi: afb_sfb.merge_window(lo, hi, *g, axis, 7,
                                                      12), [along(10)] * 2),
        ("atrous_split", lambda x: afb_sfb.atrous_split_window(
            x, *b, axis, 2), [along(20)]),
        ("atrous_merge", lambda lo, hi: afb_sfb.atrous_merge_window(
            lo, hi, *b, axis, 2), [along(20)] * 2),
    ]


@pytest.mark.parametrize("axis", [2, 3])
@pytest.mark.parametrize("k", range(5))
def test_window_function_adjoints(axis, k):
    """<A x, y> = <x, A^T y> with A^T the Function's backward, within
    1e-6 relative (``adjoint_error``) in fp32; the backward's backward is
    A again."""
    name, fn, shapes = _functions(axis)[k]
    xs = [_rand(s, 10 + i).requires_grad_() for i, s in enumerate(shapes)]
    y = fn(*xs)
    u = _rand(tuple(y.shape), 20)
    gs = torch.autograd.grad(y, xs, u, create_graph=True)
    err = adjoint_error([y], [u], xs, gs)
    assert err <= 1e-6, (name, err)
    # second order: d/du <A^T u, v> = A v
    v = [_rand(tuple(x.shape), 30 + i) for i, x in enumerate(xs)]
    uu = u.clone().requires_grad_()
    g2 = torch.autograd.grad(y, xs, uu, create_graph=True)
    dv, = torch.autograd.grad(sum((g * w).sum() for g, w in zip(g2, v)),
                              uu)
    np.testing.assert_allclose(dv.detach().numpy(),
                               fn(*v).detach().numpy(), atol=1e-5)
