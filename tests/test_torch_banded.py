"""The port's host-side operator machinery and K1's plain version == the
JAX package's: probed matrices, composed plans, segment tables, products."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_wavelets_tpu.ops import banded as jbanded
from pytorch_wavelets_tpu.ops import dtcwt_fb as jfb
from pytorch_wavelets_tpu.ops.pad import PAD_MODES, pad1d as jpad1d
from pytorch_wavelets_tpu.transforms import dtcwt as jdt
from pytorch_wavelets_tpu.transforms.dtcwt_xfm import (
    dtcwt_fwd_filters, dtcwt_inv_filters,
)

from pytorch_wavelets_tpu_torch.ops import banded, dtcwt_fb
from pytorch_wavelets_tpu_torch.ops.pad import pad1d
from pytorch_wavelets_tpu_torch.transforms import dtcwt as pdt
from tests.torch_parity import FAST

torch.set_num_threads(1)

MATRIX_ATOL = 1e-7   # fp32 probes; boundary taps that add may differ 1 ulp
SIZES = [12, 64, 128, 520]
F = dtcwt_fwd_filters("near_sym_a", "qshift_a")
G = dtcwt_inv_filters("near_sym_b", "qshift_b")


def _rand(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(a, b, atol=MATRIX_ATOL):
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=atol)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("taps,mode", [(F["h0o"], "symmetric"),
                                       (F["h1o"], "zero"),
                                       (G["g1o"], "symmetric")])
def test_filter_matrix(n, taps, mode):
    _close(dtcwt_fb._filter_matrix(taps, mode, n),
           jfb._filter_matrix(taps, mode, n))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("highpass", [False, True])
def test_dfilt_matrix(n, highpass):
    key = (F["h1b"], F["h1a"]) if highpass else (F["h0b"], F["h0a"])
    _close(dtcwt_fb._dfilt_matrix(*key, highpass, n),
           jfb._dfilt_matrix(*key, highpass, n))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("highpass", [False, True])
def test_ifilt_matrix(n, highpass):
    key = (G["g1b"], G["g1a"]) if highpass else (G["g0b"], G["g0a"])
    _close(dtcwt_fb._ifilt_matrix(*key, highpass, n),
           jfb._ifilt_matrix(*key, highpass, n))


def _fwd_args(J, H, W, skips=None, incs=None):
    skips = skips or (False,) * J
    incs = incs or (False,) * J
    return (F["h0o"], F["h1o"], F["h0a"], F["h1a"], F["h0b"], F["h1b"], J,
            skips, incs, "symmetric", H, W)


def _flat(plan):
    out = []
    stack = [plan]
    while stack:
        p = stack.pop(0)
        if isinstance(p, np.ndarray):
            out.append(p)
        elif isinstance(p, dict):
            stack[:0] = [p[k] for k in sorted(p)]
        elif isinstance(p, (list, tuple)):
            stack[:0] = list(p)
        elif p is not None:
            out.append(p)
    return out


@pytest.mark.parametrize("J,H,W,skips,incs", [
    (2, 128, 128, None, None), (3, 64, 70, None, (True, False, True)),
    (2, 12, 520, (True, False), None)])
def test_fwd_pyramid_plan(J, H, W, skips, incs):
    args = _fwd_args(J, H, W, skips, incs)
    mine, ref = _flat(pdt._fwd_pyramid_plan(*args)), \
        _flat(jdt._fwd_pyramid_plan(*args))
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        if isinstance(a, np.ndarray):
            _close(a, b)
        else:
            assert a == b


@pytest.mark.parametrize("yl_hw,highs_hw", [
    ((32, 32), ((64, 64), (32, 32))), ((18, 36), ((32, 35), (16, 18))),
    (None, ((6, 6), None, (2, 2)))])
def test_inv_pyramid_plan(yl_hw, highs_hw):
    args = (G["g0o"], G["g1o"], G["g0a"], G["g1a"], G["g0b"], G["g1b"],
            "symmetric", yl_hw, highs_hw)
    mine, ref = _flat(pdt._inv_pyramid_plan(*args)), \
        _flat(jdt._inv_pyramid_plan(*args))
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        if isinstance(a, np.ndarray):
            _close(a, b)
        else:
            assert a == b


@pytest.mark.parametrize("n", [12, 128, 520])
def test_band_plan_covers_every_nonzero(n):
    """The segment table at the planning sizes that K1 and K17 both
    report (``_TILE_ROWS`` / ``_K_ALIGN``, checked when each library
    loads)."""
    tile, align = banded._TILE_ROWS, banded._K_ALIGN
    blocks = [R for lev in pdt._fwd_pyramid_plan(*_fwd_args(2, n, n))
              for _, (R, _) in (lev["bands"] or [])]
    T = np.concatenate(blocks + [np.eye(n, dtype=np.float32)])
    plan = banded._band_plan(T)
    covered = np.zeros(T.shape, bool)
    rows = 0
    for r0, r1, segs in plan:
        assert r0 == rows and r1 - r0 <= tile
        rows = r1
        for c0, c1 in segs:
            assert c0 % align == 0 and 0 <= c0 < c1 <= n
            covered[r0:r1, c0:c1] = True
    assert rows == T.shape[0]
    assert not (T != 0)[~covered].any()
    if n >= 512:   # short bands: the segments skip most of the matrix
        assert covered.mean() < 0.5


@pytest.mark.parametrize("n", [64, 520])
def test_k1_plain_matches_jax_apply(n):
    R = pdt._fwd_pyramid_plan(*_fwd_args(2, n, n))[0]["bands"][0][1][0]
    x = _rand((2, 3, n, 20), 1)
    xr = _rand((2, 3, 20, n), 2)
    want = np.asarray(jbanded.apply_col(jnp.asarray(x), R))
    _close(banded.apply_col(torch.from_numpy(x), R).numpy(), want, atol=1e-6)
    acc = _rand(want.shape, 3)
    _close(banded.apply_col(torch.from_numpy(x), R,
                            torch.from_numpy(acc)).numpy(),
           acc + want, atol=1e-6)
    _close(banded.apply_row(torch.from_numpy(xr), R).numpy(),
           np.asarray(jbanded.apply_row(jnp.asarray(xr), R)), atol=1e-6)


def test_cpu_tensors_launch_nothing():
    n0 = (banded.apply_col.launches, banded.apply_row.launches)
    T = _rand((8, 6))
    banded.apply_col(torch.from_numpy(_rand((1, 2, 6, 5))), T)
    banded.apply_row(torch.from_numpy(_rand((1, 2, 5, 6))), T)
    assert (banded.apply_col.launches, banded.apply_row.launches) == n0


def test_extend_operator_equals_direct_probe():
    key = (F["h1b"], F["h1a"], True)
    small = dtcwt_fb._dfilt_matrix(*key, 256)
    big = banded.extend_operator(small, 520, 1, 1, (2, 4))
    _close(big, dtcwt_fb._dfilt_matrix(*key, 520), atol=0)


def test_extend_wrap_operator_matches_jax():
    from pytorch_wavelets_tpu.ops.afb_sfb import _afb_matrix
    r = np.random.RandomState(6)
    small = _afb_matrix(tuple(r.randn(6)), tuple(r.randn(6)),
                        "periodization", 64)          # (2 x 32, 64) probe
    _close(banded.extend_wrap_operator(small, 160, 2, 1),
           jbanded.extend_wrap_operator(small, 160, 2, 1), atol=0)


def test_q2c_c2q_match_jax():
    y = _rand((1, 2, 8, 10), 7)
    mine = dtcwt_fb.q2c(torch.from_numpy(y))
    ref = jfb.q2c(jnp.asarray(y))
    for (a, b), (c, d) in zip(mine, ref):
        _close(a.numpy(), np.asarray(c), atol=1e-7)
        _close(b.numpy(), np.asarray(d), atol=1e-7)
    w = [_rand((1, 2, 4, 5), 8 + k) for k in range(4)]
    _close(dtcwt_fb.c2q(*[(torch.from_numpy(w[k]), torch.from_numpy(w[k + 1]))
                         for k in (0, 2)]).numpy(),
           np.asarray(jfb.c2q(*[(jnp.asarray(w[k]), jnp.asarray(w[k + 1]))
                                for k in (0, 2)])), atol=1e-7)


@pytest.mark.parametrize("mode", PAD_MODES)
@pytest.mark.parametrize("front,back", [(2, 3), (9, 1)])
def test_pad1d(mode, front, back):
    x = _rand((1, 2, 5, 4), 4)
    for axis in (2, 3):
        got = pad1d(torch.from_numpy(x), front, back, axis, mode).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jpad1d(jnp.asarray(x), front, back, axis, mode)))


@pytest.mark.parametrize("axis", [2, 3])
def test_conv_path_matches_jax(axis):
    x = _rand((1, 2, 24, 28), 5)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)

    def jax_side(v):           # one XLA program
        return (jfb._filter_axis_conv(v, F["h0o"], axis, "symmetric"),
                jfb._dfilt_axis_conv(v, F["h0b"], F["h0a"], True,
                                     "symmetric", axis),
                jfb._ifilt_axis_conv(v, G["g0b"], G["g0a"], False,
                                     "symmetric", axis))
    pairs = zip(
        (dtcwt_fb._filter_axis_conv(xt, F["h0o"], axis, "symmetric"),
         dtcwt_fb._dfilt_axis_conv(xt, F["h0b"], F["h0a"], True, "symmetric",
                                   axis),
         dtcwt_fb._ifilt_axis_conv(xt, G["g0b"], G["g0a"], False,
                                   "symmetric", axis)),
        jax.jit(jax_side, compiler_options=FAST)(xj))
    for a, b in pairs:
        _close(a.numpy(), np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("dtype,offset,width,want", [
    (torch.float32, 4, 24, 16), (torch.float32, 3, 24, 4),
    (torch.float32, 4, 26, 4), (torch.bfloat16, 8, 24, 16),
    (torch.bfloat16, 2, 24, 4), (torch.bfloat16, 3, 24, 2),
    (torch.bfloat16, 8, 25, 2)])
def test_copy_bytes_by_view(dtype, offset, width, want):
    """The copy width of K1's and K17's staging for a column slice
    x = wide[..., offset:offset + 16] of rows ``width`` wide: 16 bytes
    where the pointer and every stride keep 16-byte alignment, else 4,
    else 2 (plain loads: a bf16 view at an odd element offset)."""
    wide = torch.zeros((2, 3, 8, width), dtype=dtype)
    assert wide.data_ptr() % 64 == 0     # the allocator's alignment
    x = wide[..., offset:offset + 16]
    T = torch.zeros((32, 16), dtype=dtype)
    assert banded._copy_bytes(x, T, (x.stride(2), x.stride(1))) == want
    # the operator's width (its row stride) counts too
    T_odd = torch.zeros((32, 15), dtype=dtype)
    assert banded._copy_bytes(x, T_odd, (x.stride(2),)) == \
        (2 if dtype == torch.bfloat16 else 4)


@pytest.mark.parametrize("M,Wc,planes,sms,want", [
    (256, 64, 1000, 132, 64),      # planes at most 64 wide
    (256, 65, 1000, 132, 128),     # wider, 4 x 1 x 1000 blocks
    (64, 96, 528, 132, 128),       # exactly two waves of two blocks
    (64, 96, 527, 132, 64),        # one block short
    (64, 96, 527, 100, 128),       # the same grid on fewer multiprocessors
    (640, 256, 20, 132, 64)])      # 10 x 2 x 20 = 400 blocks
def test_col_tile(M, Wc, planes, sms, want):
    """The width of K1's column tiles that the wrapper passes (and counts
    as ``async16_narrow`` where it is 64)."""
    assert banded._col_tile(M, Wc, planes, sms) == want
