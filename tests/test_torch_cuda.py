"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc, and skips without one (the
decision is made in a fixture, never at import).  On the GPU:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the repo's conftest configures JAX, which the GPU
machine need not have; this file imports torch, numpy and the port only.)
"""
import numpy as np
import pytest
import torch

import pytorch_wavelets_tpu_torch as tt
from pytorch_wavelets_tpu_torch import ops
from pytorch_wavelets_tpu_torch.ops import banded, fused_dtcwt, quad, scat_mag

pytestmark = pytest.mark.cuda

PYRAMID_KERNELS = ("apply_row", "apply_col", "q2c_pack", "c2q_unpack")

# fp32 sums of up to a few hundred products of O(1/sqrt(K)) terms, in
# another order than cuBLAS's: a few ulps of O(1) values
KTOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: python -m pytest --noconftest "
                    "-m cuda tests/test_torch_cuda.py on the GPU")
    return torch.device("cuda")


def _rand(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _banded_op(M, K, seed, band=None):
    T = _rand((M, K), seed) / np.sqrt(K)
    if band is not None:   # zero outside a diagonal band: exercises segments
        i, k = np.indices((M, K))
        T[np.abs(i * K / M - k) > band] = 0
    return T


@pytest.mark.parametrize("M,K,Wc,N,C,band", [
    (70, 45, 33, 2, 3, None), (128, 128, 128, 2, 2, None),
    (256, 128, 100, 1, 3, 9), (1920, 512, 40, 1, 2, 20)])
@pytest.mark.parametrize("accumulate", [False, True])
def test_apply_col(dev, M, K, Wc, N, C, band, accumulate):
    T = _banded_op(M, K, 1, band)
    wide = torch.from_numpy(_rand((N, C, K, Wc + 7), 2)).to(dev)
    x = wide[..., 3:3 + Wc]           # a column slice, read in place
    out = torch.from_numpy(_rand((N, C, M, Wc), 3)).to(dev)
    op = banded.Operator(T, dev)
    want = banded.apply_col_plain(x, op, out if accumulate else None)
    n0 = banded.apply_col.launches
    got = banded.apply_col(x, op, out.clone() if accumulate else None)
    torch.testing.assert_close(got, want, **KTOL)
    assert banded.apply_col.launches == n0 + 1


@pytest.mark.parametrize("accumulate", [False, True])
def test_apply_col_strided_out(dev, accumulate):
    """The output is a column slice of a wider tensor (the forward's
    backward writes its blocks of dz side by side)."""
    M, K, Wc, N, C = 96, 80, 40, 2, 3
    T = _banded_op(M, K, 11, 12)
    x = torch.from_numpy(_rand((N, C, K, Wc), 12)).to(dev)
    wide = torch.from_numpy(_rand((N, C, M, Wc + 30), 13)).to(dev)
    op = banded.Operator(T, dev)
    want = wide.clone()
    want[..., 10:10 + Wc] = banded.apply_col_plain(
        x, op, wide[..., 10:10 + Wc] if accumulate else None)
    got = wide.clone()
    n0 = banded.apply_col.launches
    out = banded.apply_col(x, op, got[..., 10:10 + Wc], accumulate)
    assert out.data_ptr() == got[..., 10:10 + Wc].data_ptr()
    torch.testing.assert_close(got, want, **KTOL)
    assert banded.apply_col.launches == n0 + 1


@pytest.mark.parametrize("R,K,Kout,band", [
    (3 * 70, 45, 33, None), (2 * 128, 128, 448, None),
    (5 * 37, 512, 1920, 20)])
def test_apply_row(dev, R, K, Kout, band):
    T = _banded_op(Kout, K, 4, band)
    wide = torch.from_numpy(_rand((1, R, 1, K + 9), 5)).to(dev)
    x = wide[..., 4:4 + K].reshape(1, 1, R, K)   # strided rows
    op = banded.Operator(T, dev)
    want = banded.apply_row_plain(x, op)
    n0 = banded.apply_row.launches
    got = banded.apply_row(x, op)
    torch.testing.assert_close(got, want, **KTOL)
    assert banded.apply_row.launches == n0 + 1


@pytest.mark.parametrize("o_dim,ri_dim", [(2, -1), (1, 3), (0, 5), (4, 2)])
def test_q2c_pack_and_c2q_unpack(dev, o_dim, ri_dim):
    from pytorch_wavelets_tpu_torch.transforms.dtcwt import get_dimensions5
    od, rd, _, _ = get_dimensions5(o_dim, ri_dim)
    N, C, m, k = 2, 3, 5, 7
    orients = ((2, 3), (1, 4))
    y = torch.from_numpy(_rand((N, C, 2 * 2 * m, 2 * k), 6)).to(dev)
    shape = [N, C, m, k]
    shape.insert(od, 6)
    shape.insert(rd, 2)
    h_got = torch.zeros(shape, device=dev)
    h_want = torch.zeros(shape, device=dev)
    quad.q2c_pack(y, fused_dtcwt.canonical_bands(h_got, od, rd), orients)
    quad.q2c_pack_plain(y, fused_dtcwt.canonical_bands(h_want, od, rd),
                        orients)
    torch.testing.assert_close(h_got, h_want, rtol=0, atol=0)
    hc = fused_dtcwt.canonical_bands(
        torch.from_numpy(_rand(shape, 7)).to(dev), od, rd)
    torch.testing.assert_close(quad.c2q_unpack(hc, orients),
                               quad.c2q_unpack_plain(hc, orients),
                               rtol=0, atol=0)


@pytest.mark.parametrize("shape,J,kw", [
    ((2, 3, 63, 70), 3, {}), ((1, 2, 64, 64), 2, dict(o_dim=1, ri_dim=3)),
    ((2, 1, 128, 96), 2, dict(skip_hps=[True, False], include_scale=True))])
def test_dtcwt_matches_cpu(dev, shape, J, kw):
    x = torch.from_numpy(_rand(shape, 8))
    dims = {k: v for k, v in kw.items() if k in ("o_dim", "ri_dim")}
    outs = {}
    ops.reset_launches()
    for d in ("cpu", dev):
        yl, yh = tt.DTCWTForward(J=J, device=d, **kw)(x.to(d))
        low = yl[-1] if isinstance(yl, list) else yl
        rec = tt.DTCWTInverse(device=d, **dims)((low, yh))
        outs[str(d)] = [low, *[h for h in yh if h is not None], rec]
    for a, b in zip(outs["cpu"], outs["cuda"]):
        torch.testing.assert_close(b.cpu(), a, rtol=1e-5, atol=1e-5)
    counts = ops.launch_counts()
    assert all(counts[k] > 0 for k in PYRAMID_KERNELS)


def test_perfect_reconstruction(dev):
    x = torch.from_numpy(_rand((4, 3, 128, 128), 9)).to(dev)
    rec = tt.DTCWTInverse(device=dev)(tt.DTCWTForward(J=3, device=dev)(x))
    assert (rec - x).abs().max().item() <= 1e-5


def test_cuda_path_refuses(dev):
    """A raw kernel call that would need a gradient, the 'high' precision
    level, float64 and a CPU input to a CUDA module raise; the modules
    themselves differentiate (see the gradient tests)."""
    f = tt.DTCWTForward(J=2, device=dev)
    x = torch.from_numpy(_rand((1, 1, 32, 32), 10)).to(dev)
    op = banded.Operator(np.eye(32, dtype=np.float32), dev)
    with pytest.raises(NotImplementedError, match="raw kernel call"):
        banded.apply_col(x.clone().requires_grad_(), op)
    with tt.matmul_precision("high"), pytest.raises(NotImplementedError):
        f(x)
    with pytest.raises(TypeError):
        f(x.double())
    with pytest.raises(ValueError):
        f(x.cpu())
    with torch.no_grad():
        banded.apply_col(x.clone().requires_grad_(), op)


MAG_TOL = dict(rtol=3e-7, atol=1e-7)   # IEEE-rounded ops in the same order


@pytest.mark.parametrize("combine", [False, True])
@pytest.mark.parametrize("bias", [1e-2, 0.0])
def test_scat_mag(dev, combine, bias):
    """K4/K5 against their plain versions, on bands read through strides
    (a re/im-last slice of a wider tensor) and a strided cotangent."""
    wide = torch.from_numpy(_rand((2, 6, 3, 9, 11, 3), 14)).to(dev)
    h = wide[..., 1:10, :2]           # (2, 6, 3, 9, 9, 2), strided
    h[0, 0, 0, 0] = 0                 # zeros: NaN gradient at bias 0
    cout = 1 if combine else 3
    g = torch.from_numpy(_rand((2, 6, cout, 9, 18), 15)).to(dev)[..., ::2]
    n0 = (scat_mag.scat_mag_fwd.launches, scat_mag.scat_mag_bwd.launches)
    torch.testing.assert_close(scat_mag.scat_mag_fwd(h, bias, combine),
                               scat_mag.scat_mag_fwd_plain(h, bias, combine),
                               **MAG_TOL)
    torch.testing.assert_close(scat_mag.scat_mag_bwd(h, g, bias, combine),
                               scat_mag.scat_mag_bwd_plain(h, g, bias,
                                                           combine),
                               equal_nan=bias == 0.0, **MAG_TOL)
    assert (scat_mag.scat_mag_fwd.launches,
            scat_mag.scat_mag_bwd.launches) == (n0[0] + 1, n0[1] + 1)


def _grads(module_of, shape, dev, seed):
    """Output and input gradient of sum(out * G) on the CPU and on ``dev``
    (the module's own outputs flattened)."""
    x = torch.from_numpy(_rand(shape, seed))
    res = {}
    for d in ("cpu", dev):
        xt = x.to(d).detach().requires_grad_()
        out = module_of(d)(xt)
        outs = [t for t in (out if isinstance(out, (list, tuple)) else
                            [out]) for t in (t if isinstance(t, list)
                                             else [t]) if t is not None]
        loss = sum((o * torch.from_numpy(_rand(o.shape, seed + 1 + k))
                    .to(d)).sum() for k, o in enumerate(outs))
        loss.backward()
        res[str(d)] = [o.detach().cpu() for o in outs] + [xt.grad.cpu()]
    return res["cpu"], res["cuda"]


@pytest.mark.parametrize("kw", [dict(J=2), dict(J=3, o_dim=1, ri_dim=3,
                                                skip_hps=[False, True,
                                                          False])])
def test_dtcwt_gradients_match_cpu(dev, kw):
    ops.reset_launches()
    dims = {k: v for k, v in kw.items() if k in ("o_dim", "ri_dim")}

    def round_trip(d):
        f = tt.DTCWTForward(device=d, **kw)
        i = tt.DTCWTInverse(device=d, **dims)
        return lambda x: [*f(x), i(f(x))]
    cpu, gpu = _grads(round_trip, (2, 3, 63, 70), dev, 16)
    for a, b in zip(cpu, gpu):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=2e-5)
    counts = ops.launch_counts()
    assert all(counts[k] > 0 for k in PYRAMID_KERNELS)


@pytest.mark.parametrize("kw", [dict(), dict(combine_colour=True)])
def test_scatlayerj2_gradients_match_cpu(dev, kw):
    ops.reset_launches()
    cpu, gpu = _grads(lambda d: tt.ScatLayerj2(device=d, **kw),
                      (2, 3, 64, 64), dev, 17)
    for a, b in zip(cpu, gpu):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=2e-5)
    counts = ops.launch_counts()
    assert all(counts[k] > 0 for k in (*PYRAMID_KERNELS, "scat_mag_fwd",
                                       "scat_mag_bwd"))


# K6/K7: fp32 sums of up to 76 products in another order than cuDNN's
DWT_TOL = dict(rtol=1e-5, atol=1e-5)
DWT_MODES = ("zero", "symmetric", "reflect", "periodic", "periodization")


def _taps(L, seed):
    rs = np.random.RandomState(seed)
    return rs.randn(L) / np.sqrt(L), rs.randn(L) / np.sqrt(L)


@pytest.mark.parametrize("mode", DWT_MODES)
@pytest.mark.parametrize("L,n", [(2, 16), (8, 33), (8, 6), (76, 20),
                                 (76, 7), (13, 40)])
@pytest.mark.parametrize("axis", [2, 3])
def test_dwt_afb(dev, mode, L, n, axis):
    """K6 against its plain version: every mode, odd sizes, filters
    longer than the axis (db38's 76 taps: periodization's single fold),
    a strided input (a band of a wider stack) and a cropped output."""
    from pytorch_wavelets_tpu_torch.ops import afb_sfb
    h0, h1 = _taps(L, 20 + L)
    shape = [2, 3, 9, 11]
    shape[axis] = n
    wide = torch.from_numpy(_rand((shape[0], shape[1], 4, *shape[2:]), 21))
    x = wide.to(dev)[:, :, 2]
    want = afb_sfb.afb1d_corr_plain(x, h0, h1, mode, axis)
    n0 = afb_sfb.afb1d_corr.launches
    got = afb_sfb.afb1d_corr(x, h0, h1, mode, axis)
    torch.testing.assert_close(got, want, **DWT_TOL)
    m = max(want.shape[axis + 1] - 2, 0)
    torch.testing.assert_close(afb_sfb.afb1d_corr(x, h0, h1, mode, axis, m),
                               want.narrow(axis + 1, 0, m), **DWT_TOL)
    assert afb_sfb.afb1d_corr.launches == n0 + (2 if m else 1)


@pytest.mark.parametrize("mode", DWT_MODES)
@pytest.mark.parametrize("L,n", [(2, 16), (8, 33), (8, 6), (76, 20),
                                 (76, 7), (13, 40)])
@pytest.mark.parametrize("axis", [2, 3])
def test_dwt_sfb(dev, mode, L, n, axis):
    """K7 against its plain version on the coefficients of a length-n
    axis, lo and hi read in place as two bands of one (N, C, 3, H, W)
    stack, and a cropped output."""
    from pytorch_wavelets_tpu_torch.ops import afb_sfb
    from pytorch_wavelets_tpu_torch.utils import dwt_coeff_len
    g0, g1 = _taps(L, 30 + L)
    nin = dwt_coeff_len(n, L, mode)
    shape = [2, 3, 7, 5]
    shape[axis] = nin
    stack = torch.from_numpy(_rand((shape[0], shape[1], 3, *shape[2:]), 31))
    stack = stack.to(dev)
    lo, hi = stack[:, :, 2], stack[:, :, 0]
    want = afb_sfb.sfb1d_conv_plain(lo, hi, g0, g1, mode, axis)
    n0 = afb_sfb.sfb1d_conv.launches
    got = afb_sfb.sfb1d_conv(lo, hi, g0, g1, mode, axis)
    torch.testing.assert_close(got, want, **DWT_TOL)
    m = max(want.shape[axis] - 3, 0)
    torch.testing.assert_close(afb_sfb.sfb1d_conv(lo, hi, g0, g1, mode, axis,
                                                  m),
                               want.narrow(axis, 0, m), **DWT_TOL)
    assert afb_sfb.sfb1d_conv.launches == n0 + (2 if m else 1)


@pytest.mark.parametrize("mode", DWT_MODES)
@pytest.mark.parametrize("wave,shape", [("db4", (2, 3, 64, 64)),
                                        ("bior2.2", (1, 2, 33, 29)),
                                        ("db38", (1, 2, 20, 18))])
def test_dwt_gradients_match_cpu(dev, mode, wave, shape):
    """DWTForward -> DWTInverse outputs and x.grad (the reference-semantics
    backwards, K7 then K6) on the card against the CPU plain run."""
    ops.reset_launches()

    def round_trip(d):
        f = tt.DWTForward(J=3, wave=wave, mode=mode, device=d)
        i = tt.DWTInverse(wave=wave, mode=mode, device=d)

        def run(x):
            yl, yh = f(x)
            return [yl, *yh, i((yl, yh))]
        return run
    cpu, gpu = _grads(round_trip, shape, dev, 40)
    for a, b in zip(cpu, gpu):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=2e-5)
    counts = ops.launch_counts()
    assert counts["afb1d_corr"] > 0 and counts["sfb1d_conv"] > 0


@pytest.mark.parametrize("mode", ["symmetric", "periodization"])
def test_dwt1d_gradients_match_cpu(dev, mode):
    ops.reset_launches()

    def round_trip(d):
        f = tt.DWT1DForward(J=4, wave="db4", mode=mode, device=d)
        i = tt.DWT1DInverse(wave="db4", mode=mode, device=d)

        def run(x):
            yl, yh = f(x[:, 0])
            return [yl, *yh, i((yl, yh))]
        return run
    cpu, gpu = _grads(round_trip, (2, 1, 3, 301), dev, 41)
    for a, b in zip(cpu, gpu):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=2e-5)
    counts = ops.launch_counts()
    assert counts["afb1d_corr"] > 0 and counts["sfb1d_conv"] > 0


def test_dwt_refuses(dev):
    from pytorch_wavelets_tpu_torch.ops import afb_sfb
    x = torch.from_numpy(_rand((1, 1, 16, 16), 42)).to(dev)
    h0, h1 = _taps(4, 43)
    with pytest.raises(NotImplementedError, match="raw kernel call"):
        afb_sfb.afb1d_corr(x.clone().requires_grad_(), h0, h1, "zero", 3)
    with pytest.raises(TypeError):
        tt.DWTForward(device=dev)(x.double())
    with pytest.raises(ValueError, match="1..128"):
        afb_sfb.afb1d_corr(x, np.ones(129), np.ones(129), "zero", 3)
    with tt.matmul_precision("high"), pytest.raises(NotImplementedError):
        tt.DWTForward(device=dev)(x)
