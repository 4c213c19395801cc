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

# The CPU references run at one thread, as every CPU test file of the port
# does: PyTorch's CPU ``sqrt`` can differ in one worker thread on its first
# call in a multi-threaded process (ROADMAP.md, section C).
torch.set_num_threads(1)

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


def _test_op(M, K, seed, band):
    """An operator of the K1 / K17 tests: ``band`` None (dense), a band
    half-width (:func:`_banded_op`), "short" (one nonzero a row, so each
    tile of 64 rows of T has one segment shorter than a 32-deep stage) or
    "gap" (dense but for rows 64-127: a T-row tile with no segment, whose
    output rows are zero, or left as they were under accumulate)."""
    if band == "short":
        T = np.zeros((M, K), np.float32)
        i = np.arange(M)
        T[i, i * K // M] = _rand((M,), seed)
        return T
    T = _banded_op(M, K, seed, None if band == "gap" else band)
    if band == "gap":
        T[64:128] = 0
    return T


# The views K1 and K17 read (a slice x = wide[..., o:o + n] of a wider
# tensor), by (o, the width of wide): "aligned" at 16 bytes in fp32 and
# bf16; "offset", o = 3 (4-byte aligned in fp32, 2-byte in bf16: an odd
# element offset); "even", o = 2 and an even width (4-byte aligned in
# bf16, not 16)
def _view_geometry(view, n):
    if view == "aligned":
        return 8, -(-(n + 8) // 8) * 8
    if view == "offset":
        return 3, n + 7
    w = n + 6
    return 2, w + w % 2


def _expected_copy(view, n, K, dtype):
    """The copy width the kernels' staging takes for a view of
    :func:`_view_geometry` and an operator of width K (its row stride): the
    widest of 16 and 4 bytes that the offset, the row width and K keep,
    else plain 2-byte loads."""
    es = 2 if dtype == torch.bfloat16 else 4
    o, w = _view_geometry(view, n)
    for width, name in ((16, "async16"), (4, "async4")):
        if all(v * es % width == 0 for v in (o, w, K)):
            return name
    return "load2"


def _view(dev, dtype, lead, n, view, seed):
    o, w = _view_geometry(view, n)
    wide = torch.from_numpy(_rand((*lead, w), seed)).to(dev, dtype)
    return wide[..., o:o + n]


@pytest.mark.parametrize("view", ["aligned", "offset"])
@pytest.mark.parametrize("M,K,Wc,N,C,band,tile", [
    (70, 45, 33, 2, 3, None, 64), (128, 128, 128, 2, 2, None, 64),
    (256, 128, 100, 1, 3, 9, 64), (1920, 512, 40, 1, 2, 20, 64),
    (64, 2048, 65, 1, 2, None, 64),        # K longer than the ring
    (256, 64, 100, 1, 3, "short", 64),     # segments shorter than a stage
    (256, 128, 70, 2, 1, "gap", 64),       # a T-row tile with no segment
    (16, 16, 8, 1, 65600, None, 64),       # more than 65,535 planes
    (64, 64, 96, 4, "sms", 9, 128)])       # 4 x (the card's SMs) planes
@pytest.mark.parametrize("accumulate", [False, True])
def test_apply_col(dev, M, K, Wc, N, C, band, tile, accumulate, view):
    """K1's column entry on a column slice read in place, by instantiation:
    each case asserts the copy width and, with 16-byte copies, the tile
    width (64 columns for narrow planes or small grids, 128 for a grid of
    two waves of two blocks a multiprocessor) that ran."""
    if C == "sms":
        C = torch.cuda.get_device_properties(dev).multi_processor_count
    T = _test_op(M, K, 1, band)
    x = _view(dev, torch.float32, (N, C, K), Wc, view, 2)
    out = torch.from_numpy(_rand((N, C, M, Wc), 3)).to(dev)
    op = banded.Operator(T, dev)
    want = banded.apply_col_plain(x, op, out if accumulate else None)
    n0 = banded.apply_col.launches
    copy = _expected_copy(view, Wc, K, torch.float32)
    if copy == "async16" and tile == 64:
        copy = "async16_narrow"
    c0 = banded.apply_col.copies[copy]
    got = banded.apply_col(x, op, out.clone() if accumulate else None)
    torch.testing.assert_close(got, want, **KTOL)
    assert banded.apply_col.launches == n0 + 1
    assert banded.apply_col.copies[copy] == c0 + 1
    if band == "gap":
        torch.testing.assert_close(got[:, :, 64:128],
                                   out[:, :, 64:128] if accumulate
                                   else torch.zeros_like(got[:, :, 64:128]),
                                   rtol=0, atol=0)


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


@pytest.mark.parametrize("view", ["aligned", "offset"])
@pytest.mark.parametrize("R,K,Kout,band", [
    (3 * 70, 45, 33, None), (2 * 128, 128, 448, None),
    (5 * 37, 512, 1920, 20),
    (300, 2048, 96, None),                 # K longer than the ring
    (3 * 70, 64, 256, "short"),            # segments shorter than a stage
    (2 * 128, 128, 200, "gap"),            # a T-row tile with no segment
    (70000, 16, 24, None)])                # more than 65,535 rows
@pytest.mark.parametrize("accumulate", [False, True])
def test_apply_row(dev, R, K, Kout, band, view, accumulate):
    """K1's row entry on the rows of a column slice (strided rows), a new
    output and accumulation, by copy width: each case asserts the
    instantiation that ran."""
    T = _test_op(Kout, K, 4, band)
    x = _view(dev, torch.float32, (1, R, 1), K, view, 5).reshape(1, 1, R, K)
    out = torch.from_numpy(_rand((1, 1, R, Kout), 6)).to(dev)
    op = banded.Operator(T, dev)
    want = banded.apply_row_plain(x, op, out if accumulate else None)
    n0 = banded.apply_row.launches
    copy = _expected_copy(view, K, K, torch.float32)
    c0 = banded.apply_row.copies[copy]
    got = banded.apply_row(x, op, out.clone() if accumulate else None)
    torch.testing.assert_close(got, want, **KTOL)
    assert banded.apply_row.launches == n0 + 1
    assert banded.apply_row.copies[copy] == c0 + 1
    if band == "gap":
        torch.testing.assert_close(got[..., 64:128],
                                   out[..., 64:128] if accumulate
                                   else torch.zeros_like(got[..., 64:128]),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("o_dim,ri_dim", [(2, -1), (1, 3), (0, 5), (4, 2)])
def test_q2c_pack_and_c2q_unpack(dev, o_dim, ri_dim, dtype):
    """K2/K3 against their plain versions computed in fp32 and rounded
    once to ``dtype`` (as the kernels round bf16), bit for bit."""
    from pytorch_wavelets_tpu_torch.transforms.dtcwt import get_dimensions5
    od, rd, _, _ = get_dimensions5(o_dim, ri_dim)
    N, C, m, k = 2, 3, 5, 7
    orients = ((2, 3), (1, 4))
    y = torch.from_numpy(_rand((N, C, 2 * 2 * m, 2 * k), 6)).to(dev, dtype)
    shape = [N, C, m, k]
    shape.insert(od, 6)
    shape.insert(rd, 2)
    h_got = torch.zeros(shape, device=dev, dtype=dtype)
    h_want = torch.zeros(shape, device=dev)
    quad.q2c_pack(y, fused_dtcwt.canonical_bands(h_got, od, rd), orients)
    quad.q2c_pack_plain(y.float(),
                        fused_dtcwt.canonical_bands(h_want, od, rd), orients)
    torch.testing.assert_close(h_got, h_want.to(dtype), rtol=0, atol=0)
    hc = fused_dtcwt.canonical_bands(
        torch.from_numpy(_rand(shape, 7)).to(dev, dtype), od, rd)
    torch.testing.assert_close(
        quad.c2q_unpack(hc, orients),
        quad.c2q_unpack_plain(hc.float(), orients).to(dtype), rtol=0, atol=0)


def _q2c_group(dev, N, C, m, k, nm, interleaved, dtype, shift=0, seed=30):
    """The group output K2 reads: composed (N, C, nm 2m, 2k), or per level
    (N, C, nm, 2m, 2k) ``shift`` elements into rows of 2k + 3."""
    if not interleaved:
        return torch.from_numpy(_rand((N, C, nm * 2 * m, 2 * k), seed)).to(
            dev, dtype)
    wide = torch.from_numpy(_rand((N, C, nm, 2 * m, 2 * k + 3), seed)).to(
        dev, dtype)
    return wide[..., shift:shift + 2 * k]


Q2C_VIEWS = [
    # (case, m, k, interleaved, o_dim, ri_dim, bands offset, y shift,
    #  instantiation)
    ("composed", 3, 8, False, 2, -1, 0, 0, "vector"),
    ("composed odd k", 3, 7, False, 2, -1, 0, 0, "vector"),
    ("composed offset bands", 2, 6, False, 2, -1, 2, 0, "vector"),
    ("composed scat layout", 3, 5, False, 1, -1, 0, 0, "vector"),
    ("composed o first", 2, 9, False, 0, 5, 6, 0, "vector"),
    ("composed wide", 5, 130, False, 2, -1, 0, 0, "vector"),
    ("per level", 3, 8, True, 2, -1, 0, 0, "vector"),
    ("per level odd k", 3, 5, True, 1, -1, 0, 0, "vector"),
    ("per level shifted rows", 2, 6, True, 2, -1, 4, 1, "vector"),
    ("per level wide", 4, 300, True, 2, -1, 0, 2, "vector"),
    ("composed re/im apart", 3, 8, False, 1, 3, 0, 0, "strided"),
    ("composed off a pair", 3, 8, False, 2, -1, 1, 0, "strided"),
    ("per level re/im apart", 3, 5, True, 4, 2, 0, 0, "strided"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case,m,k,il,o_dim,ri_dim,off,shift,inst",
                         Q2C_VIEWS, ids=[v[0] for v in Q2C_VIEWS])
def test_q2c_pack_instantiations(dev, case, m, k, il, o_dim, ri_dim, off,
                                 shift, inst, dtype):
    """K2 in each instantiation at the edge views (odd k, bands off their
    16-byte lines, per-level rows off theirs, every layout), bit for bit
    its plain version computed in fp32 and rounded once; each call moves
    its instantiation's count by one and writes nothing else."""
    from pytorch_wavelets_tpu_torch.transforms.dtcwt import get_dimensions5
    od, rd, _, _ = get_dimensions5(o_dim, ri_dim)
    N, C = 2, 3
    orients = ((0, 5), (2, 3), (1, 4)) if il else ((2, 3), (1, 4))
    y = _q2c_group(dev, N, C, m, k, len(orients), il, dtype, shift)
    shape = [N, C, m, k]
    shape.insert(od, 6)
    shape.insert(rd, 2)
    size = int(np.prod(shape))
    buf = torch.full((size + off,), float("nan"), device=dev, dtype=dtype)
    h = torch.as_strided(buf, shape, torch.empty(shape).stride(), off)
    want = torch.full(shape, float("nan"), device=dev)
    hc = fused_dtcwt.canonical_bands(h, od, rd)
    before = dict(quad.q2c_pack.instantiations)
    quad.q2c_pack(y, hc, orients, il)
    torch.cuda.synchronize()
    assert {k_: v - before[k_] for k_, v in
            quad.q2c_pack.instantiations.items()} == {
        k_: int(k_ == inst) for k_ in before}
    quad.q2c_pack_plain(y.float(), fused_dtcwt.canonical_bands(want, od, rd),
                        orients, il)
    torch.testing.assert_close(h, want.to(dtype), rtol=0, atol=0,
                               equal_nan=True)
    assert bool(buf[:off].isnan().all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_default_layouts_take_vector_q2c(dev, dtype):
    """Every K2 call of the composed and per-level DTCWT and of the
    scattering layers, forward and backward, in the default band layout,
    takes the vector instantiation."""
    runs = [lambda d: tt.DTCWTForward(J=2, device=d),
            lambda d: tt.ScatLayerj2(device=d),
            lambda d: tt.ScatLayerj2(biort="near_sym_b_bp",
                                     qshift="qshift_b_bp", device=d)]
    x = torch.from_numpy(_rand((2, 3, 64, 64), 31)).to(dev, dtype)
    for make in runs:
        m = make(dev)
        xg = x.detach().requires_grad_()
        ops.reset_launches()
        out = m(xg)
        outs = [out] if isinstance(out, torch.Tensor) else \
            [out[0], *out[1]]
        torch.autograd.grad(outs, xg, [torch.ones_like(o) for o in outs])
        torch.cuda.synchronize()
        n, insts = ops.launch_counts()["q2c_pack"], \
            ops.instantiation_counts()["q2c_pack"]
        assert n > 0 and insts == {"vector": n, "strided": 0}
    with _per_level():
        m = tt.DTCWTForward(J=2, device=dev)
        ops.reset_launches()
        m(x)
        torch.cuda.synchronize()
        n = ops.launch_counts()["q2c_pack"]
        assert n > 0 and ops.instantiation_counts()["q2c_pack"] == {
            "vector": n, "strided": 0}


C2Q_VIEWS = [
    # (case, h, w, interleaved, o_dim, ri_dim, bands offset, instantiation)
    ("composed", 3, 8, False, 2, -1, 0, "vector"),
    ("composed odd w", 3, 7, False, 2, -1, 0, "vector"),
    ("composed w 1", 2, 1, False, 2, -1, 0, "vector"),
    ("composed offset 2", 2, 6, False, 2, -1, 2, "vector"),
    ("composed offset 4", 3, 9, False, 2, -1, 4, "vector"),
    ("composed offset 6", 2, 10, False, 2, -1, 6, "vector"),
    ("composed scat layout", 3, 5, False, 1, -1, 0, "vector"),
    ("composed o first", 2, 9, False, 0, 5, 6, "vector"),
    ("composed wide", 5, 300, False, 2, -1, 2, "vector"),
    ("per level", 3, 8, True, 2, -1, 0, "vector"),
    ("per level odd w", 3, 5, True, 1, -1, 0, "vector"),
    ("per level offset", 2, 6, True, 2, -1, 4, "vector"),
    ("per level wide", 4, 300, True, 2, -1, 0, "vector"),
    ("composed re/im apart", 3, 8, False, 1, 3, 0, "strided"),
    ("composed off a pair", 3, 8, False, 2, -1, 3, "strided"),
    ("per level re/im apart", 3, 5, True, 4, 2, 0, "strided"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case,m,k,il,o_dim,ri_dim,off,inst", C2Q_VIEWS,
                         ids=[v[0] for v in C2Q_VIEWS])
def test_c2q_unpack_instantiations(dev, case, m, k, il, o_dim, ri_dim, off,
                                   inst, dtype):
    """K3 in each instantiation at the edge views (odd w, w = 1, bands off
    their 16-byte lines, every layout), bit for bit its plain version
    computed in fp32 and rounded once into a NaN-filled output; each call
    moves its instantiation's count by one."""
    from pytorch_wavelets_tpu_torch.transforms.dtcwt import get_dimensions5
    od, rd, _, _ = get_dimensions5(o_dim, ri_dim)
    orients = ((0, 5), (2, 3), (1, 4)) if il else ((2, 3), (1, 4))
    shape = [2, 3, m, k]
    shape.insert(od, 6)
    shape.insert(rd, 2)
    buf = torch.from_numpy(_rand((int(np.prod(shape)) + off,), 32)).to(
        dev, dtype)
    h = fused_dtcwt.canonical_bands(
        torch.as_strided(buf, shape, torch.empty(shape).stride(), off), od,
        rd)
    got = torch.full(quad._c2q_addr(h, len(orients), il)[0], float("nan"),
                     device=dev, dtype=dtype)
    before = dict(quad.c2q_unpack.instantiations)
    quad.c2q_unpack(h, orients, il, out=got)
    torch.cuda.synchronize()
    assert {k_: v - before[k_] for k_, v in
            quad.c2q_unpack.instantiations.items()} == {
        k_: int(k_ == inst) for k_ in before}
    want = quad.c2q_unpack_plain(h.float(), orients, il).to(dtype)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_default_layouts_take_vector_c2q(dev, dtype):
    """Every K3 call of the composed and per-level DTCWT and of the
    scattering layers' backwards, in the default band layout, takes the
    vector instantiation."""
    runs = [lambda d: (tt.DTCWTForward(J=2, device=d),
                       tt.DTCWTInverse(device=d)),
            lambda d: (tt.ScatLayerj2(device=d), None),
            lambda d: (tt.ScatLayerj2(biort="near_sym_b_bp",
                                      qshift="qshift_b_bp", device=d), None)]
    x = torch.from_numpy(_rand((2, 3, 64, 64), 33)).to(dev, dtype)
    for make in runs:
        f, i = make(dev)
        xg = x.detach().requires_grad_()
        ops.reset_launches()
        out = f(xg) if i is None else i(f(xg))
        torch.autograd.grad(out, xg, torch.ones_like(out))
        torch.cuda.synchronize()
        n, insts = ops.launch_counts()["c2q_unpack"], \
            ops.instantiation_counts()["c2q_unpack"]
        assert n > 0 and insts == {"vector": n, "strided": 0}
    with _per_level():
        f, i = tt.DTCWTForward(J=2, device=dev), tt.DTCWTInverse(device=dev)
        ops.reset_launches()
        i(f(x))
        torch.cuda.synchronize()
        n = ops.launch_counts()["c2q_unpack"]
        assert n > 0 and ops.instantiation_counts()["c2q_unpack"] == {
            "vector": n, "strided": 0}


class _per_level:
    """The per-level path for the body (set_operator_matmul(False))."""

    def __enter__(self):
        banded.set_operator_matmul(False)

    def __exit__(self, *exc):
        banded.set_operator_matmul(None)


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
    """A raw kernel call that would need a gradient, float64 and a CPU
    input to a CUDA module raise; the 'high' precision level runs K17's
    3xTF32 mode; the modules themselves differentiate (see the gradient
    tests)."""
    f = tt.DTCWTForward(J=2, device=dev)
    x = torch.from_numpy(_rand((1, 1, 32, 32), 10)).to(dev)
    op = banded.Operator(np.eye(32, dtype=np.float32), dev)
    with pytest.raises(NotImplementedError, match="raw kernel call"):
        banded.apply_col(x.clone().requires_grad_(), op)
    ops.reset_launches()
    with tt.matmul_precision("high"):
        f(x)
    counts = ops.launch_counts()
    assert counts["apply_row_3xtf32"] > 0 and counts["apply_row"] == 0
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


def _dev_view(dev, shape, strides=None, offset=0, seed=0):
    """A view of a flat buffer on the card (its base 256-byte aligned):
    ``strides`` None is the contiguous layout, ``offset`` in floats."""
    if strides is None:
        strides = torch.empty(shape).stride()
    size = offset + 1 + sum((n - 1) * s for n, s in zip(shape, strides))
    buf = torch.from_numpy(_rand((size,), seed)).to(dev)
    return torch.as_strided(buf, shape, strides, offset)


def _mag_band(dev, n=2, c=3, hh=5, ww=8, offset=0):
    return _dev_view(dev, (n, 6, c, hh, ww, 2), offset=offset, seed=21)


def _mag_cat_slice(dev, n, c, hh, ww):
    """The cotangent as torch.cat's backward hands it to K5: a
    plane-contiguous slice of a wider (N, 49C, h, w) gradient."""
    G = _dev_view(dev, (n, 49 * c, hh, ww), seed=22)
    return G[:, 7 * c:13 * c].view(n, 6, c, hh, ww)


# K4/K5's edge views (tests/test_torch_mag_plans.py emulates the vector
# instantiation's map on them): (case, bands, combine, cotangent or None
# for a contiguous one, the instantiation both kernels take)
MAG_VIEWS = [
    ("contiguous", lambda d: _mag_band(d), False, None, "vector"),
    ("combine C=3", lambda d: _mag_band(d), True, None, "vector"),
    ("combine C=5", lambda d: _mag_band(d, c=5), True, None, "strided"),
    ("re/im-last slice", lambda d: _dev_view(d, (2, 6, 3, 9, 11, 3))[
        ..., 1:10, :2], False, None, "strided"),
    ("transposed", lambda d: _mag_band(d).transpose(3, 4), False, None,
     "strided"),
    ("offset 4 bytes", lambda d: _mag_band(d, offset=1), False, None,
     "strided"),
    ("offset 8 bytes", lambda d: _mag_band(d, offset=2), False, None,
     "vector"),
    ("offset 8 bytes combine", lambda d: _mag_band(d, offset=2), True, None,
     "vector"),
    ("odd width", lambda d: _mag_band(d, hh=5, ww=7), False, None, "vector"),
    ("odd width combine", lambda d: _mag_band(d, hh=5, ww=7), True, None,
     "strided"),
    ("width 1", lambda d: _mag_band(d, hh=4, ww=1), False, None, "vector"),
    ("two chunks odd", lambda d: _mag_band(d, n=1, c=2, hh=33, ww=35),
     False, None, "vector"),
    ("cat slice cotangent", lambda d: _mag_band(d, hh=3, ww=5), False,
     lambda d: _mag_cat_slice(d, 2, 3, 3, 5), "vector"),
]


@pytest.mark.parametrize("bias", [1e-2, 0.0])
@pytest.mark.parametrize("case,bands,combine,cot,inst", MAG_VIEWS,
                         ids=[v[0] for v in MAG_VIEWS])
def test_scat_mag_instantiations(dev, case, bands, combine, cot, inst,
                                 bias):
    """K4 and K5 in each instantiation at the edge views, against their
    plain versions (b = 0: a zero coefficient, 0 forward and NaN
    backward); each call moves its instantiation's count by one."""
    h = bands(dev)
    h[0, 0, :, 0, 0] = 0
    N, _, C, hh, ww, _ = h.shape
    cout = 1 if combine else C
    g = cot(dev) if cot else _dev_view(dev, (N, 6, cout, hh, ww), seed=23)
    for wrapper, run, plain in (
            (scat_mag.scat_mag_fwd,
             lambda: scat_mag.scat_mag_fwd(h, bias, combine),
             lambda: scat_mag.scat_mag_fwd_plain(h, bias, combine)),
            (scat_mag.scat_mag_bwd,
             lambda: scat_mag.scat_mag_bwd(h, g, bias, combine),
             lambda: scat_mag.scat_mag_bwd_plain(h, g, bias, combine))):
        before = dict(wrapper.instantiations)
        got = run()
        assert {k: v - before[k] for k, v in
                wrapper.instantiations.items()} == {
            k: int(k == inst) for k in before}
        torch.testing.assert_close(got, plain(), equal_nan=True, **MAG_TOL)
    assert bool(torch.isnan(got).any()) == (bias == 0.0)


@pytest.mark.parametrize("layer,kw", [
    ("ScatLayerj2", dict()), ("ScatLayerj2", dict(combine_colour=True)),
    ("ScatLayerj2", dict(biort="near_sym_b_bp", qshift="qshift_b_bp")),
    ("ScatLayerj2", dict(biort="near_sym_b_bp", qshift="qshift_b_bp",
                         combine_colour=True)),
    ("ScatLayer", dict(biort="near_sym_b_bp"))])
def test_scat_layers_take_vector(dev, layer, kw):
    """Every K4/K5 call of the scattering layers, forward and backward,
    takes the vector instantiation."""
    m = getattr(tt, layer)(device=dev, **kw)
    x = torch.from_numpy(_rand((2, 3, 64, 64), 24)).to(dev)
    x.requires_grad_()
    ops.reset_launches()
    z = m(x)
    z.backward(torch.from_numpy(_rand(tuple(z.shape), 25)).to(dev))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    insts = ops.instantiation_counts()
    for k in ("scat_mag_fwd", "scat_mag_bwd"):
        assert counts[k] > 0
        assert insts[k] == {"vector": counts[k], "strided": 0}


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
    inst = afb_sfb.sfb_instantiation(axis, nin, L, mode, lo, hi)
    i0 = afb_sfb.sfb1d_conv.instantiations[inst]
    got = afb_sfb.sfb1d_conv(lo, hi, g0, g1, mode, axis)
    torch.testing.assert_close(got, want, **DWT_TOL)
    m = max(want.shape[axis] - 3, 0)
    torch.testing.assert_close(afb_sfb.sfb1d_conv(lo, hi, g0, g1, mode, axis,
                                                  m),
                               want.narrow(axis, 0, m), **DWT_TOL)
    assert afb_sfb.sfb1d_conv.launches == n0 + (2 if m else 1)
    # the bands' rows: 5 or 7 floats apart, stride 1 along W
    assert inst == ("long_fold" if mode == "periodization" and L - 2 > 2 * nin
                    else "row_run" if axis == 3 else "col_scalar")
    assert afb_sfb.sfb1d_conv.instantiations[inst] == i0 + (2 if m else 1)


# K7's tiles: a column thread walks 8 pairs (scalar) or 4 (float4), 4
# threads of a block along the pairs; a row tile takes 32 rows, flattened
# across the planes, and segments of 32 pairs (64 outputs) of each
@pytest.mark.parametrize("axis,n,other", [
    (2, 5, 10), (2, 33, 130), (2, 70, 4), (2, 133, 9),
    (3, 5, 3), (3, 129, 33), (3, 259, 2), (3, 40, 70)])
@pytest.mark.parametrize("view", ["aligned", "offset", "transposed", "band"])
@pytest.mark.parametrize("L,mode", [(2, "zero"), (8, "periodization"),
                                    (10, "symmetric"), (8, "reflect"),
                                    (76, "periodization"), (76, "periodic")])
def test_dwt_sfb_instantiations(dev, axis, n, other, view, L, mode):
    """Each of K7's instantiations at its tile edges, against the plain
    version: axes shorter than a chunk or a segment and past one (rows
    past one block of 32), widths that are not multiples of 4 (the
    float4 columns' tail), odd widths (70, 133, 259: the scalar columns),
    aligned, offset and transposed views and bands of an (N, C, 3, H, W)
    stack read in place (lo aligned beside an offset hi takes the scalar
    columns), full outputs and out_len crops, every kind of mode (the
    roll and circular window of 'periodization'), L = 2, 8, 10 and 76
    (db38: the per-output long_fold on short axes, the run-time window
    elsewhere).  Each case asserts the instantiation that ran."""
    from pytorch_wavelets_tpu_torch.ops import afb_sfb
    g0, g1 = _taps(L, 140 + L)
    if view == "band":
        shape = [2, 3, 0, 0]
        shape[axis], shape[5 - axis] = n, other
        stack = torch.from_numpy(_rand((2, 3, 3, *shape[2:]), 141)).to(dev)
        lo, hi = stack[:, :, 1], stack[:, :, 2]
    else:
        lo = _filt_view(dev, view, axis, n, other, 142)
        hi = _filt_view(dev, view, axis, n, other, 143)
    long_fold = mode == "periodization" and L - 2 > 2 * n
    want_inst = "long_fold" if long_fold else (
        ("row_gather" if view == "transposed" and other > 1 else "row_run")
        if axis == 3 else
        "col_float4" if afb_sfb.rows_aligned(lo) and afb_sfb.rows_aligned(hi)
        else "col_scalar")
    if view == "aligned" and axis == 2 and not long_fold:
        assert want_inst == "col_float4"
    assert afb_sfb.sfb_instantiation(axis, n, L, mode, lo, hi) == want_inst
    if 2 * n - L + 2 < 1 and mode != "periodization":
        # no output: the filter is longer than the signal
        with pytest.raises(ValueError, match="out_len"):
            afb_sfb.sfb1d_conv(lo, hi, g0, g1, mode, axis)
        return
    i0 = dict(afb_sfb.sfb1d_conv.instantiations)
    want = afb_sfb.sfb1d_conv_plain(lo, hi, g0, g1, mode, axis)
    torch.testing.assert_close(afb_sfb.sfb1d_conv(lo, hi, g0, g1, mode, axis),
                               want, **DWT_TOL)
    m = max(want.shape[axis] - 5, 1)
    torch.testing.assert_close(
        afb_sfb.sfb1d_conv(lo, hi, g0, g1, mode, axis, m),
        want.narrow(axis, 0, m), **DWT_TOL)
    i0[want_inst] += 2
    assert afb_sfb.sfb1d_conv.instantiations == i0
    if view == "aligned" and axis == 2:
        mixed = _filt_view(dev, "offset", axis, n, other, 144)
        assert afb_sfb.sfb_instantiation(axis, n, L, mode, lo, mixed) == (
            "long_fold" if long_fold else "col_scalar")
        torch.testing.assert_close(
            afb_sfb.sfb1d_conv(lo, mixed, g0, g1, mode, axis),
            afb_sfb.sfb1d_conv_plain(lo, mixed, g0, g1, mode, axis),
            **DWT_TOL)


# K6's tiles: a column thread walks 8 outputs (scalar) or 4 (float4), 4
# threads of a block along the outputs, the columns flattened across the
# planes; a row tile takes 32 rows, flattened across the planes, and
# segments of up to 128 outputs of each
@pytest.mark.parametrize("axis,n,other", [
    (2, 5, 10), (2, 33, 130), (2, 70, 4), (2, 259, 9),
    (3, 5, 3), (3, 259, 33), (3, 133, 2), (3, 300, 70)])
@pytest.mark.parametrize("view", ["aligned", "offset", "transposed", "band"])
@pytest.mark.parametrize("L,mode", [(2, "zero"), (8, "periodization"),
                                    (10, "symmetric"), (8, "reflect"),
                                    (3, "periodic"), (76, "periodization"),
                                    (76, "symmetric")])
def test_dwt_afb_instantiations(dev, axis, n, other, view, L, mode):
    """Each of K6's instantiations at its tile edges, against the plain
    version: axes shorter than a chunk or a segment and past one (rows
    past one block of 32), widths that are not multiples of 4 (the
    float4 columns' tail), odd widths (259, 133: the scalar columns
    flattened across the planes), aligned, offset and transposed views
    and the lowpass band of an (N, C, 4, H, W) output read in place, full
    outputs and out_len crops, every kind of mode (the evened odd axis of
    'periodization'), L = 2, 3 (odd: a zero tap), 8, 10 and 76 (db38: the
    per-output long_fold where 'periodization' folds, the run-time window
    elsewhere).  Each case asserts the instantiation that ran."""
    from pytorch_wavelets_tpu_torch.ops import afb_sfb
    h0, h1 = _taps(L, 150 + L)
    if view == "band":
        shape = [2, 3, 0, 0]
        shape[axis], shape[5 - axis] = n, other
        x = torch.from_numpy(_rand((2, 3, 4, *shape[2:]), 151)).to(
            dev)[:, :, 0]
    else:
        x = _filt_view(dev, view, axis, n, other, 152)
    folds = afb_sfb.afb_plan(n, L, mode)[5] > 0
    assert folds == (mode == "periodization" and L > n + n % 2)
    want_inst = "long_fold" if folds else (
        ("row_gather" if view == "transposed" and other > 1 else "row_run")
        if axis == 3 else
        "col_float4" if afb_sfb.rows_aligned(x) else "col_scalar")
    if view == "aligned" and axis == 2 and not folds:
        assert want_inst == "col_float4"
    assert afb_sfb.afb_instantiation(axis, n, L, mode, x) == want_inst
    i0 = dict(afb_sfb.afb1d_corr.instantiations)
    want = afb_sfb.afb1d_corr_plain(x, h0, h1, mode, axis)
    torch.testing.assert_close(afb_sfb.afb1d_corr(x, h0, h1, mode, axis),
                               want, **DWT_TOL)
    m = max(want.shape[axis + 1] - 5, 1)
    torch.testing.assert_close(afb_sfb.afb1d_corr(x, h0, h1, mode, axis, m),
                               want.narrow(axis + 1, 0, m), **DWT_TOL)
    i0[want_inst] += 2
    assert afb_sfb.afb1d_corr.instantiations == i0


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
    with tt.matmul_precision("high"):   # K6 computes in fp32 at every level
        tt.DWTForward(device=dev)(x)


# ---------------------------------------------------------------------------
# The per-level DTCWT path: K8-K10 (B7), K11 (avg_pool2), K2/K3 per level
# ---------------------------------------------------------------------------

# K8-K10: fp32 sums of up to 32 products in another order than cuDNN's
STENCIL_TOL = dict(rtol=1e-5, atol=1e-5)
QSHIFT_NAMES = ("qshift_a", "qshift_b", "qshift_c", "qshift_d", "qshift_32",
                "qshift_b_bp")


def _qtaps(name, highpass):
    from pytorch_wavelets_tpu_torch.filters import qshift
    from pytorch_wavelets_tpu_torch.ops.dtcwt_fb import prep_taps
    q = qshift(name)
    h0a, h0b, h1a, h1b = (prep_taps(q[i]) for i in (0, 1, 4, 5))
    return (h1b, h1a) if highpass else (h0b, h0a)


def _band_of_stack(dev, shape, axis, n, seed):
    """A (2, 3, ., .) view of band 1 of a wider (2, 3, 3, ., . + 5) stack,
    the filtered axis n long: read through its strides."""
    s = list(shape)
    s[axis] = n
    wide = torch.from_numpy(_rand((s[0], s[1], 3, s[2], s[3] + 5), seed))
    return wide.to(dev)[:, :, 1, :, 2:2 + s[3]]


@pytest.mark.parametrize("mode", ["symmetric", "zero"])
@pytest.mark.parametrize("L,n", [(5, 9), (7, 64), (13, 7), (19, 33),
                                 (4, 16), (30, 12)])
@pytest.mark.parametrize("axis", [2, 3])
def test_dtcwt_filt(dev, mode, L, n, axis):
    """K8 against its plain version: odd and even taps (n + 1 outputs),
    short axes (every output at a boundary), a strided input, and written
    into and accumulated onto a column slice of a wider tensor."""
    from pytorch_wavelets_tpu_torch.ops import dtcwt_fb
    t = np.random.RandomState(50 + L).randn(L) / np.sqrt(L)
    x = _band_of_stack(dev, (2, 3, 11, 10), axis, n, 51)
    want = dtcwt_fb.dtcwt_filt_plain(x, t, axis, mode)
    n0 = dtcwt_fb.dtcwt_filt.launches
    inst = dtcwt_fb.filt_instantiation(x, axis)
    i0 = dtcwt_fb.dtcwt_filt.instantiations[inst]
    torch.testing.assert_close(dtcwt_fb.dtcwt_filt(x, t, axis, mode), want,
                               **STENCIL_TOL)
    assert dtcwt_fb.dtcwt_filt.instantiations[inst] == i0 + 1
    Wo = want.shape[3]
    big = torch.from_numpy(_rand((2, 3, want.shape[2], Wo + 6), 52)).to(dev)
    ref = big.clone()
    ref[..., 3:3 + Wo] += want
    out = dtcwt_fb.dtcwt_filt(x, t, axis, mode, out=big[..., 3:3 + Wo],
                              accumulate=True)
    assert out.data_ptr() == big[..., 3:3 + Wo].data_ptr()
    torch.testing.assert_close(big, ref, **STENCIL_TOL)
    assert dtcwt_fb.dtcwt_filt.launches == n0 + 2


def _filt_view(dev, view, axis, n, other, seed):
    """A (2, 3, H, W) input of K8 with the filtered axis n long and the
    other ``other``: "aligned" (a band of a stack, rows 16-byte aligned
    with stride 1 along W), "offset" (the same one float in) or
    "transposed" (stride 1 along H)."""
    shape = [2, 3, 0, 0]
    shape[axis], shape[5 - axis] = n, other
    H, W = shape[2:]
    if view == "transposed":
        return torch.from_numpy(_rand((2, 3, W, H), seed)).to(
            dev).transpose(2, 3)
    wide = torch.from_numpy(_rand((2, 3, 2, H, -(-(W + 1) // 4) * 4),
                                  seed)).to(dev)
    o = 0 if view == "aligned" else 1
    return wide[:, :, 1, :, o:o + W]


# K8's tiles: a column thread walks 16 outputs, 4 of them a block along
# the rows (64 rows); a row block takes 128 outputs
@pytest.mark.parametrize("axis,n,other", [
    (2, 5, 10), (2, 16, 9), (2, 17, 130), (2, 65, 4),
    (3, 5, 3), (3, 128, 6), (3, 129, 5), (3, 300, 2)])
@pytest.mark.parametrize("view", ["aligned", "offset", "transposed"])
@pytest.mark.parametrize("L,mode", [(13, "symmetric"), (4, "zero"),
                                    (19, "zero")])
def test_dtcwt_filt_instantiations(dev, axis, n, other, view, L, mode):
    """Each of K8's instantiations at its tile edges, against the plain
    version: axes shorter than a tile and one past it, widths that are
    not multiples of 4 (the float4 columns' tail), even taps (n + 1
    outputs), aligned, offset and transposed views (the scalar
    instantiations), written into and added onto column slices of a
    wider tensor at an aligned and an odd offset (float4 or scalar
    stores).  Each case asserts the instantiation that ran."""
    from pytorch_wavelets_tpu_torch.ops import dtcwt_fb
    t = np.random.RandomState(56 + L).randn(L) / np.sqrt(L)
    x = _filt_view(dev, view, axis, n, other, 57)
    want_inst = {(2, True): "col_float4", (2, False): "col_scalar",
                 (3, True): "row_async16", (3, False): "row_async4"}[
        (axis, view == "aligned")]
    assert dtcwt_fb.filt_instantiation(x, axis) == want_inst
    want = dtcwt_fb.dtcwt_filt_plain(x, t, axis, mode)
    i0 = dtcwt_fb.dtcwt_filt.instantiations[want_inst]
    torch.testing.assert_close(dtcwt_fb.dtcwt_filt(x, t, axis, mode), want,
                               **STENCIL_TOL)
    Ho, Wo = want.shape[2:]
    for o in (4, 3):     # an aligned slice (float4 stores), an odd one
        big = torch.from_numpy(_rand((2, 3, Ho, -(-(Wo + 8) // 4) * 4),
                                     58)).to(dev)
        ref = big.clone()
        ref[..., o:o + Wo] = want
        dtcwt_fb.dtcwt_filt(x, t, axis, mode, out=big[..., o:o + Wo])
        torch.testing.assert_close(big, ref, **STENCIL_TOL)
        ref[..., o:o + Wo] += want
        dtcwt_fb.dtcwt_filt(x, t, axis, mode, out=big[..., o:o + Wo],
                            accumulate=True)
        torch.testing.assert_close(big, ref, **STENCIL_TOL)
    assert dtcwt_fb.dtcwt_filt.instantiations[want_inst] == i0 + 5


@pytest.mark.parametrize("name", QSHIFT_NAMES)
@pytest.mark.parametrize("n", [4, 8, 12, 40])
@pytest.mark.parametrize("axis", [2, 3])
@pytest.mark.parametrize("highpass", [False, True])
def test_dtcwt_dfilt(dev, name, n, axis, highpass):
    """K9 against its plain version at N = 4, 8, 12 (every output at a
    boundary) and 40, both interleaves, a strided input and a strided
    out."""
    from pytorch_wavelets_tpu_torch.ops import dtcwt_fb
    ha, hb = _qtaps(name, highpass)
    x = _band_of_stack(dev, (2, 3, 8, 12), axis, n, 53)
    want = dtcwt_fb.dtcwt_dfilt_plain(x, ha, hb, highpass, axis)
    n0 = dtcwt_fb.dtcwt_dfilt.launches
    torch.testing.assert_close(dtcwt_fb.dtcwt_dfilt(x, ha, hb, highpass,
                                                    axis), want,
                               **STENCIL_TOL)
    stack = torch.zeros((2, 3, 3, *want.shape[2:]), device=dev)
    dtcwt_fb.dtcwt_dfilt(x, ha, hb, highpass, axis, out=stack[:, :, 2])
    torch.testing.assert_close(stack[:, :, 2], want, **STENCIL_TOL)
    assert dtcwt_fb.dtcwt_dfilt.launches == n0 + 2


@pytest.mark.parametrize("name", QSHIFT_NAMES)
@pytest.mark.parametrize("n", [2, 6, 20])
@pytest.mark.parametrize("axis", [2, 3])
@pytest.mark.parametrize("highpass", [False, True])
def test_dtcwt_ifilt(dev, name, n, axis, highpass):
    """K10 against its plain version: both parities of m // 2 (qshift_c
    and qshift_32 even, the others odd), both phase tables, a strided
    input, accumulated onto a slice."""
    from pytorch_wavelets_tpu_torch.ops import dtcwt_fb
    ha, hb = _qtaps(name, highpass)
    x = _band_of_stack(dev, (2, 3, 6, 8), axis, n, 54)
    want = dtcwt_fb.dtcwt_ifilt_plain(x, ha, hb, highpass, axis)
    n0 = dtcwt_fb.dtcwt_ifilt.launches
    inst = dtcwt_fb.ifilt_instantiation(x, axis)
    assert inst == ("row_run" if axis == 3 else "col_scalar")
    i0 = dtcwt_fb.dtcwt_ifilt.instantiations[inst]
    torch.testing.assert_close(dtcwt_fb.dtcwt_ifilt(x, ha, hb, highpass,
                                                    axis), want,
                               **STENCIL_TOL)
    assert dtcwt_fb.dtcwt_ifilt.instantiations[inst] == i0 + 1
    Wo = want.shape[3]
    big = torch.from_numpy(_rand((2, 3, want.shape[2], Wo + 4), 55)).to(dev)
    ref = big.clone()
    ref[..., 1:1 + Wo] += want
    dtcwt_fb.dtcwt_ifilt(x, ha, hb, highpass, axis, out=big[..., 1:1 + Wo],
                         accumulate=True)
    torch.testing.assert_close(big, ref, **STENCIL_TOL)
    assert dtcwt_fb.dtcwt_ifilt.launches == n0 + 2


# K10's tiles: a column thread walks 4 values of q (16 output rows, 8
# input rows), 4 of them a block along the q tiles; a row block takes 32
# values of q (64 input samples) of 32 rows
@pytest.mark.parametrize("axis,n,other", [
    (2, 2, 10), (2, 8, 9), (2, 10, 130), (2, 66, 4),
    (3, 2, 3), (3, 64, 6), (3, 66, 33), (3, 130, 2)])
@pytest.mark.parametrize("view", ["aligned", "offset", "transposed"])
@pytest.mark.parametrize("name,highpass", [("qshift_b", False),
                                           ("qshift_c", True)])
def test_dtcwt_ifilt_instantiations(dev, axis, n, other, view, name,
                                    highpass):
    """Each of K10's instantiations at its tile edges, against the plain
    version: axes shorter than a tile and past one (rows past one block
    of 32), widths that are not multiples of 4 (the float4 columns'
    tail), both parities of m // 2, aligned, offset and transposed views
    (the scalar column instantiation), written into and added onto column
    slices of a wider tensor at an aligned and an odd offset (float4 or
    scalar stores, the row tile's read-add-store), the row tile walking
    runs and gathering a transposed view.  Each case asserts the
    instantiation that ran."""
    from pytorch_wavelets_tpu_torch.ops import dtcwt_fb
    ha, hb = _qtaps(name, highpass)
    x = _filt_view(dev, view, axis, n, other, 59)
    want_inst = ("col_float4" if view == "aligned" else "col_scalar") \
        if axis == 2 else ("row_gather" if view == "transposed"
                           and other > 1 else "row_run")
    assert dtcwt_fb.ifilt_instantiation(x, axis) == want_inst
    want = dtcwt_fb.dtcwt_ifilt_plain(x, ha, hb, highpass, axis)
    i0 = dtcwt_fb.dtcwt_ifilt.instantiations[want_inst]
    torch.testing.assert_close(dtcwt_fb.dtcwt_ifilt(x, ha, hb, highpass,
                                                    axis), want,
                               **STENCIL_TOL)
    Ho, Wo = want.shape[2:]
    for o in (4, 3):     # an aligned slice (float4 stores), an odd one
        big = torch.from_numpy(_rand((2, 3, Ho, -(-(Wo + 8) // 4) * 4),
                                     60)).to(dev)
        ref = big.clone()
        ref[..., o:o + Wo] = want
        dtcwt_fb.dtcwt_ifilt(x, ha, hb, highpass, axis,
                             out=big[..., o:o + Wo])
        torch.testing.assert_close(big, ref, **STENCIL_TOL)
        ref[..., o:o + Wo] += want
        dtcwt_fb.dtcwt_ifilt(x, ha, hb, highpass, axis,
                             out=big[..., o:o + Wo], accumulate=True)
        torch.testing.assert_close(big, ref, **STENCIL_TOL)
    assert dtcwt_fb.dtcwt_ifilt.instantiations[want_inst] == i0 + 5


# K9's tiles: a column thread walks 8 output pairs (scalar) or 4 (float4),
# 4 of them a block along the pairs, the columns flattened across the
# planes; a row tile takes 32 rows and segments of up to 64 pairs (256
# input samples) of each
@pytest.mark.parametrize("axis,n,other", [
    (2, 4, 10), (2, 12, 9), (2, 36, 130), (2, 260, 4),
    (3, 4, 3), (3, 256, 6), (3, 260, 33), (3, 132, 2)])
@pytest.mark.parametrize("view", ["aligned", "offset", "transposed"])
@pytest.mark.parametrize("name,highpass", [("qshift_b", False),
                                           ("qshift_a", True),
                                           ("qshift_c", True),
                                           ("odd", False)])
def test_dtcwt_dfilt_instantiations(dev, axis, n, other, view, name,
                                    highpass):
    """Each of K9's instantiations at its tile edges, against the plain
    version: axes of 4 (every window past both ends), 12, past a chunk
    and past one row segment (rows past one block of 32), widths that are
    not multiples of 4 (the float4 columns' tail), the compiled windows
    (qshift_a, qshift_b) and the run-time one (qshift_c's 16 taps, 9
    random taps: an odd m), both interleaves, aligned, offset and
    transposed views, written into column slices of a wider tensor at an
    aligned and an odd offset (float4 or scalar stores) and into a band
    of an (N, C, 3, H', W') stack, as the level functions write.  Each
    case asserts the instantiation that ran."""
    from pytorch_wavelets_tpu_torch.ops import dtcwt_fb
    if name == "odd":
        ha, hb = _taps(9, 62)
    else:
        ha, hb = _qtaps(name, highpass)
    x = _filt_view(dev, view, axis, n, other, 61)
    want_inst = ("col_float4" if view == "aligned" else "col_scalar") \
        if axis == 2 else ("row_gather" if view == "transposed"
                           and other > 1 else "row_run")
    assert dtcwt_fb.ifilt_instantiation(x, axis) == want_inst
    want = dtcwt_fb.dtcwt_dfilt_plain(x, ha, hb, highpass, axis)
    i0 = dtcwt_fb.dtcwt_dfilt.instantiations[want_inst]
    torch.testing.assert_close(dtcwt_fb.dtcwt_dfilt(x, ha, hb, highpass,
                                                    axis), want,
                               **STENCIL_TOL)
    Ho, Wo = want.shape[2:]
    for o in (4, 3):     # an aligned slice (float4 stores), an odd one
        big = torch.from_numpy(_rand((2, 3, Ho, -(-(Wo + 8) // 4) * 4),
                                     60)).to(dev)
        ref = big.clone()
        ref[..., o:o + Wo] = want
        dtcwt_fb.dtcwt_dfilt(x, ha, hb, highpass, axis,
                             out=big[..., o:o + Wo])
        torch.testing.assert_close(big, ref, **STENCIL_TOL)
    stack = torch.zeros((2, 3, 3, Ho, Wo), device=dev)
    dtcwt_fb.dtcwt_dfilt(x, ha, hb, highpass, axis, out=stack[:, :, 1])
    torch.testing.assert_close(stack[:, :, 1], want, **STENCIL_TOL)
    assert not stack[:, :, 0::2].any()
    assert dtcwt_fb.dtcwt_dfilt.instantiations[want_inst] == i0 + 4


PAST_2_31 = ("dwt_afb", "dwt_sfb", "dtcwt_filt", "dtcwt_dfilt",
             "dtcwt_ifilt", "swt_afb", "swt_afb_adjoint", "spec_merge",
             "spec_split", "nonsep_afb")


def _plane_case(kernel, axis, lines, dev):
    """(wrapper's module, its name, the small inputs, the dimension along
    which each is broadcast, the call, the output's broadcast dimension,
    the output length along ``axis``'s dimension, the outputs a plane
    must exceed, and for K13 the call that gives its terms' magnitudes)
    for :func:`test_stencil_plane_past_2_31`."""
    from pytorch_wavelets_tpu_torch.ops import (
        afb_sfb, dtcwt_fb, iswt_merge, nonsep,
    )
    other = 5 - axis
    h0, h1 = _taps(8, 64)
    ha, hb = _qtaps("qshift_b", False)
    t = np.random.RandomState(65).randn(13) / np.sqrt(13)
    z, w = lines
    sym = "symmetric"
    if kernel.startswith("spec"):
        A, B = (torch.fft.rfft(v, dim=axis) for v in lines)
        nf = A.shape[axis]
        g0, g1 = (torch.from_numpy(_rand((nf,), s) + 1j * _rand((nf,), s + 1))
                  .to(dev, torch.complex64) for s in (66, 68))
        mag = [v.abs() for v in (A, B, g0, g1)]
        if kernel == "spec_merge":
            return (iswt_merge, kernel, [A, B], [other, other],
                    lambda k, a, b: k(a, b, g0, g1, axis), other, axis,
                    2 ** 30, lambda: iswt_merge.spec_merge_plain(*mag, axis))
        return (iswt_merge, kernel, [A], [other],
                lambda k, a: k(a, g0, g1, axis), other + 1, axis + 1, 2 ** 30,
                lambda: iswt_merge.spec_split_plain(mag[0], *mag[2:], axis))
    if kernel == "swt_afb_adjoint":
        g = torch.stack(lines, dim=2)
        return (afb_sfb, "afb1d_atrous_adjoint", [g], [other + 1],
                lambda k, a: k(a, h0, h1, sym, axis, 2, z.shape[axis]),
                other, axis, 2 ** 31, None)
    if kernel == "nonsep_afb":
        # one 8x8 PSF (K = 1): 8.6 GB of output; the input is constant
        # along the other axis, so every output line is the same
        f = np.random.RandomState(67).randn(1, 8, 8) / 8
        return (nonsep, kernel, [z], [other], lambda k, a: k(a, f, sym),
                other + 1, axis + 1, 2 ** 31, None)
    mod = afb_sfb if kernel.startswith(("dwt", "swt")) else dtcwt_fb
    name, run, band = {
        "dwt_afb": ("afb1d_corr",
                    lambda k, a: k(a, h0, h1, sym, axis), 1),
        "dwt_sfb": ("sfb1d_conv",
                    lambda k, a, b: k(a, b, h0, h1, sym, axis), 0),
        "dtcwt_filt": ("dtcwt_filt", lambda k, a: k(a, t, axis, sym), 0),
        "dtcwt_dfilt": ("dtcwt_dfilt",
                        lambda k, a: k(a, ha, hb, False, axis), 0),
        "dtcwt_ifilt": ("dtcwt_ifilt",
                        lambda k, a: k(a, ha, hb, False, axis), 0),
        "swt_afb": ("afb1d_atrous_corr",
                    lambda k, a: k(a, h0, h1, sym, axis, 2), 1),
    }[kernel]
    ins = [z, w] if kernel == "dwt_sfb" else [z]
    return (mod, name, ins, [other] * len(ins), run, other + band,
            axis + band, 2 ** 31, None)


@pytest.mark.parametrize("kernel", PAST_2_31)
@pytest.mark.parametrize("axis", [2, 3])
def test_stencil_plane_past_2_31(dev, kernel, axis):
    """K6-K10, K12's two entries, K13's two and K14's forward on a plane
    of more than 2^31 outputs (2^30 complex values for K13; 8.6 GB of
    output, twice that for K6, K12's split and K13's split), where the
    pixel index takes 64 bits: the input is one line broadcast across the
    other axis (stride 0, read through its strides), and the output
    starts as NaN, so every line of it, to the last, must equal the plain
    version of that one line.  Each case frees what it held."""
    n = 16384
    line = [1, 1, 1, 1]
    line[axis] = n
    lines = [torch.from_numpy(_rand(line, 63 + s)).to(dev) for s in (0, 1)]
    mod, name, ins, dims, run, oax, lax, target, terms = _plane_case(
        kernel, axis, lines, dev)
    want = run(getattr(mod, name + "_plain"), *ins)
    reps = target // want.shape[lax] + 1
    grow = size = reps
    if kernel == "nonsep_afb":
        # K14 halves the broadcast axis (stride 2): twice the input lines,
        # and the symmetric pads of its 8 taps add 3 output lines
        from pytorch_wavelets_tpu_torch.ops import nonsep
        grow = 2 * reps
        size = nonsep.afb_axis_plan(grow, 8, "symmetric")[0]
    big = [v.expand(*[grow if d == dim else s for d, s in enumerate(v.shape)])
           for v, dim in zip(ins, dims)]
    # a NaN block in the allocator's cache, which the output then takes
    # (the first part of it, for K14's few lines more than reps)
    torch.cuda.empty_cache()
    nbytes = want.element_size() * want.numel() // want.shape[oax] * (
        reps + 8)
    torch.full((nbytes // 4,), float("nan"), device=dev)
    n0 = getattr(mod, name).launches
    got = run(getattr(mod, name), *big)
    assert getattr(mod, name).launches == n0 + 1
    assert got.shape[oax] == size
    last = got.narrow(oax, got.shape[oax] - 1, 1)
    if terms is not None:
        _close_to_terms(last, want.narrow(oax, 0, 1),
                        terms().narrow(oax, 0, 1))
    else:
        torch.testing.assert_close(last, want.narrow(oax, 0, 1),
                                   **STENCIL_TOL)
    assert bool((got == last).all())
    del got, last, big
    torch.cuda.empty_cache()


def test_avg_pool2(dev):
    """K11 and its adjoint against their plain versions, exactly, from a
    strided input and a strided cotangent."""
    from pytorch_wavelets_tpu_torch.ops import pool
    x = torch.from_numpy(_rand((2, 3, 10, 17), 56)).to(dev)[..., 1:15]
    g = torch.from_numpy(_rand((2, 3, 5, 14), 57)).to(dev)[..., ::2]
    n0 = (pool.avg_pool2_fwd.launches, pool.avg_pool2_bwd.launches)
    torch.testing.assert_close(pool.avg_pool2_fwd(x),
                               pool.avg_pool2_fwd_plain(x), rtol=0, atol=0)
    torch.testing.assert_close(pool.avg_pool2_bwd(g),
                               pool.avg_pool2_bwd_plain(g), rtol=0, atol=0)
    assert (pool.avg_pool2_fwd.launches,
            pool.avg_pool2_bwd.launches) == (n0[0] + 1, n0[1] + 1)


def _pool_views(dev):
    """(case, view, forward's instantiation or None where H or W is odd,
    adjoint's instantiation) of K11's edge views."""
    wide = torch.from_numpy(_rand((2, 3, 12, 22), 58)).to(dev)
    x17 = torch.from_numpy(_rand((2, 3, 10, 17), 56)).to(dev)[..., 1:15]
    return [
        ("aligned", wide[..., :16], "vector", "vector"),
        ("8 bytes off", wide[..., 2:18], "vector", "vector"),
        ("odd w", wide[..., 2:12], "vector", "vector"),
        ("h 1", wide[:, :, 3:5, :12], "vector", "vector"),
        ("w 1", wide[..., 4:6], "vector", "vector"),
        ("odd offset", wide[:, :, 2:10, 1:15], "strided", "vector"),
        ("17-wide edge", x17, "strided", "vector"),
        ("every other column", x17[..., ::2], None, "strided"),
        ("transposed", wide[..., :16].transpose(2, 3), "strided",
         "strided"),
        ("odd h", wide[:, :, :1, 2:7], None, "vector"),
    ]


def test_avg_pool2_instantiations(dev):
    """K11's forward and adjoint in each instantiation at the edge views,
    exactly their plain versions; each call moves its instantiation's
    count by one."""
    from pytorch_wavelets_tpu_torch.ops import pool
    seen = {"fwd": set(), "bwd": set()}
    for case, v, fwd_inst, bwd_inst in _pool_views(dev):
        for kind, inst in (("fwd", fwd_inst), ("bwd", bwd_inst)):
            if inst is None:
                continue
            kern = getattr(pool, f"avg_pool2_{kind}")
            plain = getattr(pool, f"avg_pool2_{kind}_plain")
            before = dict(kern.instantiations)
            got = kern(v)
            torch.cuda.synchronize()
            assert {k: n - before[k] for k, n in
                    kern.instantiations.items()} == {
                k: int(k == inst) for k in before}, (case, kind)
            torch.testing.assert_close(got, plain(v), rtol=0, atol=0)
            seen[kind].add(inst)
    assert seen == {"fwd": {"vector", "strided"},
                    "bwd": {"vector", "strided"}}
    # the per-level scattering path's pools: vector, bf16 through the
    # fp32 kernel
    x = torch.from_numpy(_rand((2, 3, 64, 64), 59)).to(dev)
    for dt in (torch.float32, torch.bfloat16):
        m = tt.ScatLayerj2(biort="near_sym_b_bp", qshift="qshift_b_bp",
                           device=dev)
        xg = x.to(dt).requires_grad_()
        ops.reset_launches()
        z = m(xg)
        torch.autograd.grad(z, xg, torch.ones_like(z))
        torch.cuda.synchronize()
        counts, insts = ops.launch_counts(), ops.instantiation_counts()
        for k in ("avg_pool2_fwd", "avg_pool2_bwd"):
            assert counts[k] > 0
            assert insts[k] == {"vector": counts[k], "strided": 0}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("o_dim,ri_dim", [(2, -1), (1, 3), (1, -1), (4, 2)])
def test_q2c_c2q_interleaved(dev, o_dim, ri_dim, dtype):
    """K2/K3 in their per-level mode (interleaved corners, 1/sqrt2)
    against the plain q2c / c2q computed in fp32 and rounded once to
    ``dtype``, exactly, from a strided stack of (lh, hl, hh) into and out
    of every layout."""
    from pytorch_wavelets_tpu_torch.transforms import dtcwt as plev
    od, rd, _, _ = plev.get_dimensions5(o_dim, ri_dim)
    N, C, m, k = 2, 3, 5, 7
    wide = torch.from_numpy(_rand((N, C, 3, 2 * m, 2 * k + 2), 58)).to(
        dev, dtype)
    y = wide[..., 1:1 + 2 * k]
    shape = [N, C, m, k]
    shape.insert(od, 6)
    shape.insert(rd, 2)
    got = torch.zeros(shape, device=dev, dtype=dtype)
    want = torch.zeros(shape, device=dev)
    orients = ((0, 5), (2, 3), (1, 4))
    quad.q2c_pack(y, fused_dtcwt.canonical_bands(got, od, rd), orients,
                  interleaved=True)
    quad.q2c_pack_plain(y.float(), fused_dtcwt.canonical_bands(want, od, rd),
                        orients, interleaved=True)
    torch.testing.assert_close(got, want.to(dtype), rtol=0, atol=0)
    hc = fused_dtcwt.canonical_bands(got, od, rd)
    torch.testing.assert_close(
        quad.c2q_unpack(hc, orients, True),
        quad.c2q_unpack_plain(hc.float(), orients, True).to(dtype),
        rtol=0, atol=0)


@pytest.mark.parametrize("kw", [dict(J=3), dict(J=2, o_dim=1, ri_dim=3,
                                                qshift="qshift_c")])
def test_per_level_dtcwt_matches_cpu(dev, kw):
    """DTCWTForward -> DTCWTInverse under set_operator_matmul(False):
    outputs and x.grad on the card against the CPU plain run, and no
    launch of K1."""
    dims = {k: v for k, v in kw.items() if k in ("o_dim", "ri_dim",
                                                 "qshift")}
    banded.set_operator_matmul(False)
    try:
        ops.reset_launches()

        def round_trip(d):
            f = tt.DTCWTForward(device=d, **kw)
            i = tt.DTCWTInverse(device=d, **dims)
            return lambda x: [*f(x), i(f(x))]
        cpu, gpu = _grads(round_trip, (2, 3, 46, 70), dev, 60)
    finally:
        banded.set_operator_matmul(None)
    for a, b in zip(cpu, gpu):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=2e-5)
    counts = ops.launch_counts()
    assert counts["apply_row"] == counts["apply_col"] == 0
    assert all(counts[k] > 0 for k in ("dtcwt_filt", "dtcwt_dfilt",
                                       "dtcwt_ifilt", "q2c_pack",
                                       "c2q_unpack"))


@pytest.mark.parametrize("name,kw", [
    ("ScatLayerj2", dict(qshift="qshift_b_bp")),
    ("ScatLayerj2", dict(qshift="qshift_b_bp", combine_colour=True)),
    ("ScatLayer", dict()), ("ScatLayer", dict(combine_colour=True))])
def test_bandpass_diag_scat_matches_cpu(dev, name, kw):
    cls = getattr(tt, name)
    cpu, gpu = _grads(lambda d: cls(biort="near_sym_b_bp", device=d, **kw),
                      (2, 3, 64, 64), dev, 61)
    for a, b in zip(cpu, gpu):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=2e-5)


def test_bandpass_diag_scat_launches(dev, monkeypatch):
    """One bandpass-diagonal ScatLayerj2 forward + backward on the card:
    the launches by kernel, no K1, and no plain version reached (each is
    made to raise for the run)."""
    from pytorch_wavelets_tpu_torch.ops import dtcwt_fb, pool

    def boom(*a, **k):
        raise AssertionError("a plain version ran on the card")
    for mod, names in ((dtcwt_fb, ("dtcwt_filt_plain", "dtcwt_dfilt_plain",
                                   "dtcwt_ifilt_plain")),
                       (quad, ("q2c_pack_plain", "c2q_unpack_plain")),
                       (pool, ("avg_pool2_fwd_plain", "avg_pool2_bwd_plain")),
                       (scat_mag, ("scat_mag_fwd_plain",
                                   "scat_mag_bwd_plain")),
                       (banded, ("apply_col_plain", "apply_row_plain"))):
        for n in names:
            monkeypatch.setattr(mod, n, boom)
    m = tt.ScatLayerj2(biort="near_sym_b_bp", qshift="qshift_b_bp",
                       device=dev)
    x = torch.from_numpy(_rand((2, 3, 64, 64), 62)).to(dev)
    x.requires_grad_()
    ops.reset_launches()
    z = m(x)
    fwd = ops.launch_counts()
    z.backward(torch.ones_like(z))
    torch.cuda.synchronize()
    total = ops.launch_counts()
    bwd = {k: total[k] - fwd[k] for k in total}
    # forward: two level-1 calls (3 row + 4 column K8, one K2 each), one
    # level-2 call (3 row + 4 column K9, one K2), three magnitudes, two
    # pools; backward: their adjoints (per level 4 column + 3 row K8 or
    # K10 with one K3), K5 and K11's adjoint
    assert fwd == dict(fwd, dtcwt_filt=14, dtcwt_dfilt=7, q2c_pack=3,
                       scat_mag_fwd=3, avg_pool2_fwd=2, apply_row=0,
                       apply_col=0, dtcwt_ifilt=0, c2q_unpack=0)
    assert bwd == dict(bwd, dtcwt_filt=14, dtcwt_ifilt=7, c2q_unpack=3,
                       scat_mag_bwd=3, avg_pool2_bwd=2, apply_row=0,
                       apply_col=0, dtcwt_dfilt=0, q2c_pack=0)


# ---------------------------------------------------------------------------
# The SWT: K12 (swt_atrous.cu), K13 (iswt_spec.cu), K1's row accumulate
# ---------------------------------------------------------------------------

SWT_MODES = ("zero", "symmetric", "reflect", "periodic", "periodization",
             "replicate")
# K13: a few fp32 products per value, relative to the magnitude of its
# terms (|g0 A| + |g1 B|, or |g Z|), which grow with the length and cancel
SPEC_TOL = dict(rtol=1e-6, atol=1e-6)


def _close_to_terms(got, want, scale):
    assert bool(((got - want).abs() <= SPEC_TOL["atol"] + SPEC_TOL["rtol"]
                 * scale).all()), float((got - want).abs().max())


@pytest.mark.parametrize("accumulate", [False, True])
def test_apply_row_out(dev, accumulate):
    """K1's row entry writing into, or adding onto, a column slice."""
    T = _banded_op(40, 24, 41, 6)
    x = torch.from_numpy(_rand((2, 3, 5, 24), 42)).to(dev)
    wide = torch.from_numpy(_rand((2, 3, 5, 50), 43)).to(dev)
    op = banded.Operator(T, dev)
    want = wide.clone()
    want[..., 4:44] = banded.apply_row_plain(
        x, op, wide[..., 4:44] if accumulate else None)
    got = wide.clone()
    n0 = banded.apply_row.launches
    out = banded.apply_row(x, op, got[..., 4:44], accumulate)
    assert out.data_ptr() == got[..., 4:44].data_ptr()
    torch.testing.assert_close(got, want, **KTOL)
    assert banded.apply_row.launches == n0 + 1


@pytest.mark.parametrize("mode", SWT_MODES)
@pytest.mark.parametrize("L,d,n", [(2, 1, 16), (8, 1, 33), (8, 4, 6),
                                   (10, 2, 13), (40, 4, 7), (3, 3, 7),
                                   (5, 3, 13)])
@pytest.mark.parametrize("axis", [2, 3])
def test_swt_afb(dev, mode, L, d, n, axis):
    """K12's split and its adjoint against their plain versions: every
    mode, odd sizes, pads longer than the axis (40 taps at dilation 4 on
    7 samples), odd L d (n - 1 outputs), a strided input (the LL band of
    a stack) and cotangent."""
    from pytorch_wavelets_tpu_torch.ops import afb_sfb
    h0, h1 = _taps(L, 70 + L)
    shape = [2, 3, 9, 7]
    shape[axis] = n
    wide = torch.from_numpy(_rand((shape[0], shape[1], 4, *shape[2:]), 71))
    x = wide.to(dev)[:, :, 0]
    n0 = (afb_sfb.afb1d_atrous_corr.launches,
          afb_sfb.afb1d_atrous_adjoint.launches)
    got = afb_sfb.afb1d_atrous_corr(x, h0, h1, mode, axis, d)
    torch.testing.assert_close(
        got, afb_sfb.afb1d_atrous_corr_plain(x, h0, h1, mode, axis, d),
        **DWT_TOL)
    gwide = torch.from_numpy(_rand((got.shape[0], 2 * got.shape[1], 2,
                                    *got.shape[3:]), 72)).to(dev)
    g = gwide[:, 1::2]
    torch.testing.assert_close(
        afb_sfb.afb1d_atrous_adjoint(g, h0, h1, mode, axis, d, n),
        afb_sfb.afb1d_atrous_adjoint_plain(g, h0, h1, mode, axis, d, n),
        **DWT_TOL)
    assert (afb_sfb.afb1d_atrous_corr.launches,
            afb_sfb.afb1d_atrous_adjoint.launches) == (n0[0] + 1, n0[1] + 1)


@pytest.mark.parametrize("n", [9, 10, 2056])
@pytest.mark.parametrize("axis", [2, 3])
def test_spec_merge_and_split(dev, n, axis):
    """K13 against its plain version on the strided spectra that
    ``torch.fft.rfft`` returns along either axis, odd and even n."""
    from pytorch_wavelets_tpu_torch.ops import iswt_merge
    shape = [2, 3, 5, 6]
    shape[axis] = n
    lo, hi = (torch.from_numpy(_rand(shape, s)).to(dev) for s in (80, 81))
    A, B = (torch.fft.rfft(t, dim=axis) for t in (lo, hi))
    nf = n // 2 + 1
    g0, g1 = (torch.from_numpy(_rand((nf,), s) + 1j * _rand((nf,), s + 1))
              .to(dev, torch.complex64) for s in (82, 84))
    n0 = (iswt_merge.spec_merge.launches, iswt_merge.spec_split.launches)
    mag = [t.abs() for t in (A, B, g0, g1)]
    _close_to_terms(iswt_merge.spec_merge(A, B, g0, g1, axis),
                    iswt_merge.spec_merge_plain(A, B, g0, g1, axis),
                    iswt_merge.spec_merge_plain(*mag, axis))
    _close_to_terms(iswt_merge.spec_split(A, g0, g1, axis),
                    iswt_merge.spec_split_plain(A, g0, g1, axis),
                    iswt_merge.spec_split_plain(mag[0], *mag[2:], axis))
    assert (iswt_merge.spec_merge.launches,
            iswt_merge.spec_split.launches) == (n0[0] + 1, n0[1] + 1)


def _spec_view(dev, n, axis, other, how, seed):
    """An rfft spectrum on the card along ``axis`` (frequency at stride
    1), or its values stored with W ("W") or H ("H") innermost, or 8 bytes
    further into a buffer ("offset")."""
    shape = [2, 3, other, other]
    shape[axis] = n
    A = torch.fft.rfft(torch.from_numpy(_rand(shape, seed)).to(dev),
                       dim=axis)
    if how == "W":
        return A.contiguous()
    if how == "H":
        return A.transpose(2, 3).contiguous().transpose(2, 3)
    if how == "offset":
        buf = torch.empty(A.numel() + 1, dtype=A.dtype, device=dev)
        v = torch.as_strided(buf, A.shape, A.stride(), 1)
        v.copy_(A)
        return v
    return A


SPEC_VIEWS = [
    # (case, n, axis, other, how, the inputs' and outputs' unit-stride axis)
    ("H odd rows", 4096, 2, 3, None, 2),
    ("W odd rows", 4096, 3, 3, None, 3),
    ("H even rows", 10, 2, 7, None, 2),
    ("H rows of 36", 70, 2, 37, None, 2),
    ("H offset", 16, 2, 5, "offset", 2),
    ("W offset", 9, 3, 4, "offset", 3),
    ("H spectra along W", 16, 2, 6, "W", 3),
    ("W spectra along H", 16, 3, 6, "H", 2),
]


@pytest.mark.parametrize("case,n,axis,other,how,u", SPEC_VIEWS,
                         ids=[v[0] for v in SPEC_VIEWS])
def test_spec_walks(dev, case, n, axis, other, how, u):
    """K13's merge and split in each walk at the edge views (odd rows of
    n/2 + 1 values, offsets, spectra stored along either axis), within
    SPEC_TOL of their terms' magnitudes; each call moves its walk's count
    by one and writes its outputs in its inputs' layout.  The strided
    walk takes mixed layouts."""
    from pytorch_wavelets_tpu_torch.ops import iswt_merge
    A = _spec_view(dev, n, axis, other, how, 92)
    B = _spec_view(dev, n, axis, other, how, 93)
    nf = A.shape[axis]
    g0, g1 = (torch.from_numpy(_rand((nf,), s) + 1j * _rand((nf,), s + 1))
              .to(dev, torch.complex64) for s in (94, 96))
    mag = [t.abs() for t in (A, B, g0, g1)]
    mixed = B.transpose(2, 3).contiguous().transpose(2, 3) \
        if B.stride(3) == 1 else B.contiguous()
    for wrapper, run, want, terms, inst in (
            (iswt_merge.spec_merge,
             lambda: iswt_merge.spec_merge(A, B, g0, g1, axis),
             iswt_merge.spec_merge_plain(A, B, g0, g1, axis),
             iswt_merge.spec_merge_plain(*mag, axis), "stream"),
            (iswt_merge.spec_split,
             lambda: iswt_merge.spec_split(A, g0, g1, axis),
             iswt_merge.spec_split_plain(A, g0, g1, axis),
             iswt_merge.spec_split_plain(mag[0], *mag[2:], axis), "stream"),
            (iswt_merge.spec_merge,
             lambda: iswt_merge.spec_merge(A, mixed, g0, g1, axis),
             iswt_merge.spec_merge_plain(A, mixed, g0, g1, axis),
             iswt_merge.spec_merge_plain(*mag, axis), "strided")):
        before = dict(wrapper.instantiations)
        got = run()
        torch.cuda.synchronize()
        assert {k: v - before[k] for k, v in
                wrapper.instantiations.items()} == {
            k: int(k == inst) for k in before}
        _close_to_terms(got, want, terms)
        if inst != "strided":
            assert got.stride(u + got.ndim - 4) == 1


@pytest.mark.parametrize("kernel", ["spec_merge", "spec_split"])
def test_spec_strided_past_2_30(dev, kernel):
    """K13's strided walk on a plane of more than 2^30 values, indexed in
    64 bits: spectra with no axis at stride 1 (one line broadcast along W
    at stride 2 along H); every line of the output, to the last, equals
    the plain version of that one line."""
    from pytorch_wavelets_tpu_torch.ops import iswt_merge
    A = torch.fft.rfft(torch.from_numpy(_rand((1, 1, 16384, 1), 98)).to(dev),
                       dim=2)
    nf = A.shape[2]
    reps = 2 ** 30 // nf + 1
    big = A.expand(1, 1, nf, 2).contiguous()[..., :1].expand(1, 1, nf, reps)
    g0, g1 = (torch.from_numpy(_rand((nf,), s) + 1j * _rand((nf,), s + 1))
              .to(dev, torch.complex64) for s in (99, 101))
    mag = [A.abs(), A.abs(), g0.abs(), g1.abs()]
    wrapper = getattr(iswt_merge, kernel)
    if kernel == "spec_merge":
        run, want, terms = (lambda k, a: k(a, a, g0, g1, 2),
                            iswt_merge.spec_merge_plain(A, A, g0, g1, 2),
                            iswt_merge.spec_merge_plain(*mag, 2))
    else:
        run, want, terms = (lambda k, a: k(a, g0, g1, 2),
                            iswt_merge.spec_split_plain(A, g0, g1, 2),
                            iswt_merge.spec_split_plain(mag[0], *mag[2:], 2))
    torch.cuda.empty_cache()
    before = dict(wrapper.instantiations)
    got = run(wrapper, big)
    assert wrapper.instantiations["strided"] == before["strided"] + 1
    last = got.narrow(-1, reps - 1, 1)
    _close_to_terms(last, want, terms)
    assert bool((got == last).all())
    del got, last, big
    torch.cuda.empty_cache()


def test_swt_fft_merge_takes_stream(dev):
    """Every K13 call of an SWT round trip and its gradient whose axes both
    take the FFT merge (past 2048 samples, 'periodization') streams, and
    the result matches the CPU plain run."""
    ops.reset_launches()

    def round_trip(d):
        f = tt.SWTForward(J=1, wave="db2", mode="periodization", device=d)
        i = tt.SWTInverse(wave="db2", mode="periodization", device=d)
        return lambda x: [*f(x), i(f(x))]
    cpu, gpu = _grads(round_trip, (1, 1, 2052, 2050), dev, 97)
    for a, b in zip(cpu, gpu):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=2e-5)
    counts, insts = ops.launch_counts(), ops.instantiation_counts()
    for k in ("spec_merge", "spec_split"):
        assert counts[k] > 0
        assert insts[k] == {"stream": counts[k], "strided": 0}


@pytest.mark.parametrize("mode,wave,shape,J", [
    ("periodization", "db4", (2, 3, 64, 64), 3),
    ("symmetric", "bior2.4", (2, 2, 33, 29), 2),
    ("reflect", "db2", (1, 2, 20, 24), 2),
    ("replicate", "db1", (1, 1, 7, 9), 2),
    ("zero", "db4", (1, 1, 7, 7), 2),
    ("periodic", "db3", (1, 2, 6, 2056), 2),       # the FFT merge (K13)
    ("symmetric", "db3", (1, 1, 2056, 6), 1)])     # banded least squares
def test_swt_matches_cpu(dev, mode, wave, shape, J):
    """SWTForward -> SWTInverse on the card against the CPU plain run:
    the stacks, the reconstruction and x.grad."""
    ops.reset_launches()

    def round_trip(d):
        f = tt.SWTForward(J=J, wave=wave, mode=mode, device=d)
        i = tt.SWTInverse(wave=wave, mode=mode, device=d)
        return lambda x: [*f(x), i(f(x))]
    cpu, gpu = _grads(round_trip, shape, dev, 90)
    for a, b in zip(cpu, gpu):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=2e-5)
    counts = ops.launch_counts()
    need = ["afb1d_atrous_corr", "afb1d_atrous_adjoint"]
    need += (["spec_merge", "spec_split"] if shape[3] > 2048 and
             mode == "periodic" else ["apply_col", "apply_row"])
    assert all(counts[k] > 0 for k in need), counts


def test_swt_launches(dev, monkeypatch):
    """One SWT round trip and its gradient on the card: the launches by
    kernel, and no plain version reached (each is made to raise)."""
    from pytorch_wavelets_tpu_torch.ops import afb_sfb, iswt_merge

    def guard(plain):
        """The plain version, raising on a CUDA tensor (the host's
        operator probes run it on the CPU)."""
        def fn(*a, **k):
            if any(isinstance(t, torch.Tensor) and t.is_cuda for t in a):
                raise AssertionError("a plain version ran on the card")
            return plain(*a, **k)
        return fn
    for mod, names in ((afb_sfb, ("afb1d_atrous_corr_plain",
                                  "afb1d_atrous_adjoint_plain")),
                       (iswt_merge, ("spec_merge_plain", "spec_split_plain")),
                       (banded, ("apply_col_plain", "apply_row_plain"))):
        for n in names:
            monkeypatch.setattr(mod, n, guard(getattr(mod, n)))
    f = tt.SWTForward(J=2, wave="db4", device=dev)
    i = tt.SWTInverse(wave="db4", device=dev)
    x = torch.from_numpy(_rand((2, 3, 32, 2056), 91)).to(dev)
    x.requires_grad_()
    ops.reset_launches()
    ys = f(x)
    rec = i(ys)
    fwd = ops.launch_counts()
    torch.autograd.grad([rec, *ys], x, [torch.ones_like(rec),
                                        *map(torch.ones_like, ys)])
    torch.cuda.synchronize()
    total = ops.launch_counts()
    bwd = {k: total[k] - fwd[k] for k in total}
    # per level: 2 splits; 2 column merges (pinv, H = 32: 2 K1 each) and
    # one row merge (FFT, W = 2056: one K13); backward: one K1 per column
    # merge, one K13 per row merge, 2 adjoint splits per level
    assert fwd == dict(fwd, afb1d_atrous_corr=4, apply_col=8, spec_merge=2,
                       apply_row=0, afb1d_atrous_adjoint=0, spec_split=0)
    assert bwd == dict(bwd, afb1d_atrous_adjoint=4, apply_col=4,
                       spec_split=2, afb1d_atrous_corr=0, spec_merge=0,
                       apply_row=0)


def test_swt_sum_backward(dev):
    """The gradient of rec.sum(): autograd hands the inverse an expanded
    (stride 0) cotangent, which K1 takes as a contiguous copy."""
    x = torch.from_numpy(_rand((1, 2, 16, 20), 92))
    grads = {}
    for d in ("cpu", dev):
        xt = x.to(d).requires_grad_()
        f = tt.SWTForward(J=2, wave="db2", mode="symmetric", device=d)
        i = tt.SWTInverse(wave="db2", mode="symmetric", device=d)
        grads[str(d)] = torch.autograd.grad(i(f(xt)).sum(), xt)[0].cpu()
    torch.testing.assert_close(grads[str(dev)], grads["cpu"], rtol=1e-5,
                               atol=2e-5)


def test_swt_refuses(dev):
    """The CUDA kernels take fp32 and bf16: float64 raises on the card
    (the CPU path takes it); bf16 stacks with upcast=False run (K17's bf16
    mode) and return bf16."""
    x = torch.zeros((1, 1, 16, 16), device=dev)
    with pytest.raises(TypeError, match="float32"):
        tt.SWTForward(device=dev)(x.double())
    ys = tt.SWTForward(J=1, coeff_dtype="bfloat16", device=dev)(x)
    assert tt.SWTInverse(upcast=False, device=dev)(ys).dtype == \
        torch.bfloat16
    assert tt.SWTInverse(device=dev)(ys).dtype == torch.float32


# ---------------------------------------------------------------------------
# The non-separable filterbanks (K14, K15), the à trous merge (K16) and the
# Selesnick DTCWT on them
# ---------------------------------------------------------------------------

# K14-K16: fp32 sums of up to 4 x 76^2 products in another order than
# cuDNN's
NONSEP_TOL = dict(rtol=1e-5, atol=1e-5)
NONSEP_MODES = ("zero", "symmetric", "reflect", "periodization")


def _psfs(K, Ly, Lx, seed):
    return np.random.RandomState(seed).randn(K, Ly, Lx) / np.sqrt(Ly * Lx)


@pytest.mark.parametrize("mode", NONSEP_MODES)
@pytest.mark.parametrize("K,Ly,Lx,H,W", [
    (4, 2, 2, 16, 12), (4, 8, 8, 33, 29), (4, 8, 2, 9, 40), (16, 10, 10, 26, 20),
    (4, 12, 10, 5, 3), (1, 3, 5, 7, 8)])
def test_nonsep_afb(dev, mode, K, Ly, Lx, H, W):
    """K14 and its adjoint against their plain versions: every mode, odd
    sizes (periodization's evening), Ly != Lx, K = 16, pads longer than
    the axis, a strided input (a band of a stack) and cotangent."""
    from pytorch_wavelets_tpu_torch.ops import nonsep
    f = _psfs(K, Ly, Lx, 100 + K)
    x = torch.from_numpy(_rand((2, 3, 4, H, W), 101)).to(dev)[:, :, 1]
    n0 = (nonsep.nonsep_afb.launches, nonsep.nonsep_afb_adjoint.launches)
    ops.reset_launches()
    got = nonsep.nonsep_afb(x, f, mode)
    torch.testing.assert_close(got, nonsep.nonsep_afb_plain(x, f, mode),
                               **NONSEP_TOL)
    g = torch.from_numpy(_rand((2, 6, *got.shape[2:]), 102)).to(dev)[:, ::2]
    torch.testing.assert_close(
        nonsep.nonsep_afb_adjoint(g, f, mode, H, W),
        nonsep.nonsep_afb_adjoint_plain(g, f, mode, H, W), **NONSEP_TOL)
    assert (nonsep.nonsep_afb.launches,
            nonsep.nonsep_afb_adjoint.launches) == (1, 1)
    _assert_k14_insts(K, Ly, Lx, H, W, got.shape[3:], mode, False)


def _assert_k14_insts(K, Ly, Lx, H, W, out_hw, mode, separable):
    """The counters of one forward (of out_hw outputs; None: none ran)
    and one adjoint call of K14 since the last reset name the
    instantiations its wrappers pick."""
    from pytorch_wavelets_tpu_torch.ops import nonsep
    kmax = 4 if K <= 4 else 16
    counts = ops.instantiation_counts()
    if out_hw is not None:
        bx, by = nonsep.afb_tile(K, Ly, Lx, *out_hw)
        assert {k: v for k, v in counts["nonsep_afb"].items() if v} == {
            f"k{kmax} {bx}x{4 * by}": 1}
    iy = nonsep.adjoint_interior(H, Ly, mode, separable)
    ix = nonsep.adjoint_interior(W, Lx, mode, separable)
    if iy is None or ix is None:
        want = {"gather": 1}
    else:
        fy = nonsep.afb_axis_plan(H, Ly, mode, separable)[1]
        fx = nonsep.afb_axis_plan(W, Lx, mode, separable)[1]
        bx, by = nonsep.adjoint_tile(K, Ly, Lx, H, W, fy, fx)
        want = {f"poly k{kmax} {2 * bx}x{8 * by}": 1}
        if (iy[1] - iy[0]) * (ix[1] - ix[0]) < H * W:
            want["band"] = 1
    assert {k: v for k, v in counts["nonsep_afb_adjoint"].items()
            if v} == want


# K14's tiles: 8, 16 or 32 positions wide, 4 to 64 high (forward), 16 to
# 64 pixels wide and 8 to 128 high (adjoint)
@pytest.mark.parametrize("K,Ly,Lx", [(1, 3, 5), (4, 8, 8), (16, 10, 10),
                                     (16, 4, 9)])
@pytest.mark.parametrize("H,W", [(3, 5), (33, 17), (66, 129), (130, 67)])
@pytest.mark.parametrize("mode,view", [
    ("periodization", "strided"), ("symmetric", "transposed"),
    ("zero", "strided"), ("reflect", "transposed")])
def test_nonsep_afb_instantiations(dev, K, Ly, Lx, H, W, mode, view):
    """K14's forward and adjoint at their tile edges (planes shorter than
    a tile, one past one, odd sizes), K = 1, 4, 16, strided and
    transposed inputs and cotangents, every mode (the adjoint's band in
    each, none in 'zero'), against the plain versions; then the
    separable split's plan of the same case (its single fold where
    'periodization' meets an axis shorter than the filter: the gather
    alone).  Each call asserts the instantiations that ran."""
    from pytorch_wavelets_tpu_torch.ops import nonsep
    f = _psfs(K, Ly, Lx, 130 + K)
    if view == "transposed":
        x = torch.from_numpy(_rand((2, 3, W, H), 131)).to(dev).transpose(2, 3)
    else:
        x = torch.from_numpy(_rand((2, 3, 3, H, W), 131)).to(dev)[:, :, 2]
    ops.reset_launches()
    got = nonsep.nonsep_afb(x, f, mode)
    torch.testing.assert_close(got, nonsep.nonsep_afb_plain(x, f, mode),
                               **NONSEP_TOL)
    g = torch.from_numpy(_rand((2, 3, *got.shape[2:]), 132)).to(dev)
    if view == "transposed":
        g = g.transpose(3, 4).contiguous().transpose(3, 4)
    else:
        g = torch.from_numpy(_rand((2, 6, *got.shape[2:]), 132)).to(dev)[
            :, 1::2]
    torch.testing.assert_close(
        nonsep.nonsep_afb_adjoint(g, f, mode, H, W),
        nonsep.nonsep_afb_adjoint_plain(g, f, mode, H, W), **NONSEP_TOL)
    _assert_k14_insts(K, Ly, Lx, H, W, got.shape[3:], mode, False)
    Ho, Wo = (nonsep.afb_axis_plan(n, L, mode, True)[0]
              for n, L in ((H, Ly), (W, Lx)))
    gs = torch.from_numpy(_rand((2, 3, K, Ho, Wo), 133)).to(dev)
    ops.reset_launches()
    torch.testing.assert_close(
        nonsep.nonsep_afb_adjoint(gs, f, mode, H, W, True),
        nonsep.nonsep_afb_adjoint_plain(gs, f, mode, H, W, True),
        **NONSEP_TOL)
    _assert_k14_insts(K, Ly, Lx, H, W, None, mode, True)


@pytest.mark.parametrize("mode", NONSEP_MODES + ("periodic",))
@pytest.mark.parametrize("Ly,Lx,Ny,Nx", [(2, 2, 8, 6), (8, 8, 17, 9),
                                         (8, 4, 5, 12), (12, 6, 7, 3),
                                         (76, 76, 40, 39)])
def test_nonsep_sfb(dev, mode, Ly, Lx, Ny, Nx):
    """K15 and its adjoint against their plain versions: every mode, the
    periodization wrap-add (a tail as long as the output: 12 taps on 7
    samples), db38's size (92 KB of taps in shared memory), bands read
    in place from a wider stack."""
    from pytorch_wavelets_tpu_torch.ops import nonsep
    if mode != "periodization" and min(2 * Ny - Ly, 2 * Nx - Lx) + 2 < 1:
        pytest.skip("no output: the filter is longer than the signal")
    f = _psfs(4, Ly, Lx, 103)
    c = torch.from_numpy(_rand((2, 3, 6, Ny, Nx), 104)).to(dev)[:, :, 1:5]
    ops.reset_launches()
    got = nonsep.nonsep_sfb(c, f, mode)
    torch.testing.assert_close(got, nonsep.nonsep_sfb_plain(c, f, mode),
                               **NONSEP_TOL)
    g = torch.from_numpy(_rand((2, 3, got.shape[2], got.shape[3] + 5),
                               105)).to(dev)[..., 2:2 + got.shape[3]]
    torch.testing.assert_close(
        nonsep.nonsep_sfb_adjoint(g, f, mode, Ny, Nx),
        nonsep.nonsep_sfb_adjoint_plain(g, f, mode, Ny, Nx), **NONSEP_TOL)
    assert (nonsep.nonsep_sfb.launches,
            nonsep.nonsep_sfb_adjoint.launches) == (1, 1)
    _assert_k15_insts(Ly, Lx, Ny, Nx, mode, True)


def _assert_k15_insts(Ly, Lx, Ny, Nx, mode, forward):
    """The counters of one adjoint call (and one forward call where
    ``forward``) of K15 since the last reset name the tiles its wrappers
    pick: the polyphase tile in positions and the band where
    'periodization' folds a tail, the staged tile in positions."""
    from pytorch_wavelets_tpu_torch.ops import nonsep
    counts = ops.instantiation_counts()
    if forward:
        nU, nV = (nonsep.sfb_quads(n, L, mode)[2] for n, L in ((Ny, Ly),
                                                               (Nx, Lx)))
        bx, by = nonsep.sfb_tile(Ly, Lx, nU, nV)
        want = {f"poly {2 * bx}x{8 * by}": 1}
        if any(nonsep.sfb_band_images(n, L, mode) is not None
               for n, L in ((Ny, Ly), (Nx, Lx))):
            want["band"] = 1
        assert {k: v for k, v in counts["nonsep_sfb"].items() if v} == want
    bx, by = nonsep.afb_tile(4, Ly, Lx, Ny, Nx)
    assert {k: v for k, v in counts["nonsep_sfb_adjoint"].items() if v} == {
        f"staged {bx}x{4 * by}": 1}


# K15's tiles: the forward's quads are K14's adjoint tile (16 to 64
# positions wide, 8 to 128 high), the adjoint's positions K14's forward
# tile (8 to 32 wide, 4 to 64 high)
@pytest.mark.parametrize("Ly,Lx", [(8, 8), (10, 4), (2, 8), (13, 6)])
@pytest.mark.parametrize("Ny,Nx", [(3, 5), (17, 33), (33, 129), (130, 67)])
@pytest.mark.parametrize("mode,view", [
    ("periodization", "strided"), ("symmetric", "transposed"),
    ("zero", "strided"), ("periodic", "transposed")])
def test_nonsep_sfb_instantiations(dev, Ly, Lx, Ny, Nx, mode, view):
    """Both of K15's entries at their tile edges (planes shorter than a
    tile and one past one, odd sizes), 'periodization' rolls and folds
    (the band), Ly != Lx, an odd L, strided and transposed bands and
    cotangents, against the plain versions; then the adjoint on the
    separable plan of the same case (its single fold where
    'periodization' meets an axis shorter than the filter) and with the
    one-axis PSFs of sfb1d's backward (Ly or Lx = 2).  Each call asserts
    the instantiations that ran."""
    from pytorch_wavelets_tpu_torch.ops import afb_sfb, nonsep
    f = _psfs(4, Ly, Lx, 150 + Ly)
    if view == "transposed":
        c = torch.from_numpy(_rand((2, 3, 4, Nx, Ny), 151)).to(
            dev).transpose(3, 4)
    else:
        c = torch.from_numpy(_rand((2, 3, 6, Ny, Nx), 151)).to(dev)[:, :,
                                                                    1:5]
    out = min(2 * Ny - Ly, 2 * Nx - Lx) + 2
    if out < (mode != "periodization"):
        # no output outside 'periodization' (an empty plane, or a negative
        # size, refused); a tail longer than the output there, which
        # sfb2d_nonsep refuses as the JAX package does
        if out == 0:
            assert nonsep.nonsep_sfb(c, f, mode).numel() == 0
        else:
            with pytest.raises((ValueError, RuntimeError)):
                nonsep.nonsep_sfb(c, f, mode)
        return
    ops.reset_launches()
    got = nonsep.nonsep_sfb(c, f, mode)
    torch.testing.assert_close(got, nonsep.nonsep_sfb_plain(c, f, mode),
                               **NONSEP_TOL)
    g = torch.from_numpy(_rand((2, 6, *got.shape[2:]), 152)).to(dev)[:, ::2]
    if view == "transposed":
        g = g.transpose(2, 3).contiguous().transpose(2, 3)
    torch.testing.assert_close(
        nonsep.nonsep_sfb_adjoint(g, f, mode, Ny, Nx),
        nonsep.nonsep_sfb_adjoint_plain(g, f, mode, Ny, Nx), **NONSEP_TOL)
    _assert_k15_insts(Ly, Lx, Ny, Nx, mode, True)
    for psfs in (f, afb_sfb._one_axis_psfs(f[:2, :, 0], 2, 4),
                 afb_sfb._one_axis_psfs(f[:2, 0], 3, 4)):
        Hs, Ws = (nonsep._sfb_axis_plan(n, L, mode, True)[0]
                  for n, L in zip((Ny, Nx), psfs.shape[1:]))
        gs = torch.from_numpy(_rand((2, 3, Hs, Ws), 153)).to(dev)
        ops.reset_launches()
        torch.testing.assert_close(
            nonsep.nonsep_sfb_adjoint(gs, psfs, mode, Ny, Nx, True),
            nonsep.nonsep_sfb_adjoint_plain(gs, psfs, mode, Ny, Nx, True),
            **NONSEP_TOL)
        _assert_k15_insts(*psfs.shape[1:], Ny, Nx, mode, False)


def test_nonsep_largest_psf(dev):
    """The largest pywt filter, db38 (76 taps): its 4 x 76 x 76 PSF stack
    (92,416 bytes) takes the shared-memory opt-in above 48 KB; 16 PSFs of
    it (370 KB) are refused before any launch."""
    from pytorch_wavelets_tpu_torch.filters import wavelet, wavelist
    from pytorch_wavelets_tpu_torch.ops import afb_sfb, nonsep
    longest = max(wavelist(), key=lambda n: len(wavelet(n).dec_lo))
    w = wavelet(longest)
    assert len(w.dec_lo) == 76
    x = torch.from_numpy(_rand((1, 2, 80, 80), 106)).to(dev)
    for mode in NONSEP_MODES:
        with torch.no_grad():
            got = afb_sfb.afb2d_nonsep(x, w.dec_lo, w.dec_hi, mode=mode)
            f = nonsep.outer_filters(w.dec_lo, w.dec_hi, w.dec_lo,
                                     w.dec_hi)[:, ::-1, ::-1]
            torch.testing.assert_close(
                got, nonsep.nonsep_afb_plain(x, f, mode), **NONSEP_TOL)
            rec = afb_sfb.sfb2d_nonsep(got, w.rec_lo, w.rec_hi, mode=mode)
            if mode == "periodization":
                torch.testing.assert_close(rec, x, rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="shared memory"):
        nonsep.nonsep_afb(x, np.ones((16, 76, 76)), "zero")


@pytest.mark.parametrize("mode", SWT_MODES)
@pytest.mark.parametrize("L,d,n", [(2, 1, 16), (8, 1, 33), (8, 4, 6),
                                   (10, 2, 13), (40, 4, 7)])
@pytest.mark.parametrize("axis", [2, 3])
def test_swt_sfb(dev, mode, L, d, n, axis):
    """K16's merge and its adjoint against their plain versions: every
    mode, odd sizes, pads longer than the axis, lo and hi read in place
    as two bands of a stack, a strided cotangent."""
    from pytorch_wavelets_tpu_torch.ops import afb_sfb
    g0, g1 = _taps(L, 110 + L)
    shape = [2, 3, 9, 7]
    shape[axis] = n
    stack = torch.from_numpy(_rand((shape[0], shape[1], 4, *shape[2:]),
                                   111)).to(dev)
    lo, hi = stack[:, :, 3], stack[:, :, 1]
    n0 = (afb_sfb.sfb1d_atrous_conv.launches,
          afb_sfb.sfb1d_atrous_adjoint.launches)
    # the bands' rows: 7 floats apart along H; stride 1, G = d, along W
    inst = "row_run" if axis == 3 else "col_scalar"
    i0 = _k16_insts()
    got = afb_sfb.sfb1d_atrous_conv(lo, hi, g0, g1, mode, axis, d)
    torch.testing.assert_close(
        got, afb_sfb.sfb1d_atrous_conv_plain(lo, hi, g0, g1, mode, axis, d),
        **NONSEP_TOL)
    g = torch.from_numpy(_rand((shape[0], 2 * shape[1], *shape[2:]),
                               112)).to(dev)[:, 1::2]
    torch.testing.assert_close(
        afb_sfb.sfb1d_atrous_adjoint(g, g0, g1, mode, axis, d),
        afb_sfb.sfb1d_atrous_adjoint_plain(g, g0, g1, mode, axis, d),
        **NONSEP_TOL)
    assert (afb_sfb.sfb1d_atrous_conv.launches,
            afb_sfb.sfb1d_atrous_adjoint.launches) == (n0[0] + 1, n0[1] + 1)
    band = afb_sfb.merge_band_images(n, L, d, mode) is not None
    assert _k16_insts() == _k16_bumped(i0, inst, inst, band)


def _k16_insts():
    from pytorch_wavelets_tpu_torch.ops import afb_sfb
    return (dict(afb_sfb.sfb1d_atrous_conv.instantiations),
            dict(afb_sfb.sfb1d_atrous_adjoint.instantiations))


def _k16_bumped(before, fwd, adj, band, times=1):
    """K16's instantiation counts after ``times`` forward calls in
    ``fwd`` and adjoint calls in ``adj`` (each adding its edge band where
    ``band``)."""
    f, a = (dict(c) for c in before)
    f[fwd] += times
    a[adj] += times
    a["band"] += times * band
    return f, a


# K16's tiles: a column thread walks 4 outputs of a residue class, 4 of
# them a block; a row block takes 32 rows and G x S outputs of each
# (merge_row_tile: 64 for d = 1, 2, 4; fewer on short axes, where G < d
# when d > n and the tile maps each sample: row_gather)
@pytest.mark.parametrize("axis,n,other", [
    (2, 5, 10), (2, 17, 9), (2, 33, 130), (2, 70, 4),
    (3, 5, 3), (3, 128, 6), (3, 129, 33), (3, 300, 2)])
@pytest.mark.parametrize("view", ["aligned", "offset", "transposed"])
@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("L,mode", [(8, "periodization"), (4, "zero"),
                                    (6, "symmetric")])
def test_swt_sfb_instantiations(dev, axis, n, other, view, d, L, mode):
    """Each of K16's instantiations, both entries, at its tile edges,
    against the plain versions: axes shorter than a tile and past one
    (rows past one block of 32), widths that are not multiples of 4 (the
    float4 columns' tail), d = 1, 2, 4, pads longer than a short axis,
    aligned, offset and transposed views (the scalar column
    instantiation and the row tile's gather; lo aligned beside an offset
    hi also takes the former), and the adjoint's edge band outside 'zero'
    mode.  Each case asserts the instantiations that ran."""
    from pytorch_wavelets_tpu_torch.ops import afb_sfb
    g0, g1 = _taps(L, 113 + L)
    lo = _filt_view(dev, view, axis, n, other, 114)
    hi = _filt_view(dev, view, axis, n, other, 115)
    contiguous = afb_sfb.merge_row_tile(n, L, d, 2, 1)[0] == d
    want_inst = ("col_float4" if view == "aligned" else "col_scalar") \
        if axis == 2 else ("row_run" if contiguous and view != "transposed"
                           else "row_gather")
    assert afb_sfb.merge_instantiation(axis, contiguous, lo, hi) == \
        want_inst
    i0 = _k16_insts()
    torch.testing.assert_close(
        afb_sfb.sfb1d_atrous_conv(lo, hi, g0, g1, mode, axis, d),
        afb_sfb.sfb1d_atrous_conv_plain(lo, hi, g0, g1, mode, axis, d),
        **NONSEP_TOL)
    torch.testing.assert_close(
        afb_sfb.sfb1d_atrous_adjoint(hi, g0, g1, mode, axis, d),
        afb_sfb.sfb1d_atrous_adjoint_plain(hi, g0, g1, mode, axis, d),
        **NONSEP_TOL)
    band = afb_sfb.merge_band_images(n, L, d, mode) is not None
    assert _k16_insts() == _k16_bumped(i0, want_inst, want_inst, band)
    if view == "aligned" and axis == 2:
        mixed = _filt_view(dev, "offset", axis, n, other, 116)
        assert afb_sfb.merge_instantiation(axis, True, lo, mixed) == \
            "col_scalar"
        torch.testing.assert_close(
            afb_sfb.sfb1d_atrous_conv(lo, mixed, g0, g1, mode, axis, d),
            afb_sfb.sfb1d_atrous_conv_plain(lo, mixed, g0, g1, mode, axis,
                                            d), **NONSEP_TOL)


def _k12_insts():
    from pytorch_wavelets_tpu_torch.ops import afb_sfb
    return (dict(afb_sfb.afb1d_atrous_corr.instantiations),
            dict(afb_sfb.afb1d_atrous_adjoint.instantiations))


# K12 runs K16's tiles: the split at (1, 2) inputs and outputs, the
# adjoint's direct images at (2, 1) plus the band of the split's plan
@pytest.mark.parametrize("axis,n,other", [
    (2, 5, 10), (2, 17, 9), (2, 33, 130), (2, 70, 4),
    (3, 5, 3), (3, 128, 6), (3, 129, 33), (3, 300, 2)])
@pytest.mark.parametrize("view", ["aligned", "offset", "transposed"])
@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("L,mode", [(8, "periodization"), (4, "zero"),
                                    (6, "symmetric"), (3, "reflect")])
def test_swt_afb_instantiations(dev, axis, n, other, view, d, L, mode):
    """Each of K12's instantiations, both entries, at its tile edges,
    against the plain versions: K16's grid of axes, views and d, and odd
    L d (3 taps: n - 1 outputs).  The split reads ``x`` as a view; the
    adjoint reads the two bands of a cotangent stack in place (the
    column adjoint's (N, 2C, 2, H, W) cotangent: rows 16-byte aligned
    where the view's are), transposed, or one float in; its edge band
    runs outside 'zero' mode.  Each case asserts the instantiations that
    ran."""
    from pytorch_wavelets_tpu_torch.ops import afb_sfb
    h0, h1 = _taps(L, 117 + L)
    x = _filt_view(dev, view, axis, n, other, 118)
    m = afb_sfb.atrous_plan(n, L, d, mode)[3]
    gshape = [2, 3, 0, 0]
    gshape[axis], gshape[5 - axis] = m, other
    H, W = gshape[2:]
    if view == "transposed":
        g = torch.from_numpy(_rand((2, 3, 2, W, H), 119)).to(
            dev).transpose(3, 4)
    else:
        o = 0 if view == "aligned" else 1
        g = torch.from_numpy(_rand((2, 3, 2, H, -(-(W + 1) // 4) * 4),
                                   119)).to(dev)[..., o:o + W]
    gin = (g[:, :, 0], g[:, :, 1])

    def want_inst(tile_n, *views):
        contiguous = afb_sfb.merge_row_tile(tile_n, L, d, *(
            (1, 2) if len(views) == 1 else (2, 1)))[0] == d
        if axis == 2:
            return "col_float4" if view == "aligned" and all(
                map(afb_sfb.rows_aligned, views)) else "col_scalar"
        return ("row_run" if contiguous and view != "transposed"
                else "row_gather")
    fwd, adj = want_inst(m, x), want_inst(n, *gin)
    if axis == 2 and view == "aligned":
        assert fwd == adj == "col_float4"
    assert afb_sfb.merge_instantiation(
        axis, afb_sfb.merge_row_tile(m, L, d, 1, 2)[0] == d, x) == fwd
    assert afb_sfb.merge_instantiation(
        axis, afb_sfb.merge_row_tile(n, L, d, 2, 1)[0] == d, *gin) == adj
    i0 = _k12_insts()
    torch.testing.assert_close(
        afb_sfb.afb1d_atrous_corr(x, h0, h1, mode, axis, d),
        afb_sfb.afb1d_atrous_corr_plain(x, h0, h1, mode, axis, d),
        **DWT_TOL)
    torch.testing.assert_close(
        afb_sfb.afb1d_atrous_adjoint(g, h0, h1, mode, axis, d, n),
        afb_sfb.afb1d_atrous_adjoint_plain(g, h0, h1, mode, axis, d, n),
        **DWT_TOL)
    band = afb_sfb.merge_band_images(n, L, d, mode, "split") is not None
    assert band == (mode != "zero")
    assert _k12_insts() == _k16_bumped(i0, fwd, adj, band)


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _flat(o)]
    return [out]


@pytest.mark.parametrize("kw,shape", [
    (dict(), (2, 3, 64, 64)),
    (dict(qshift="qshift_b", mode="periodization", J=2), (1, 2, 40, 48)),
    (dict(mode="zero", J=3), (2, 1, 37, 30))])
def test_dtcwt2_matches_cpu(dev, kw, shape):
    """DTCWTForward2 -> DTCWTInverse2 on the card against the CPU plain
    run: the lows, the bands, the reconstruction and x.grad (K6/K7 with
    the reference's backwards)."""
    ops.reset_launches()
    inv_kw = {k: v for k, v in kw.items() if k != "J"}

    def round_trip(d):
        from pytorch_wavelets_tpu_torch.transforms import (
            DTCWTForward2, DTCWTInverse2,
        )
        f = DTCWTForward2(device=d, **kw)
        i = DTCWTInverse2(device=d, **inv_kw)
        return lambda x: _flat([f(x), i(f(x))])
    cpu, gpu = _grads(round_trip, shape, dev, 120)
    for a, b in zip(cpu, gpu):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=2e-5)
    counts = ops.launch_counts()
    assert counts["afb1d_corr"] > 0 and counts["sfb1d_conv"] > 0


@pytest.mark.parametrize("mode", NONSEP_MODES)
def test_quad_afb2d_matches(dev, mode):
    """quad_afb2d (K6, backward K14's adjoint) and quad_afb2d_nonsep (K14,
    K = 16) agree on the card, and each with its CPU plain run, outputs
    and x.grad."""
    from pytorch_wavelets_tpu_torch.filters import qshift
    from pytorch_wavelets_tpu_torch.transforms import dtcwt_alt
    h0a, h0b, _, _, h1a, h1b, _, _ = qshift("qshift_a")
    res = {}
    for fn in (dtcwt_alt.quad_afb2d, dtcwt_alt.quad_afb2d_nonsep):
        ops.reset_launches()
        cpu, gpu = _grads(lambda d: lambda x: list(fn(x, h0a, h1a, h0b, h1b,
                                                      mode=mode)),
                          (2, 3, 34, 40), dev, 121)
        for a, b in zip(cpu, gpu):
            torch.testing.assert_close(b, a, rtol=1e-5, atol=2e-5)
        counts = ops.launch_counts()
        assert counts["nonsep_afb_adjoint"] == 1
        assert counts["nonsep_afb" if fn is dtcwt_alt.quad_afb2d_nonsep
                      else "afb1d_corr"] > 0
        res[fn.__name__] = gpu
    for a, b in zip(*res.values()):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("shape", [(1, 2, 9, 7), (2, 3, 5, 8)])
def test_quad_afb2d_single_fold(dev, shape):
    """quad_afb2d in 'periodization' on axes shorter than its 10 taps
    (the separable split's single fold: W of 9x7, both axes of 5x8):
    outputs and x.grad (K14's adjoint on the separable plan) match the
    CPU plain run."""
    from pytorch_wavelets_tpu_torch.filters import qshift
    from pytorch_wavelets_tpu_torch.transforms import dtcwt_alt
    h0a, h0b, _, _, h1a, h1b, _, _ = qshift("qshift_a")
    ops.reset_launches()
    cpu, gpu = _grads(lambda d: lambda x: list(dtcwt_alt.quad_afb2d(
        x, h0a, h1a, h0b, h1b, mode="periodization")), shape, dev, 124)
    for a, b in zip(cpu, gpu):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=2e-5)
    counts = ops.launch_counts()
    assert counts["nonsep_afb_adjoint"] == 1 and counts["afb1d_corr"] == 8


@pytest.mark.parametrize("mode", NONSEP_MODES)
def test_afb2d_gradient_matches_cpu(dev, mode):
    """The public afb2d (two K6 launches, backward one launch of K14's
    adjoint on the separable split's plan), db4 columns and db2 rows, on
    13x10 and on 5x3 (the single fold of both axes in 'periodization'):
    outputs and x.grad against the CPU plain run."""
    from pytorch_wavelets_tpu_torch.filters import wavelet
    from pytorch_wavelets_tpu_torch.ops import afb_sfb
    c, r = wavelet("db4"), wavelet("db2")
    bank = (c.dec_lo, c.dec_hi, r.dec_lo, r.dec_hi)
    for shape in ((2, 3, 13, 10), (1, 2, 5, 3)):
        ops.reset_launches()
        cpu, gpu = _grads(lambda d: lambda x: afb_sfb.afb2d(
            x, *bank, mode=mode), shape, dev, 125)
        for a, b in zip(cpu, gpu):
            torch.testing.assert_close(b, a, rtol=1e-5, atol=2e-5)
        counts = ops.launch_counts()
        assert counts["afb1d_corr"] == 2
        assert counts["nonsep_afb_adjoint"] == 1


@pytest.mark.parametrize("mode", NONSEP_MODES)
def test_sfb2d_and_atrous_gradients_match_cpu(dev, mode):
    """The public sfb2d (three K7 launches, backward one of K15's adjoint
    on the separable plan; on 2x3 bands in 'periodization' db4's tail is
    longer than the rows it wraps onto), afb1d_atrous and afb2d_atrous
    (K12, backward its adjoint): outputs and gradients against the CPU
    plain run."""
    from pytorch_wavelets_tpu_torch.filters import wavelet
    from pytorch_wavelets_tpu_torch.ops import afb_sfb
    c, r = wavelet("db4"), wavelet("db2")
    bank = (c.rec_lo, c.rec_hi, r.rec_lo, r.rec_hi)
    shapes = [(2, 3, 4, 9, 7)] + ([(1, 2, 4, 2, 3)]
                                  if mode == "periodization" else [])
    for shape in shapes:
        ops.reset_launches()
        cpu, gpu = _grads(lambda d: lambda v: afb_sfb.sfb2d(
            *v.unbind(2), *bank, mode=mode), shape, dev, 126)
        for a, b in zip(cpu, gpu):
            torch.testing.assert_close(b, a, rtol=1e-5, atol=2e-5)
        counts = ops.launch_counts()
        assert counts["sfb1d_conv"] == 3
        assert counts["nonsep_sfb_adjoint"] == 1
    ops.reset_launches()
    for fn in (lambda v: afb_sfb.afb1d_atrous(v, c.dec_lo, c.dec_hi, mode,
                                              2, 2),
               lambda v: afb_sfb.afb2d_atrous(v, c.dec_lo, c.dec_hi,
                                              r.dec_lo, r.dec_hi, mode, 2)):
        cpu, gpu = _grads(lambda d: fn, (2, 3, 11, 9), dev, 127)
        for a, b in zip(cpu, gpu):
            torch.testing.assert_close(b, a, rtol=1e-5, atol=2e-5)
    assert ops.launch_counts()["afb1d_atrous_adjoint"] == 3


@pytest.mark.parametrize("mode", ["zero", "symmetric", "reflect",
                                  "periodic", "periodization"])
def test_one_axis_filterbanks_raise_for_card_gradients(dev, mode):
    """afb1d / sfb1d differentiate on the card: the gradients of both,
    along both axes, match the CPU's within 1e-5 in every mode (K6 / K7
    forward, K14's / K15's adjoints backward), odd sizes and db4's pads
    longer than the axis included."""
    from pytorch_wavelets_tpu_torch.filters import wavelet
    from pytorch_wavelets_tpu_torch.ops import afb_sfb
    w = wavelet("db4")
    ops.reset_launches()
    # 3 samples: db4's pads longer than the axis ('periodization' only:
    # the other modes' merges of 3 samples are empty)
    small = (1, 2, 3, 5) if mode == "periodization" else (1, 2, 4, 7)
    for axis in (2, 3):
        for shape in ((2, 3, 9, 10), small):
            def split(d):
                return lambda x: afb_sfb.afb1d(x, w.dec_lo, w.dec_hi, mode,
                                               axis)

            def merge(d):
                return lambda x: afb_sfb.sfb1d(x, 2 * x, w.rec_lo, w.rec_hi,
                                               mode, axis)
            for fn in (split, merge):
                cpu, gpu = _grads(fn, shape, dev, 128)
                for a, b in zip(cpu, gpu):
                    torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5)
    counts = ops.launch_counts()
    assert counts["nonsep_afb_adjoint"] == 4
    assert counts["nonsep_sfb_adjoint"] == 4


@pytest.mark.parametrize("mode", ["periodization", "symmetric"])
def test_nonsep_and_atrous_round_trips(dev, mode):
    """afb2d_nonsep -> sfb2d_nonsep (K14 -> K15) reconstructs; x.grad of
    it and of afb2d_atrous -> sfb2d_atrous (K12 -> K16) match the CPU."""
    from pytorch_wavelets_tpu_torch.filters import wavelet
    from pytorch_wavelets_tpu_torch.ops import afb_sfb
    w = wavelet("db4")
    x = torch.from_numpy(_rand((2, 3, 32, 36), 122)).to(dev)
    rec = afb_sfb.sfb2d_nonsep(afb_sfb.afb2d_nonsep(
        x, w.dec_lo, w.dec_hi, mode=mode), w.rec_lo, w.rec_hi, mode=mode)
    torch.testing.assert_close(rec, x, rtol=0, atol=1e-5)
    ops.reset_launches()

    def nonsep(d):
        return lambda v: afb_sfb.sfb2d_nonsep(afb_sfb.afb2d_nonsep(
            v, w.dec_lo, w.dec_hi, mode=mode), w.rec_lo, w.rec_hi, mode=mode)

    def atrous(d):
        from pytorch_wavelets_tpu_torch.transforms.dwt import _AFB2DAtrous
        taps = tuple(np.asarray(t)[::-1] for t in (w.dec_lo, w.dec_hi) * 2)
        return lambda v: afb_sfb.sfb2d_atrous(
            _AFB2DAtrous.apply(v, taps, mode, 2), w.rec_lo, w.rec_hi,
            w.rec_lo, w.rec_hi, mode=mode, dilation=2)
    for module_of in (nonsep, atrous):
        cpu, gpu = _grads(module_of, (2, 3, 32, 36), dev, 123)
        for a, b in zip(cpu, gpu):
            torch.testing.assert_close(b, a, rtol=1e-5, atol=2e-5)
    counts = ops.launch_counts()
    assert all(counts[k] == 1 for k in ("nonsep_afb", "nonsep_afb_adjoint",
                                        "nonsep_sfb", "nonsep_sfb_adjoint"))
    assert counts["sfb1d_atrous_conv"] == 3
    assert counts["sfb1d_atrous_adjoint"] == 3


@pytest.mark.parametrize("module", ["DWTForward", "DTCWTForward",
                                    "DTCWTForward2"])
@pytest.mark.parametrize("layout", ["transposed", "channels_last"])
def test_modules_take_non_contiguous_inputs(dev, module, layout):
    """A transposed view and a channels_last tensor give the result of
    the contiguous input (the transforms read strides or copy at their
    entry)."""
    from pytorch_wavelets_tpu_torch.transforms import DTCWTForward2
    cls = DTCWTForward2 if module == "DTCWTForward2" else getattr(tt, module)
    m = cls(J=2, device=dev)
    x = torch.from_numpy(_rand((2, 3, 40, 48), 124)).to(dev)
    if layout == "transposed":
        src = x.transpose(2, 3).contiguous().transpose(2, 3)
    else:
        src = x.contiguous(memory_format=torch.channels_last)
    assert not src.is_contiguous() and torch.equal(src, x)
    for a, b in zip(_flat(m(src)), _flat(m(x))):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# K17: the operator product on the tensor cores (TF32, 3xTF32, bf16), and
# the precision levels and bf16 through the modules
# ---------------------------------------------------------------------------

# K17 against its modes' plain versions: the same rounded operands, fp32
# sums in another order (rtol 1e-5 + atol 1e-5); a bf16 output is that sum
# rounded once, and a sum within 1e-5 of a rounding midpoint may round to
# the neighbouring bf16 value (one step: at most 2^-7 relative)
K17_TOL = {"tf32": KTOL, "3xtf32": KTOL,
           "bf16": dict(rtol=2.0 ** -7, atol=1e-5)}
K17_DTYPE = {"tf32": torch.float32, "3xtf32": torch.float32,
             "bf16": torch.bfloat16}


def _k17(entry, mode):
    return (getattr(banded, f"apply_{entry}_{mode}"),
            getattr(banded, f"apply_{entry}_{mode}_plain"))


@pytest.mark.parametrize("view", ["aligned", "offset", "even"])
@pytest.mark.parametrize("mode", ["tf32", "3xtf32", "bf16"])
@pytest.mark.parametrize("M,K,W,band,planes", [
    (70, 45, 33, None, 6), (256, 128, 100, 9, 6), (1920, 512, 40, 20, 6),
    (64, 2048, 65, None, 6),               # K longer than the ring
    (256, 64, 100, "short", 6),            # segments shorter than a stage
    (256, 128, 70, "gap", 6),              # a T-row tile with no segment
    (16, 16, 8, None, 65600),              # more than 65,535 planes
    (64, 64, 96, 9, 600)])                 # 600 planes
def test_k17_col(dev, mode, M, K, W, band, planes, view):
    """Column entry: a column slice as input (16-byte aligned, at an odd
    element offset, at an even one), a new output, accumulation into a
    copy, and a write through a column slice of a wider tensor; banded
    operators skip tiles through the segment table.  Each case asserts
    the instantiation (copy width) that ran."""
    kern, plain = _k17("col", mode)
    dt = K17_DTYPE[mode]
    lead = (2, planes // 2)
    op = banded.Operator(_test_op(M, K, 1, band), dev)
    x = _view(dev, dt, (*lead, K), W, view, 2)
    out = torch.from_numpy(_rand((*lead, M, W), 3)).to(dev, dt)
    n0 = kern.launches
    copy = _expected_copy(view, W, K, dt)
    c0 = kern.copies[copy]
    torch.testing.assert_close(kern(x, op), plain(x, op), **K17_TOL[mode])
    torch.testing.assert_close(kern(x, op, out.clone()), plain(x, op, out),
                               **K17_TOL[mode])
    big = torch.zeros((*lead, M, W + 30), device=dev, dtype=dt)
    got = kern(x, op, big[..., 10:10 + W], accumulate=False)
    torch.testing.assert_close(got, plain(x, op), **K17_TOL[mode])
    assert big[..., :10].abs().max() == 0 and big[..., 10 + W:].abs().max() \
        == 0
    assert kern.launches == n0 + 3
    assert kern.copies[copy] == c0 + 3
    if band == "gap":
        assert got[:, :, 64:128].abs().max() == 0
        torch.testing.assert_close(kern(x, op, out.clone())[:, :, 64:128],
                                   out[:, :, 64:128], rtol=0, atol=0)


@pytest.mark.parametrize("view", ["aligned", "offset", "even"])
@pytest.mark.parametrize("mode", ["tf32", "3xtf32", "bf16"])
@pytest.mark.parametrize("K,M,H,band", [
    (45, 70, 33, None), (128, 256, 100, 9), (512, 1920, 9, 20),
    (2048, 96, 50, None),                  # K longer than the ring
    (64, 256, 35, "short"),                # segments shorter than a stage
    (128, 200, 40, "gap"),                 # a T-row tile with no segment
    (16, 24, 11700, None)])                # more than 65,535 rows
def test_k17_row(dev, mode, K, M, H, band, view):
    """Row entry: the rows of a column slice of a wider tensor (16-byte
    aligned, at an odd element offset, at an even one), a new output and
    accumulation.  Each case asserts the instantiation (copy width) that
    ran."""
    kern, plain = _k17("row", mode)
    dt = K17_DTYPE[mode]
    op = banded.Operator(_test_op(M, K, 4, band), dev)
    x = _view(dev, dt, (2, 3, H), K, view, 5)
    out = torch.from_numpy(_rand((2, 3, H, M), 6)).to(dev, dt)
    n0 = kern.launches
    copy = _expected_copy(view, K, K, dt)
    c0 = kern.copies[copy]
    torch.testing.assert_close(kern(x, op), plain(x, op), **K17_TOL[mode])
    got = kern(x, op, out.clone())
    torch.testing.assert_close(got, plain(x, op, out), **K17_TOL[mode])
    assert kern.launches == n0 + 2
    assert kern.copies[copy] == c0 + 2
    if band == "gap":
        assert kern(x, op)[..., 64:128].abs().max() == 0
        torch.testing.assert_close(got[..., 64:128], out[..., 64:128],
                                   rtol=0, atol=0)


def test_k17_modes_round_as_stated(dev):
    """TF32 keeps 10 mantissa bits, 3xTF32 22 (the split drops the
    small.small product and below), bf16 8: each mode's distance to the
    IEEE fp32 product is of its order."""
    op = banded.Operator(_banded_op(256, 256, 7), dev)
    x = torch.from_numpy(_rand((1, 4, 256, 256), 8)).to(dev)
    exact = banded.apply_col_plain(x, op)
    scale = exact.abs().max().item()
    errs = {}
    for mode in ("tf32", "3xtf32", "bf16"):
        kern, plain = _k17("col", mode)
        y = kern(x.to(K17_DTYPE[mode]), op).float()
        errs[mode] = (y - exact).abs().max().item() / scale
    assert errs["3xtf32"] < 1e-5 < errs["tf32"] < 5e-3
    assert errs["bf16"] < 2e-2


def test_k17_dispatch(dev):
    """apply_col / apply_row launch K1 in fp32 at 'highest', K17's
    3xTF32 mode at 'high', TF32 at 'default', bf16 on bf16 at every
    level; float64 still raises."""
    op = banded.Operator(_banded_op(64, 64, 9), dev)
    x = torch.from_numpy(_rand((1, 1, 64, 64), 10)).to(dev)
    for level, dtype, name in (("highest", torch.float32, "apply_col"),
                               ("high", torch.float32, "apply_col_3xtf32"),
                               ("default", torch.float32, "apply_col_tf32"),
                               ("highest", torch.bfloat16, "apply_col_bf16"),
                               ("default", torch.bfloat16, "apply_col_bf16")):
        ops.reset_launches()
        with tt.matmul_precision(level):
            y = banded.apply_col(x.to(dtype), op)
        assert y.dtype == dtype
        assert {k: v for k, v in ops.launch_counts().items() if v} == \
            {name: 1}, (level, dtype)
    with pytest.raises(TypeError):
        banded.apply_col(x.double(), op)
    with pytest.raises(TypeError):   # mixed dtypes
        banded.apply_col(x.bfloat16(), op, torch.zeros_like(x))


MODULE_NAMES = ("DWTForward", "DWTInverse", "DWT1DForward", "DWT1DInverse",
                "SWTForward", "SWTInverse", "DTCWTForward", "DTCWTInverse",
                "ScatLayer", "ScatLayerj2", "DTCWTForward2", "DTCWTInverse2")


def _module_pair(name, d):
    """A module of the twelve and a function of x running it (inverses
    after their forward), at small sizes."""
    from pytorch_wavelets_tpu_torch.transforms import dtcwt_alt
    lib = dtcwt_alt if name.endswith("2") and name.startswith("DTCWT") \
        else tt
    fwd_name = name.replace("Inverse", "Forward")
    kw = dict(upcast=False) if name == "SWTInverse" else {}
    fwd = getattr(lib, fwd_name)(device=d)
    if name == fwd_name:
        return lambda x: fwd(x[:, :, 0] if "1D" in name else x)
    inv = getattr(lib, name)(device=d, **kw)
    return lambda x: inv(fwd(x[:, :, 0] if "1D" in name else x))


def _flat_outs(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _flat_outs(o) if t is not None]


@pytest.mark.parametrize("name", MODULE_NAMES)
def test_modules_under_levels_and_bf16(dev, name):
    """Each public module runs on the card under every precision level
    and on bf16 (bf16 in, bf16 out): fp32 within 2e-5 of the CPU at
    'high', 1e-2 at 'default', and bf16 within 2e-2 of max |x| of the CPU
    fp32 run."""
    x = torch.from_numpy(_rand((2, 3, 32, 32), 140))
    with torch.no_grad():
        ref = _flat_outs(_module_pair(name, "cpu")(x))
        run = _module_pair(name, dev)
        for level, tol in (("highest", 2e-5), ("high", 2e-5),
                           ("default", 1e-2)):
            with tt.matmul_precision(level):
                got = _flat_outs(run(x.to(dev)))
            for a, b in zip(ref, got):
                assert b.dtype == a.dtype
                assert (b.cpu() - a).abs().max().item() <= tol, level
        for level in ("highest", "default"):
            with tt.matmul_precision(level):
                got = _flat_outs(run(x.to(dev, torch.bfloat16)))
            scale = x.abs().max().item()
            for a, b in zip(ref, got):
                assert b.dtype == torch.bfloat16
                err = (b.float().cpu() - a).abs().max().item()
                assert err <= 2e-2 * max(scale, a.abs().max().item()), level


@pytest.mark.parametrize("level", ["high", "default", "bf16"])
def test_gradients_under_levels(dev, level):
    """The DTCWT and ScatLayerj2 backward run K17 in the forward's mode
    (the transposes at the same level), x.grad near the CPU's."""
    ops.reset_launches()
    dtype = torch.bfloat16 if level == "bf16" else torch.float32
    x = torch.from_numpy(_rand((2, 3, 64, 64), 141))
    grads = {}
    for d in ("cpu", dev):
        xt = x.to(d, dtype if d != "cpu" else torch.float32)
        xt.requires_grad_()
        f = tt.DTCWTForward(J=2, device=d)
        i = tt.DTCWTInverse(device=d)
        s = tt.ScatLayerj2(device=d)
        with tt.matmul_precision("highest" if level == "bf16" else level):
            loss = i(f(xt)).float().sum() + s(xt).float().square().sum()
            grads[str(d)] = torch.autograd.grad(loss, xt)[0].float().cpu()
    tol = {"high": 2e-5, "default": 1e-2, "bf16": 2e-2}[level]
    ref = grads["cpu"]
    assert (grads[str(dev)] - ref).abs().max().item() <= \
        tol * max(1.0, ref.abs().max().item())
    counts = ops.launch_counts()
    mode = {"high": "3xtf32", "default": "tf32", "bf16": "bf16"}[level]
    assert counts[f"apply_row_{mode}"] > 0 and counts[f"apply_col_{mode}"] > 0
    assert counts["apply_row"] == counts["apply_col"] == 0


@pytest.mark.parametrize("fwd_level,bwd_level", [
    ("default", "highest"), ("highest", "default"), ("high", "default")])
def test_backward_runs_at_the_forward_level(dev, fwd_level, bwd_level):
    """A backward called outside its forward's level launches the
    forward's mode (K1 at 'highest', K17's 3xTF32 / TF32) and no other:
    the composed DTCWT pyramids and the SWT merges keep the level."""
    x = torch.from_numpy(_rand((2, 3, 32, 32), 143)).to(dev)
    x.requires_grad_()
    f, i = tt.DTCWTForward(J=2, device=dev), tt.DTCWTInverse(device=dev)
    sf, si = tt.SWTForward(J=1, device=dev), tt.SWTInverse(device=dev)
    with tt.matmul_precision(fwd_level):
        loss = i(f(x)).sum() + si(sf(x)).sum()
    ops.reset_launches()
    with tt.matmul_precision(bwd_level):
        loss.backward()
    counts = ops.launch_counts()
    mode = {"highest": "", "high": "_3xtf32", "default": "_tf32"}[fwd_level]
    products = {k.__name__ for k in banded.K17_WRAPPERS} | {"apply_row",
                                                            "apply_col"}
    mine = {f"apply_row{mode}", f"apply_col{mode}"}
    assert all(counts[k] > 0 for k in mine), counts
    assert all(counts[k] == 0 for k in products - mine), counts


def test_per_level_path_on_bf16(dev):
    """The per-level stencils (K8-K11 through their wrappers' casts, K2/K3
    in bf16) under set_operator_matmul(False) and the bandpass-diagonal
    ScatLayerj2: bf16 in, bf16 out, near the CPU's fp32 (1e-1 of
    max(1, max |CPU|), reconstructions 2e-2 of max |x|), K1 / K17 never
    launched."""
    x = torch.from_numpy(_rand((2, 3, 40, 48), 142))
    xb = x.to(dev, torch.bfloat16)
    ops.reset_launches()
    banded.set_operator_matmul(False)
    try:
        with torch.no_grad():
            f = tt.DTCWTForward(J=3, device=dev)
            i = tt.DTCWTInverse(device=dev)
            yl, yh = f(xb)
            rec = i((yl, yh))
            fc = tt.DTCWTForward(J=3, device="cpu")
            ryl, ryh = fc(x)
            rrec = tt.DTCWTInverse(device="cpu")((ryl, ryh))
    finally:
        banded.set_operator_matmul(None)
    bp = dict(biort="near_sym_b_bp", qshift="qshift_b_bp")
    z = tt.ScatLayerj2(device=dev, **bp)(xb)
    rz = tt.ScatLayerj2(device="cpu", **bp)(x)
    for got, ref in zip([yl, *yh, z], [ryl, *ryh, rz]):
        assert got.dtype == torch.bfloat16
        err = (got.float().cpu() - ref).abs().max().item()
        assert err <= 1e-1 * max(1.0, ref.abs().max().item())
    assert rec.dtype == torch.bfloat16
    assert (rec.float().cpu() - rrec).abs().max().item() <= \
        2e-2 * x.abs().max().item()
    counts = ops.launch_counts()
    assert counts["dtcwt_filt"] > 0 and counts["q2c_pack"] > 0
    assert all(counts[k.__name__] == 0 for k in banded.K17_WRAPPERS)
    assert counts["apply_row"] == counts["apply_col"] == 0


# K18: the magnitude's second derivative (a few IEEE ops a value against
# its plain version's order, the sums over (re, im) and C included)
BWD2_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("combine", [False, True])
@pytest.mark.parametrize("bias", [1e-2, 0.0])
@pytest.mark.parametrize("layout", ["vector", "strided", "odd offset"])
def test_scat_mag_bwd2(dev, combine, bias, layout):
    """K18 against scat_mag_bwd2_plain: on the pyramids' layout (vector),
    on strided bands and cotangents, and on planes that start 8 bytes
    past a 16-byte line (the vector walk's heads and tails)."""
    c = 3
    if layout == "strided":
        wide = torch.from_numpy(_rand((2, 6, c, 9, 11, 3), 31)).to(dev)
        h = wide[..., 1:10, :2]
        u = torch.from_numpy(_rand((2, 6, c, 9, 9, 3), 32)).to(dev)[..., 1:]
    else:
        # 8 bytes off a line: every plane a head and a tail (an even
        # plane, so that combine's channels stay 16 bytes apart)
        off = 2 if layout == "odd offset" else 0
        hh, ww = (7, 10) if off else (8, 16)
        h = _dev_view(dev, (2, 6, c, hh, ww, 2), offset=off, seed=33)
        u = _dev_view(dev, (2, 6, c, hh, ww, 2), offset=off, seed=34)
    h[0, 0, 0, 0, 0] = 0                # a zero band: NaN at bias 0
    cout = 1 if combine else c
    g = torch.from_numpy(_rand((2, 6, cout, *h.shape[3:5]), 35)).to(dev)
    want = scat_mag.scat_mag_bwd2_plain(h, g, u, bias, combine)
    n0 = scat_mag.scat_mag_bwd2.launches
    i0 = dict(scat_mag.scat_mag_bwd2.instantiations)
    got = scat_mag.scat_mag_bwd2(h, g, u, bias, combine)
    assert scat_mag.scat_mag_bwd2.launches == n0 + 1
    inst = "strided" if layout == "strided" else "vector"
    assert scat_mag.scat_mag_bwd2.instantiations[inst] == i0[inst] + 1
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, equal_nan=bias == 0.0, **BWD2_TOL)


@pytest.mark.parametrize("name", ["ScatLayerj2", "DWTForward"])
def test_hvp_on_card(dev, name):
    """A reverse-over-reverse Hessian-vector product through a module on
    the card == the CPU plain run's (K18 in the scattering layer's)."""
    kw = dict(J=2, wave="db4", mode="symmetric") if name == "DWTForward" \
        else {}
    x = torch.from_numpy(_rand((2, 3, 32, 32), 36))
    v = torch.from_numpy(_rand((2, 3, 32, 32), 37))

    def hvp(device):
        m = getattr(tt, name)(device=device, **kw)
        xt = x.to(device).requires_grad_()
        out = m(xt)
        if name == "DWTForward":
            loss = sum((o ** 3).sum() for o in [out[0], *out[1]])
        else:
            loss = (out ** 2).sum()
        g, = torch.autograd.grad(loss, xt, create_graph=True)
        return torch.autograd.grad((g * v.to(device)).sum(), xt)[0]

    ref = hvp("cpu")
    n0 = scat_mag.scat_mag_bwd2.launches
    got = hvp(dev).cpu()
    if name == "ScatLayerj2":
        assert scat_mag.scat_mag_bwd2.launches > n0
    scale = max(1.0, float(ref.abs().max()))
    torch.testing.assert_close(got, ref, rtol=0, atol=2e-5 * scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("axis", [2, 3])
@pytest.mark.parametrize("view", ["contiguous", "transposed", "strided"])
@pytest.mark.parametrize("left,right", [(0, 3), (3, 0), (7, 7), (2, 5)])
def test_halo_kernels(dev, dtype, axis, view, left, right):
    """K19's three entries against their plain versions, bit for bit, at
    halo widths 0, equal to the tile (7) and in between, into a window
    that is a slice of a wider one, from a strided cotangent."""
    from pytorch_wavelets_tpu_torch.ops import halo
    base = torch.from_numpy(_rand((2, 3, 7, 7), 5)).to(dtype).to(dev)
    x = {"contiguous": base, "transposed": base.transpose(2, 3),
         "strided": base[:, ::2]}[view]
    L = x.shape[axis]
    per = x.numel() // L
    before = [k.launches for k in (halo.halo_pack, halo.halo_assemble,
                                   halo.halo_fold)]
    tail, head = x.new_empty(per * left), x.new_empty(per * right)
    pt, ph = tail.clone(), head.clone()
    halo.halo_pack(x, axis, left, right, tail, head)
    halo.halo_pack_plain(x, axis, left, right, pt, ph)
    assert torch.equal(tail, pt) and torch.equal(head, ph)
    recv_l = torch.from_numpy(_rand((per * left,), 6)).to(dtype).to(dev)
    recv_r = torch.from_numpy(_rand((per * right,), 7)).to(dtype).to(dev)
    for lsrc, rsrc in (("recv", "recv"), ("flip", "zero"), ("zero", "flip")):
        shape = list(x.shape)
        shape[axis] = left + L + right
        wide = list(shape)
        wide[axis] += 2
        win = torch.full(wide, float("nan"), dtype=dtype,
                         device=dev).narrow(axis, 1, shape[axis])
        pwin = win.clone()
        halo.halo_assemble(x, axis, left, right, lsrc, rsrc, recv_l, recv_r,
                           win)
        halo.halo_assemble_plain(x, axis, left, right, lsrc, rsrc, recv_l,
                                 recv_r, pwin)
        assert torch.equal(win, pwin)
        gw = torch.from_numpy(_rand(shape, 8)).to(dtype).to(dev)
        gw = gw.transpose(0, 1).contiguous().transpose(0, 1)
        assert torch.equal(
            halo.halo_fold(gw, axis, left, right, lsrc, rsrc, recv_r, recv_l),
            halo.halo_fold_plain(gw, axis, left, right, lsrc, rsrc, recv_r,
                                 recv_l))
    after = [k.launches for k in (halo.halo_pack, halo.halo_assemble,
                                  halo.halo_fold)]
    assert [a - b for a, b in zip(after, before)] == [1, 3, 3]


_HALO_SOURCES = [("recv", "recv"), ("flip", "zero"), ("zero", "flip"),
                 ("flip", "recv")]


def _halo_view(base, kind):
    """chip_smoke.py:_k19_views: contiguous, every other row, one column
    short (an odd length along W), transposed, a strided slice along W,
    an element offset along W."""
    return {"contiguous": base, "rows": base[:, :, ::2],
            "narrow": base[..., :-1], "transposed": base.transpose(2, 3),
            "strided": base[..., ::2], "offset": base[..., 1:]}[kind]


def _halo_window(like, axis, width, win, fill):
    """A ``width``-long window for tile ``like`` along ``axis``, laid out
    as ``win`` names: "lines" a slice of a wider tensor whose rows are
    whole 16-sample lines, "off" such a slice one sample along W into
    it, "h_inner" a tensor with H innermost."""
    shape = list(like.shape)
    shape[axis] = width
    if win == "h_inner":
        return torch.full((*shape[:2], shape[3], shape[2]), fill,
                          dtype=like.dtype, device=like.device).transpose(2, 3)
    offset = int(win == "off")
    wide = list(shape)
    wide[3] = -(-(wide[3] + offset) // 16) * 16
    return torch.full(wide, fill, dtype=like.dtype, device=like.device) \
        .narrow(3, offset, shape[3])


def _halo_walk_delta(kernel, before):
    return {k: n - before[k] for k, n in kernel.instantiations.items()
            if n != before[k]}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("axis", [2, 3])
@pytest.mark.parametrize("kind,W,win,walk", [
    ("contiguous", 16, "lines", "vector"), ("rows", 16, "lines", "vector"),
    ("narrow", 16, "lines", "vector"), ("offset", 16, "lines", "vector"),
    ("contiguous", 16, "off", "vector"), ("contiguous", 7, "lines",
                                          "vector"),
    ("transposed", 16, "lines", "strided"), ("strided", 16, "lines",
                                             "strided"),
    ("contiguous", 16, "h_inner", "strided")])
@pytest.mark.parametrize("left,right", [(3, 5), (5, 2), (0, 6)])
def test_halo_walks(dev, dtype, axis, kind, W, win, walk, left, right):
    """K19's entries take the walk ``ops/halo.py:halo_walk`` names and
    equal their plain versions bit for bit on it: the vector walk on
    tiles and windows at unit stride along W wherever their rows start
    (odd lengths along H and W, halo widths off the multiples of 4, a
    tile at an element offset, rows of 7 samples, a window one sample off
    the 16-byte lines: heads stored alone), the strided walk on
    transposed and strided-slice tiles and on windows with H innermost;
    every halo source."""
    from pytorch_wavelets_tpu_torch.ops import halo
    base = torch.from_numpy(_rand((2, 3, 11, W), 9)).to(dtype).to(dev)
    x = _halo_view(base, kind)
    L = x.shape[axis]
    assert max(left, right) <= L
    per = x.numel() // L
    w = left + L + right
    k = (halo.halo_pack, halo.halo_assemble, halo.halo_fold)
    before = [dict(e.instantiations) for e in k]
    tail, head = x.new_empty(per * left), x.new_empty(per * right)
    pt, ph = tail.clone(), head.clone()
    halo.halo_pack(x, axis, left, right, tail, head)
    halo.halo_pack_plain(x, axis, left, right, pt, ph)
    assert torch.equal(tail, pt) and torch.equal(head, ph)
    tile_walk = halo.halo_walk(x)
    assert tile_walk == ("vector" if win == "h_inner" else walk)
    assert _halo_walk_delta(k[0], before[0]) == {tile_walk: 1}
    recv_l = torch.from_numpy(_rand((per * left,), 10)).to(dtype).to(dev)
    recv_r = torch.from_numpy(_rand((per * right,), 11)).to(dtype).to(dev)
    for lsrc, rsrc in _HALO_SOURCES:
        out = _halo_window(x, axis, w, win, float("nan"))
        pout = out.clone()
        halo.halo_assemble(x, axis, left, right, lsrc, rsrc, recv_l, recv_r,
                           out)
        halo.halo_assemble_plain(x, axis, left, right, lsrc, rsrc, recv_l,
                                 recv_r, pout)
        assert torch.equal(out, pout)
        assert halo.halo_walk(x, out) == walk
        gw = _halo_window(x, axis, w, win, 0.0)
        gw.copy_(torch.from_numpy(_rand(tuple(gw.shape), 12)).to(dtype))
        assert torch.equal(
            halo.halo_fold(gw, axis, left, right, lsrc, rsrc, recv_r, recv_l),
            halo.halo_fold_plain(gw, axis, left, right, lsrc, rsrc, recv_r,
                                 recv_l))
        fold_walk = "strided" if win == "h_inner" else "vector"
        assert halo.halo_walk(gw) == fold_walk
    assert _halo_walk_delta(k[1], before[1]) == {walk: 4}
    assert _halo_walk_delta(k[2], before[2]) == {fold_walk: 4}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("axis", [2, 3])
@pytest.mark.parametrize("nparts", [2, 10])
def test_halo_multi_part(dev, dtype, axis, nparts):
    """One call over several parts (tiles of one shape but along the
    axis; their blocks back to back, their windows side by side) is one
    launch for every 8 parts, on the vector walk, and equals the plain
    versions bit for bit."""
    from pytorch_wavelets_tpu_torch.ops import halo
    left, right = 3, 5
    lengths = [8 + 8 * (i % 3) for i in range(nparts)]
    parts = []
    for i, L in enumerate(lengths):
        shape = [2, 3, 7, 16]
        shape[axis] = L
        parts.append(torch.from_numpy(_rand(shape, 20 + i)).to(dtype)
                     .to(dev))
    per = parts[0].numel() // parts[0].shape[axis]
    n = per * nparts
    launches = -(-nparts // 8)
    k = (halo.halo_pack, halo.halo_assemble, halo.halo_fold)
    before = [e.launches for e in k]
    vec = [e.instantiations["vector"] for e in k]
    tail, head = parts[0].new_empty(n * left), parts[0].new_empty(n * right)
    pt, ph = tail.clone(), head.clone()
    halo.halo_pack(parts, axis, left, right, tail, head)
    halo.halo_pack_plain(parts, axis, left, right, pt, ph)
    assert torch.equal(tail, pt) and torch.equal(head, ph)
    recv_l = torch.from_numpy(_rand((n * left,), 1)).to(dtype).to(dev)
    recv_r = torch.from_numpy(_rand((n * right,), 2)).to(dtype).to(dev)
    shape = list(parts[0].shape)
    shape[axis] = sum(lengths) + nparts * (left + right)
    for lsrc, rsrc in _HALO_SOURCES[:2]:
        win = torch.full(shape, float("nan"), dtype=dtype, device=dev)
        pwin = win.clone()
        halo.halo_assemble(parts, axis, left, right, lsrc, rsrc, recv_l,
                           recv_r, win)
        halo.halo_assemble_plain(parts, axis, left, right, lsrc, rsrc,
                                 recv_l, recv_r, pwin)
        assert torch.equal(win, pwin)
        gw = torch.from_numpy(_rand(shape, 3)).to(dtype).to(dev)
        got = halo.halo_fold(gw, axis, left, right, lsrc, rsrc, recv_r,
                             recv_l, lengths)
        want = halo.halo_fold_plain(gw, axis, left, right, lsrc, rsrc,
                                    recv_r, recv_l, lengths)
        assert len(got) == nparts
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [e.launches - b for e, b in zip(k, before)] == \
        [launches, 2 * launches, 2 * launches]
    assert [e.instantiations["vector"] - v for e, v in zip(k, vec)] == \
        [launches, 2 * launches, 2 * launches]


def test_scat_third_order_on_card(dev):
    """A third-order directional derivative of sum(Z^3) through
    ScatLayerj2 on the card (K18 inside a Function whose backward runs K5
    and K18 again) against the CPU plain run."""
    x, v, w = (torch.from_numpy(_rand((2, 3, 32, 32), s)) for s in (0, 1, 2))

    def third(device):
        m = tt.ScatLayerj2(device=device)
        xt = x.to(device).requires_grad_()
        g1, = torch.autograd.grad((m(xt) ** 3).sum(), xt, create_graph=True)
        g2, = torch.autograd.grad((g1 * v.to(device)).sum(), xt,
                                  create_graph=True)
        return torch.autograd.grad((g2 * w.to(device)).sum(), xt)[0]
    ref = third("cpu")
    n = scat_mag.scat_mag_bwd2.launches
    got = third(dev).cpu()
    assert scat_mag.scat_mag_bwd2.launches > n
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                               atol=2e-5 * max(1.0, float(ref.abs().max())))
