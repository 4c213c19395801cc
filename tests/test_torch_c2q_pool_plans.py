"""K3's and K11's vector instantiations, emulated in numpy exactly as
``csrc/c2q_unpack.cu`` (``c2q_vector``) and ``csrc/avg_pool2.cu``
(``pool_fwd_vector``, ``pool_bwd_vector``) walk a view: block -> (plane,
member) or plane and chunk, thread -> slots.  Every value must be read
and written exactly once, every 16-byte access the kernels take without
a check aligned, and the emulated kernels must equal their plain versions
(``ops/quad.py``, ``ops/pool.py``) bit for bit, on the CPU: K3 on fp32
and bf16, odd w, offset bands, both output layouts, rows of several
chunks; K11 forward and adjoint on
aligned, offset and odd rows.  The C entries' choice of instantiation,
emulated here too, is checked on edge views."""
import numpy as np
import pytest
import torch

from pytorch_wavelets_tpu_torch.ops import pool, quad
from pytorch_wavelets_tpu_torch.ops.fused_dtcwt import canonical_bands
from pytorch_wavelets_tpu_torch.transforms.dtcwt import get_dimensions5
from tests.test_torch_spec_quad_plans import (
    _base_aligned, _flat, _once, _strided, q2c_slots,
)

# one thread, as the port's other CPU test files
torch.set_num_threads(1)

# csrc/quad_slots.cuh and csrc/avg_pool2.cu: a block's threads; the
# vector instantiations' slots a thread (T apart)
T, U = 256, 2
I32 = 2 ** 31
ORIENTS = ((2, 3), (1, 4))
ORIENTS3 = ((0, 5), (2, 3), (1, 4))


def _bits(t):
    """``t``'s bit patterns, so that torch.equal compares bit for bit."""
    return t.view(torch.int32) if t.dtype == torch.float32 else \
        t.view(torch.int16)


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------

def _bands(N, C, m, k, o_dim=2, ri_dim=-1, dtype=torch.float32, offset=0,
           seed=0):
    """Random bands in the (o_dim, ri_dim) layout, ``offset`` elements
    into a new 16-byte aligned storage, as the canonical (N, C, 6, m, k, 2)
    view K3 takes."""
    od, rd, _, _ = get_dimensions5(o_dim, ri_dim)
    shape = [N, C, m, k]
    shape.insert(od, 6)
    shape.insert(rd, 2)
    h = _strided(shape, torch.empty(shape).stride(), offset, dtype=dtype,
                 seed=seed)
    return canonical_bands(h, od, rd)


def c2q_slots(h, J):
    """K3's vector slots a row (csrc/quad_slots.cuh:slots_a_row): J j a
    slot, one more than ceil(w / J) unless every band row starts on a
    16-byte line."""
    esz = h.element_size()
    V = 16 // (2 * esz)
    sn, sc, so, sh = h.stride()[:4]
    lines = h.data_ptr() % 16 == 0 and (sn | sc | so | sh) % (16 // esz) == 0
    return (h.shape[4] - 1 + (0 if lines else V - 1)) // J + 1


def c2q_slot_j(h, il):
    """j a K3 vector slot (csrc/c2q_unpack.cu:c2q_vector): one 16-byte line
    of the bands (V (re, im)) per level, two on the composed output."""
    return 16 // (2 * h.element_size()) * (1 if il else 2)


def emulate_c2q_choice(h, orients, il):
    """The instantiation K3's C entry picks (csrc/c2q_unpack.cu:
    vector_plan): ``vector`` where the bands have re/im and the w pairs
    adjacent on whole pairs, the output its composed or interleaved
    layout, and a plane's offsets fit in 32 bits; else ``strided``."""
    N, C, _, hh, ww, _ = h.shape
    nm = len(orients)
    _, (sxp, sxm, sxi, sxj, x1o, x2o, x3o, x4o, _) = quad._c2q_addr(h, nm,
                                                                    il)
    sn, sc, so, sh, sw, sri = h.stride()
    esz = h.element_size()
    V = 16 // (2 * esz)
    S = c2q_slots(h, c2q_slot_j(h, il))
    vector = (sri == 1 and sw == 2 and h.data_ptr() % (2 * esz) == 0
              and (sn | sc | so | sh) % 2 == 0 and x1o == 0
              and (sxj == 1 or il)
              and (not il or (sxp | sxm | sxi | x3o) % 2 == 0)
              and (hh + 1) * abs(sxi) + 2 * ww + abs(x2o) + abs(x3o)
              + abs(x4o) < I32 and (hh + 1) * abs(sh) + 2 * ww < I32
              and hh * S < I32
              and N * C * nm * -(-hh * S // (T * U)) < I32)
    return "vector" if vector else "strided"


def emulate_c2q_vector(h, orients, il):
    """K3's vector instantiation (csrc/c2q_unpack.cu:c2q_vector) on bands
    ``h``: returns (the output, reads of each element of h's storage,
    writes of each output element, full slots, partial slots)."""
    N, C, _, hh, ww, _ = h.shape
    nm = len(orients)
    shape, addr = quad._c2q_addr(h, nm, il)
    sxp, sxm, sxi, sxj, x1o, x2o, x3o, x4o, scale = addr
    sn, sc, so, sh, sw, sri = h.stride()
    E = h.element_size()
    V = 16 // (2 * E)
    J = c2q_slot_j(h, il)
    S = c2q_slots(h, J)
    per = T * U
    cpp = -(-hh * S // per)
    blk, tid = np.divmod(np.arange(N * C * nm * cpp * T), T)
    pm, chunk = np.divmod(blk, cpp)
    p, t = np.divmod(pm, nm)
    n, c = np.divmod(p, C)
    o = np.array(orients)[t]
    b1 = h.storage_offset() + n * sn + c * sc + o[:, 0] * so
    b2 = h.storage_offset() + n * sn + c * sc + o[:, 1] * so
    xb = p * sxp + t * sxm
    full_n = part_n = 0
    th, jj, ii = [], [], []
    for u in range(U):
        e = chunk * per + u * T + tid
        live = e < hh * S
        i, s = np.divmod(e, S)
        r1 = b1 + i * sh
        j0 = s * J - (r1 * E % 16) // (2 * E)
        full = live & (j0 >= 0) & (j0 + J <= ww)
        # a full slot's o1 loads (16 bytes a line) are aligned by the anchor
        assert ((r1 + 2 * j0)[full] * E % 16 == 0).all()
        full_n += int(full.sum())
        part_n += int((live & ~full & (j0 + J > 0) & (j0 < ww)).sum())
        for v in range(J):
            j = j0 + v
            ok = live & (j >= 0) & (j < ww)
            assert (ok | ~full).all()
            sel = np.nonzero(ok)[0]
            th.append(sel)
            jj.append(j[sel])
            ii.append(i[sel])
    th, j, i = np.concatenate(th), np.concatenate(jj), np.concatenate(ii)
    hfl = _flat(h)
    reads = np.zeros(hfl.numel(), np.int64)
    vals = []
    for at in (b1[th] + i * sh + j * sw, b2[th] + i * sh + j * sw):
        for off in (0, sri):
            np.add.at(reads, at + off, 1)
            vals.append(hfl[torch.from_numpy(at + off)].float())
    w1r, w1i, w2r, w2i = vals
    xq = torch.full(shape, float("nan"), dtype=h.dtype)
    xfl = xq.view(-1)
    writes = np.zeros(xq.numel(), np.int64)
    at = xb[th] + i * sxi + j * sxj
    for off, v in ((x1o, w1r + w2r), (x2o, w1i + w2i), (x3o, w1i - w2i),
                   (x4o, w2r - w1r)):
        np.add.at(writes, at + off, 1)
        xfl[torch.from_numpy(at + off)] = torch.mul(v, scale).to(h.dtype)
    return xq, reads, writes, full_n, part_n


def _c2q_ref(h, orients, il):
    """The plain version in fp32, rounded once to h's dtype; per level
    scaled by a multiplication by fp32(1/sqrt2), as the kernel and
    PyTorch on the card scale (the CPU's plain version divides)."""
    if not il:
        return quad.c2q_unpack_plain(h.float(), orients).to(h.dtype)
    hf = h.float()
    N, C, _, hh, ww, _ = h.shape
    want = torch.empty((N, C, len(orients), 2 * hh, 2 * ww))
    for t, (o1, o2) in enumerate(orients):
        w1r, w1i = hf[:, :, o1, ..., 0], hf[:, :, o1, ..., 1]
        w2r, w2i = hf[:, :, o2, ..., 0], hf[:, :, o2, ..., 1]
        for (a, b), v in (((0, 0), w1r + w2r), ((0, 1), w1i + w2i),
                          ((1, 0), w1i - w2i), ((1, 1), w2r - w1r)):
            want[:, :, t, a::2, b::2] = torch.mul(v, quad.INV_SQRT2)
    return want.to(h.dtype)


C2Q_CASES = [
    # (case, h, w, interleaved, o_dim, ri_dim, bands offset)
    ("composed", 3, 8, False, 2, -1, 0),
    ("composed odd w", 3, 7, False, 2, -1, 0),
    ("composed w 1", 2, 1, False, 2, -1, 0),
    # bands 2, 4, 6 elements into a line: fp32 8, 16, 24 bytes, bf16 4,
    # 8, 12
    ("composed offset 2", 2, 6, False, 2, -1, 2),
    ("composed offset 4", 3, 9, False, 2, -1, 4),
    ("composed offset 6", 2, 10, False, 2, -1, 6),
    ("composed scat layout", 3, 5, False, 1, -1, 0),
    ("composed o first", 2, 9, False, 0, 5, 6),
    ("composed wide", 5, 300, False, 2, -1, 2),
    ("per level", 3, 8, True, 2, -1, 0),
    ("per level odd w", 3, 5, True, 1, -1, 0),
    ("per level offset", 2, 6, True, 2, -1, 4),
    ("per level wide", 4, 300, True, 2, -1, 0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case,hh,ww,il,o_dim,ri_dim,off", C2Q_CASES,
                         ids=[c[0] for c in C2Q_CASES])
def test_c2q_vector_map(case, hh, ww, il, o_dim, ri_dim, off, dtype):
    """The vector instantiation reads each (re, im) of the members'
    orientations once and writes each quadrant value once, bit for bit
    the plain version computed in fp32 and rounded once."""
    orients = ORIENTS3 if il else ORIENTS
    h = _bands(2, 3, hh, ww, o_dim, ri_dim, dtype, off)
    assert emulate_c2q_choice(h, orients, il) == "vector"
    xq, reads, writes, full, part = emulate_c2q_vector(h, orients, il)
    J = c2q_slot_j(h, il)
    assert full > 0 or ww < 2 * J
    if ww % J or off * h.element_size() % 16:
        assert part > 0          # partial first or last slots
    used = sorted({o for pair in orients for o in pair})
    _once(reads, *(h[:, :, o] for o in used))
    assert (writes == 1).all()
    assert torch.equal(_bits(xq), _bits(_c2q_ref(h, orients, il)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("o_dim,ri_dim,want", [
    (2, -1, "vector"), (1, -1, "vector"), (0, 5, "vector"),
    (1, 3, "strided"), (4, 2, "strided"), (2, 3, "strided")])
def test_c2q_instantiation_layouts(o_dim, ri_dim, want, dtype):
    """Every o_dim / ri_dim layout: vector where re/im are adjacent and the
    w pairs adjacent, else strided; both output layouts."""
    h = _bands(2, 3, 3, 6, o_dim, ri_dim, dtype)
    for il in (False, True):
        assert emulate_c2q_choice(h, ORIENTS3 if il else ORIENTS,
                                  il) == want


def test_c2q_slot_plan():
    """Bands off a whole (re, im) pair take the strided instantiation;
    the slots a row are K2's plan (q2c_slots) at one line a slot (per
    level), half as many (rounded up) at two (composed)."""
    h = _bands(2, 3, 3, 6, offset=1)
    assert emulate_c2q_choice(h, ORIENTS, False) == "strided"
    for k, off, dtype in ((8, 0, torch.float32), (7, 0, torch.float32),
                          (8, 2, torch.float32), (8, 0, torch.bfloat16),
                          (6, 0, torch.bfloat16), (9, 4, torch.bfloat16)):
        h = _bands(1, 1, 2, k, dtype=dtype, offset=off)
        V, S = q2c_slots(h, k)
        assert c2q_slots(h, c2q_slot_j(h, True)) == S
        head = S - ((k - 1) // V + 1)       # 1 where rows start off lines
        assert c2q_slots(h, c2q_slot_j(h, False)) == \
            (k - 1 + head * (V - 1)) // (2 * V) + 1


# ---------------------------------------------------------------------------
# K11
# ---------------------------------------------------------------------------

def emulate_pool_choice(x, adjoint=False):
    """The instantiation K11's C entries pick (csrc/avg_pool2.cu): the
    forward ``vector`` where x has unit stride along W, lies on a whole
    pair with even row and plane strides and a plane fits in 32 bits; the
    adjoint ``vector`` where the cotangent has unit stride along w."""
    N, C, H, W = x.shape
    s0, s1, s2, s3 = x.stride()
    if adjoint:
        h, w = H, W
        S = (w + 1) // 2
        ok = s3 == 1 and h * abs(s2) + w < I32 and 4 * h * w < I32
    else:
        h, w = H // 2, W // 2
        lines = x.data_ptr() % 16 == 0 and s0 % 4 == 0 and s1 % 4 == 0
        S = (w - 1 + (0 if lines else 1)) // 2 + 1
        ok = (s3 == 1 and x.data_ptr() % 8 == 0
              and (s0 | s1 | s2) % 2 == 0 and 2 * h * abs(s2) + 2 * w < I32)
    per = T * U
    ok = ok and h * S + per < I32 and N * C * -(-h * S // per) < I32
    return ("vector" if ok else "strided"), S


def _pool_grid(N, C, h, S):
    per = T * U
    cpp = -(-h * S // per)
    blk, tid = np.divmod(np.arange(N * C * cpp * T), T)
    p, chunk = np.divmod(blk, cpp)
    n, c = np.divmod(p, C)
    return p, n, c, [chunk * per + u * T + tid for u in range(U)]


def emulate_pool_fwd(x):
    """K11's forward vector walk (csrc/avg_pool2.cu:pool_fwd_vector):
    returns (y, reads of each element of x's storage, writes of each
    element of y, partial slots)."""
    N, C, H, W = x.shape
    h, w = H // 2, W // 2
    s0, s1, s2, s3 = x.stride()
    _, S = emulate_pool_choice(x)
    p, n, c, es = _pool_grid(N, C, h, S)
    xb = x.storage_offset() + n * s0 + c * s1
    th, jj, ii = [], [], []
    part_n = 0
    for e in es:
        live = e < h * S
        i, s = np.divmod(e, S)
        r = xb + 2 * i * s2
        assert (r * 4 % 8 == 0).all()             # rows on whole pairs
        j0 = 2 * s - (r * 4 % 16) // 8
        full = live & (j0 >= 0) & (j0 + 2 <= w)
        # row 2i's float4 is aligned by the anchor
        assert ((r + 2 * j0)[full] * 4 % 16 == 0).all()
        part_n += int((live & ~full).sum())
        for v in range(2):
            j = j0 + v
            ok = live & (j >= 0) & (j < w)
            assert (ok | ~full).all()
            sel = np.nonzero(ok)[0]
            th.append(sel)
            jj.append(j[sel])
            ii.append(i[sel])
    th, j, i = np.concatenate(th), np.concatenate(jj), np.concatenate(ii)
    xfl = _flat(x)
    reads = np.zeros(xfl.numel(), np.int64)
    q = xb[th] + 2 * i * s2 + 2 * j
    vals = []
    for off in (0, 1, s2, s2 + 1):
        np.add.at(reads, q + off, 1)
        vals.append(xfl[torch.from_numpy(q + off)])
    y = torch.full((N, C, h, w), float("nan"))
    at = p[th] * h * w + i * w + j
    writes = np.zeros(y.numel(), np.int64)
    np.add.at(writes, at, 1)
    y.view(-1)[torch.from_numpy(at)] = \
        ((vals[0] + vals[1]) + (vals[2] + vals[3])) * 0.25
    return y, reads, writes, part_n


def emulate_pool_bwd(g):
    """K11's adjoint vector walk (csrc/avg_pool2.cu:pool_bwd_vector):
    returns (dx, reads of each element of g's storage, writes of each
    element of dx, partial slots)."""
    N, C, h, w = g.shape
    s0, s1, s2, s3 = g.stride()
    _, S = emulate_pool_choice(g, adjoint=True)
    p, n, c, es = _pool_grid(N, C, h, S)
    gb = g.storage_offset() + n * s0 + c * s1
    th, jj, ii = [], [], []
    part_n = 0
    for e in es:
        live = e < h * S
        i, s = np.divmod(e, S)
        j0 = 2 * s
        full = live & (j0 + 2 <= w)
        # row 2i's float4 store: dx's rows start on 16-byte lines
        row = p * 4 * h * w + i * 4 * w + 2 * j0
        assert (row[full] * 4 % 16 == 0).all()
        part_n += int((live & ~full).sum())
        for v in range(2):
            j = j0 + v
            ok = live & (j < w)
            assert (ok | ~full).all()
            sel = np.nonzero(ok)[0]
            th.append(sel)
            jj.append(j[sel])
            ii.append(i[sel])
    th, j, i = np.concatenate(th), np.concatenate(jj), np.concatenate(ii)
    gfl = _flat(g)
    reads = np.zeros(gfl.numel(), np.int64)
    at = gb[th] + i * s2 + j
    np.add.at(reads, at, 1)
    v = gfl[torch.from_numpy(at)] * 0.25
    dx = torch.full((N, C, 2 * h, 2 * w), float("nan"))
    writes = np.zeros(dx.numel(), np.int64)
    base = p[th] * 4 * h * w + 2 * i * 2 * w + 2 * j
    for off in (0, 1, 2 * w, 2 * w + 1):
        np.add.at(writes, base + off, 1)
        dx.view(-1)[torch.from_numpy(base + off)] = v
    return dx, reads, writes, part_n


def _pool_input(N, C, H, W, pitch, offset, seed=11):
    """An (N, C, H, W) view at unit stride along W with rows ``pitch``
    apart, ``offset`` floats into a new 16-byte aligned storage."""
    return _strided((N, C, H, W), (C * H * pitch, H * pitch, pitch, 1),
                    offset, dtype=torch.float32, seed=seed)


POOL_CASES = [
    # (case, N, C, H, W, row pitch, offset)
    ("aligned", 2, 3, 8, 16, 16, 0),
    ("odd w", 2, 3, 6, 10, 10, 0),
    ("8 bytes off", 2, 3, 6, 12, 14, 2),
    ("odd pitch rows", 1, 2, 4, 8, 10, 0),
    ("h 1", 2, 3, 2, 12, 12, 0),
    ("w 1", 2, 3, 6, 2, 2, 0),
    ("several chunks", 1, 2, 80, 80, 84, 2),
]


@pytest.mark.parametrize("case,N,C,H,W,pitch,off", POOL_CASES,
                         ids=[c[0] for c in POOL_CASES])
def test_pool_fwd_vector_map(case, N, C, H, W, pitch, off):
    """The forward's vector walk reads each value of x once and writes
    each output once, bit for bit the plain version."""
    x = _pool_input(N, C, H, W, pitch, off)
    assert emulate_pool_choice(x)[0] == "vector"
    y, reads, writes, part = emulate_pool_fwd(x)
    if off % 4 or (W // 2) % 2:
        assert part > 0
    _once(reads, x)
    assert (writes == 1).all()
    assert torch.equal(_bits(y), _bits(pool.avg_pool2_fwd_plain(x)))


@pytest.mark.parametrize("case,N,C,H,W,pitch,off", POOL_CASES,
                         ids=[c[0] for c in POOL_CASES])
def test_pool_bwd_vector_map(case, N, C, H, W, pitch, off):
    """The adjoint's vector walk reads each cotangent value once and
    writes each value of dx once, bit for bit the plain version (odd
    offsets too: the cotangent's loads are checked)."""
    g = _pool_input(N, C, H // 2, W // 2, pitch, off + 1)
    assert emulate_pool_choice(g, adjoint=True)[0] == "vector"
    dx, reads, writes, part = emulate_pool_bwd(g)
    if (W // 2) % 2:
        assert part > 0
    _once(reads, g)
    assert (writes == 1).all()
    assert torch.equal(_bits(dx), _bits(pool.avg_pool2_bwd_plain(g)))


def test_pool_instantiation_edges():
    """The strided views: rows at odd offsets (the 17-wide edge view
    x[..., 1:15]), odd row strides, transposed views, a cotangent strided
    along w; NaN-free outputs of the right layout on each side."""
    x = _base_aligned(torch.randn((2, 3, 10, 17)))[..., 1:15]
    assert emulate_pool_choice(x)[0] == "strided"
    assert emulate_pool_choice(x[..., ::2], adjoint=True)[0] == "strided"
    assert emulate_pool_choice(_pool_input(1, 2, 4, 8, 9, 0))[0] == \
        "strided"
    xt = _base_aligned(torch.randn((2, 3, 8, 6))).transpose(2, 3)
    assert emulate_pool_choice(xt)[0] == "strided"
    assert emulate_pool_choice(xt, adjoint=True)[0] == "strided"
    # a slice along H keeps the vector walk; one along W at an odd start
    # does not
    xa = _base_aligned(torch.randn((2, 3, 12, 16)))
    assert emulate_pool_choice(xa[:, :, 2:10])[0] == "vector"
    assert emulate_pool_choice(xa[..., 1:15])[0] == "strided"
    assert emulate_pool_choice(xa[..., 1:15], adjoint=True)[0] == "vector"
    assert tuple(pool.avg_pool2_fwd(x).shape) == (2, 3, 5, 7)
    assert pool.POOL_INSTS == ("vector", "strided")
