"""K13's walks and K2's vector instantiation, emulated in numpy exactly as
``csrc/iswt_spec.cu`` (``spec_stream``, ``spec_strided``) and
``csrc/q2c_pack.cu`` (``q2c_vector``) walk a view:
block -> rows or planes and chunks, thread -> values.  Every value must be
read and written exactly once, every 16-byte access the kernels take
without a check aligned, and the emulated kernels must equal their plain
versions (``ops/iswt_merge.py``, ``ops/quad.py``), on the CPU: K13 on
odd frequency rows (n/2 + 1 values for even n), both axes, offset views
and rows of several chunks; K2 on odd k, offset bands, both corner
layouts, fp32 and bf16 (bit for bit).  The C entries' choice of walk and
instantiation (``stream_args``, ``vector_plan``), emulated here too, is
checked on edge views, with the layout the K13 wrappers write."""
import numpy as np
import pytest
import torch

from pytorch_wavelets_tpu_torch.ops import dtcwt_fb, iswt_merge, quad
from pytorch_wavelets_tpu_torch.ops.fused_dtcwt import canonical_bands
from pytorch_wavelets_tpu_torch.transforms.dtcwt import get_dimensions5

# one thread, as the port's other CPU test files
torch.set_num_threads(1)

# csrc/iswt_spec.cu: a block's threads; the stream walk's float4 pairs of
# each spectrum a thread
T, U = 256, 2
SPEC_TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, want):
    # torch.allclose: torch.testing's first call imports sympy (~1 s)
    assert got.shape == want.shape
    assert torch.allclose(got, want, **SPEC_TOL)


def _flat(t):
    """The whole storage under view ``t``, as a 1-D tensor of its dtype."""
    n = t.untyped_storage().nbytes() // t.element_size()
    return torch.as_strided(t, (n,), (1,), 0)


def _base_aligned(t):
    assert t.untyped_storage().data_ptr() % 16 == 0
    return t


def _strided(shape, strides, offset=0, dtype=torch.complex64, seed=0):
    """A view of a new storage (16-byte aligned) holding random values."""
    size = offset + 1 + sum((n - 1) * s for n, s in zip(shape, strides))
    gen = torch.Generator().manual_seed(seed)
    buf = torch.randn(size, generator=gen, dtype=dtype)
    return _base_aligned(torch.as_strided(buf, shape, strides, offset))


def _like(t, fill=float("nan")):
    """A view with ``t``'s shape, strides and offset on a new storage of
    the same size, filled with ``fill``."""
    buf = torch.full_like(_flat(t), fill)
    return _base_aligned(torch.as_strided(buf, t.shape, t.stride(),
                                          t.storage_offset()))


def _indices(t):
    """The storage index of every element of view ``t``."""
    idx = np.full(t.shape, t.storage_offset(), np.int64)
    for d, s in enumerate(t.stride()):
        shape = [1] * t.ndim
        shape[d] = t.shape[d]
        idx = idx + np.arange(t.shape[d]).reshape(shape) * s
    return idx.ravel()


def _once(counts, *views):
    """Every element of the ``views`` counted once, and nothing else."""
    idx = np.concatenate([_indices(t) for t in views])
    assert (counts[idx] == 1).all()
    assert counts.sum() == idx.size


# ---------------------------------------------------------------------------
# K13
# ---------------------------------------------------------------------------

def _spectra(n, axis, other=5, lead=(2, 3), seed=0):
    """(A, B): rfft spectra along ``axis`` of two (N, C, H, W) signals of
    ``n`` samples there: the frequency axis at stride 1."""
    shape = [*lead, other, other]
    shape[axis] = n
    gen = torch.Generator().manual_seed(seed)
    return [_base_aligned(torch.fft.rfft(torch.randn(shape, generator=gen),
                                         dim=axis)) for _ in range(2)]


def _filters(nf, seed=3):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(nf, generator=gen, dtype=torch.complex64)
            for _ in range(2)]


def _offset_view(t, off=1):
    """``t``'s values in a view of the same layout whose storage starts
    ``off`` elements earlier (rows start 8 bytes further into a line)."""
    v = _strided(t.shape, t.stride(), off + t.storage_offset())
    v.copy_(t)
    return v


def _value(kind, ins, idx, f, gi, g0, g1):
    """Each emulated output value of (thread row offsets ``idx``, value f
    along the row, filter index gi): merge -> [Z]; split -> [A', B']."""
    fl = [_flat(t) for t in ins]
    z = fl[0][torch.from_numpy(idx[0] + f)]
    a0, a1 = g0[torch.from_numpy(gi)], g1[torch.from_numpy(gi)]
    if kind == "merge":
        return [a0 * z + a1 * fl[1][torch.from_numpy(idx[1] + f)]]
    return [a0.conj() * z, a1.conj() * z]


def stream_plan(L):
    """The stream walk's (threads a row, chunks a row) for rows of ``L``
    values (csrc/iswt_spec.cu:stream_plan): the fewest threads, a power of
    two from 32 to T, whose U pairs each cover the row's L // 2 pairs."""
    pairs = L // 2
    tpr = 32
    while tpr < T and tpr * U < pairs:
        tpr *= 2
    return tpr, max(1, -(-pairs // (tpr * U)))


def emulate_walk(ins, outs):
    """The walk K13's C entries pick (csrc/iswt_spec.cu:stream_args):
    ``stream`` where every spectrum, the outputs too, has stride 1 along
    one axis and the rows and blocks fit in 32 bits, else ``strided``."""
    N, C, H, W = ins[0].shape
    for u in (3, 2):
        if all(t.stride(u) == 1 for t in ins + outs):
            rows = N * C * (H if u == 3 else W)
            tpr, cpr = stream_plan(W if u == 3 else H)
            if rows < 2 ** 31 and -(-rows // (T // tpr)) * cpr < 2 ** 31:
                return "stream"
            break
    return "strided"


def emulate_stream(kind, ins, outs, g0, g1, axis):
    """K13's stream walk (csrc/iswt_spec.cu:spec_stream) over the input
    spectra ``ins`` into the output views ``outs``: returns (reads of each
    input storage element, writes of each output storage element, the
    rows' heads taken alone); the values land in ``outs``."""
    arrs = ins + outs
    N, C, H, W = ins[0].shape
    u = next(c for c in (3, 2) if all(t.stride(c) == 1 for t in arrs))
    o = 5 - u
    R, L = ins[0].shape[o], ins[0].shape[u]
    tpr, cpr = stream_plan(L)
    rpb = T // tpr
    rows = N * C * R
    nb = -(-rows // rpb) * cpr
    blk, tid = np.divmod(np.arange(nb * T), T)
    rg, chunk = np.divmod(blk, cpr)
    row, lane = rg * rpb + tid // tpr, tid % tpr
    live = row < rows
    row, lane, chunk = row[live], lane[live], chunk[live]
    tt, r = np.divmod(row, R)
    n, c = np.divmod(tt, C)
    off = [t.storage_offset() + n * t.stride(0) + c * t.stride(1)
           + r * t.stride(o) for t in arrs]
    head = off[0] % 2                  # 8 bytes past a 16-byte line
    pairs = (L - head) // 2
    th, f = [], []
    for uu in range(U):
        q = chunk * tpr * U + uu * tpr + lane
        ok = q < pairs
        fq = head + 2 * q
        assert ((off[0] + fq)[ok] % 2 == 0).all()   # A's float4, aligned
        for e in (0, 1):
            th.append(np.nonzero(ok)[0])
            f.append(fq[ok] + e)
    first = (chunk == 0) & (lane == 0)
    for sel, pos in ((first & (head == 1), np.zeros_like(head)),
                     (first & ((L - head) % 2 == 1), np.full_like(head,
                                                                  L - 1))):
        th.append(np.nonzero(sel)[0])
        f.append(pos[sel])
    th, f = np.concatenate(th), np.concatenate(f)
    gi = f if u == axis else r[th]
    reads = [np.zeros(_flat(t).numel(), np.int64) for t in ins]
    for k, t in enumerate(ins):
        np.add.at(reads[k], off[k][th] + f, 1)
    writes = [np.zeros(_flat(t).numel(), np.int64) for t in outs]
    vals = _value(kind, ins, [x[th] for x in off], f, gi, g0, g1)
    for k, (t, v) in enumerate(zip(outs, vals)):
        at = off[len(ins) + k][th] + f
        np.add.at(writes[k], at, 1)
        _flat(t)[torch.from_numpy(at)] = v
    return reads, writes, int(head.sum())


def emulate_strided(kind, ins, outs, g0, g1, axis):
    """K13's strided walk (csrc/iswt_spec.cu:spec_strided): planes x
    chunks, 4 values a thread, 256 apart, (i, j) by a division by W."""
    N, C, H, W = ins[0].shape
    per = T * 4
    cpp = -(-H * W // per)
    blk, tid = np.divmod(np.arange(N * C * cpp * T), T)
    p, chunk = np.divmod(blk, cpp)
    n, c = np.divmod(p, C)
    th, idxs = [], []
    for uu in range(4):
        idx = chunk * per + uu * T + tid
        ok = idx < H * W
        th.append(np.nonzero(ok)[0])
        idxs.append(idx[ok])
    th, idx = np.concatenate(th), np.concatenate(idxs)
    i, j = np.divmod(idx, W)
    offs = [t.storage_offset() + n[th] * t.stride(0) + c[th] * t.stride(1)
            + i * t.stride(2) + j * t.stride(3) for t in ins + outs]
    reads = [np.zeros(_flat(t).numel(), np.int64) for t in ins]
    for q in range(len(ins)):
        np.add.at(reads[q], offs[q], 1)
    writes = [np.zeros(_flat(t).numel(), np.int64) for t in outs]
    vals = _value(kind, ins, offs[:len(ins)], 0, i if axis == 2 else j, g0,
                  g1)
    for o, (t, v) in enumerate(zip(outs, vals)):
        at = offs[len(ins) + o]
        np.add.at(writes[o], at, 1)
        _flat(t)[torch.from_numpy(at)] = v
    return reads, writes


def _outputs(kind, ins):
    """(the walk the C entry picks, the output views the wrapper
    allocates: ``ops/iswt_merge.py:_empty`` in the inputs' layout,
    NaN-filled)."""
    lead = () if kind == "merge" else (2,)
    out = iswt_merge._empty(ins[0].shape, iswt_merge._unit_axis(ins), lead)
    out = _base_aligned(_like(out))
    outs = [out] if kind == "merge" else [out[0], out[1]]
    return emulate_walk(ins, outs), outs


SPEC_CASES = [
    # (case, n, axis, other, offset)
    ("H odd rows", 16, 2, 5, 0),
    ("W odd rows", 16, 3, 5, 0),
    ("H even rows", 10, 2, 3, 0),
    ("W long rows", 2100, 3, 2, 0),
    ("H long rows", 2100, 2, 1, 0),
    ("H rows of 36", 70, 2, 37, 0),
    ("H offset", 16, 2, 5, 1),
    ("W offset", 9, 3, 4, 1),
    # spectra stored along the other axis (a row's filter pair constant)
    ("H spectra along W", 16, 2, 6, "W"),
    ("W spectra along H", 16, 3, 6, "H"),
]


def _restore(t, inner):
    """``t``'s values stored with axis W (or H) innermost."""
    if inner == "W":
        return t.contiguous()
    return t.transpose(2, 3).contiguous().transpose(2, 3)


@pytest.mark.parametrize("kind", ["merge", "split"])
@pytest.mark.parametrize("case,n,axis,other,offset", SPEC_CASES,
                         ids=[c[0] for c in SPEC_CASES])
def test_k13_walks(kind, case, n, axis, other, offset):
    """K13's stream walk reads each spectrum value once and writes each
    output value once, and equals the plain versions."""
    A, B = _spectra(n, axis, other, lead=(1, 2) if n > 1000 else (2, 3))
    if isinstance(offset, str):
        A, B = _restore(A, offset), _restore(B, offset)
    elif offset:
        A, B = _offset_view(A, offset), _offset_view(B, offset)
    g0, g1 = _filters(A.shape[axis])
    ins = [A, B] if kind == "merge" else [A]
    walk, outs = _outputs(kind, ins)
    assert walk == "stream"
    reads, writes, heads = emulate_stream(kind, ins, outs, g0, g1, axis)
    if offset == 1 or (A.shape[axis] % 2 and A.shape[5 - axis] > 1
                       and not isinstance(offset, str)):
        assert heads > 0     # odd rows: every other row starts mid-line
    for r, t in zip(reads, ins):
        _once(r, t)
    for w, t in zip(writes, outs):
        _once(w, t)
    if kind == "merge":
        _close(outs[0], iswt_merge.spec_merge_plain(A, B, g0, g1, axis))
    else:
        _close(torch.stack(outs), iswt_merge.spec_split_plain(A, g0, g1,
                                                              axis))


@pytest.mark.parametrize("kind", ["merge", "split"])
@pytest.mark.parametrize("axis", [2, 3])
def test_k13_strided_walk(kind, axis):
    """The strided walk on spectra of mixed layouts (B transposed against
    A, an input broadcast along the other axis)."""
    A, B = _spectra(16, axis, 6)
    B = _offset_view(B.transpose(2, 3).contiguous().transpose(2, 3), 0) \
        if axis == 3 else _offset_view(B.contiguous())
    if kind == "split":
        A = A.narrow(5 - axis, 0, 1).expand(A.shape)    # stride 0
    g0, g1 = _filters(A.shape[axis])
    ins = [A, B] if kind == "merge" else [A]
    walk, outs = _outputs(kind, ins)
    assert walk == ("strided" if kind == "merge" else "stream")
    if walk == "stream":
        reads, writes, _ = emulate_stream(kind, ins, outs, g0, g1, axis)
        assert reads[0].sum() == A.numel()   # each broadcast value per row
    else:
        reads, writes = emulate_strided(kind, ins, outs, g0, g1, axis)
        for r, t in zip(reads, ins):
            _once(r, t)
    for w, t in zip(writes, outs):
        _once(w, t)
    if kind == "merge":
        _close(outs[0], iswt_merge.spec_merge_plain(A, B, g0, g1, axis))
    else:
        _close(torch.stack(outs), iswt_merge.spec_split_plain(A, g0, g1,
                                                              axis))


def test_k13_walk_choice():
    """The outputs' layout the wrappers write and the walk the C entries
    pick on edge views; the stream plan's threads and chunks a row."""
    for axis in (2, 3):
        A, B = _spectra(16, axis)
        assert iswt_merge._unit_axis([A, B]) == axis
        assert _outputs("merge", [A, B])[0] == "stream"
        assert _outputs("split", [A])[1][0].stride(axis) == 1
        Bt = B.contiguous() if axis == 2 else \
            B.transpose(2, 3).contiguous().transpose(2, 3)
        assert iswt_merge._unit_axis([A, Bt]) == 3
        assert _outputs("merge", [A, Bt])[0] == "strided"
        # an offset or sliced view keeps its unit stride
        assert _outputs("merge", [A[:, 1:], B[:, 1:]])[0] == "stream"
        # no unit stride at all
        X = A.narrow(axis, 0, 4).transpose(0, 1)[::2]
        assert _outputs("split", [X[:, :, ::2, ::2]])[0] == "strided"
    assert stream_plan(2049) == (256, 2)
    assert stream_plan(33) == (32, 1)
    assert stream_plan(129) == (32, 1)
    assert stream_plan(130) == (64, 1)
    assert stream_plan(1) == (32, 1)
    # the CPU path keeps the layout of rfft spectra (PyTorch's
    # elementwise ops follow their inputs' layout)
    A, B = _spectra(16, 2)
    g0, g1 = _filters(A.shape[2])
    assert iswt_merge.spec_merge(A, B, g0, g1, 2).stride(2) == 1


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------

# csrc/q2c_pack.cu: a block's threads; the vector instantiation's slots a
# thread (Q_T apart)
Q_T, Q_U = 256, 2
ORIENTS = ((2, 3), (1, 4))
ORIENTS3 = ((0, 5), (2, 3), (1, 4))


def _bands(N, C, m, k, o_dim=2, ri_dim=-1, dtype=torch.float32, offset=0):
    """(bands as the wrapper takes them, the tensor in its own layout):
    a NaN-filled band tensor in the (o_dim, ri_dim) layout, ``offset``
    elements into a new 16-byte aligned storage."""
    od, rd, _, _ = get_dimensions5(o_dim, ri_dim)
    shape = [N, C, m, k]
    shape.insert(od, 6)
    shape.insert(rd, 2)
    strides = torch.empty(shape).stride()
    h = _strided(shape, strides, offset, dtype)
    h.fill_(float("nan"))
    return canonical_bands(h, od, rd), h


def _group(N, C, m, k, nm, interleaved, dtype, shift=0, seed=5):
    """The group output K2 reads: composed (N, C, nm 2m, 2k) contiguous,
    or per level (N, C, nm, 2m, 2k) at unit stride along w, ``shift``
    elements into rows of 2k + 3 (rows and corners off their lines)."""
    gen = torch.Generator().manual_seed(seed)
    if not interleaved:
        return torch.randn((N, C, nm * 2 * m, 2 * k), generator=gen).to(
            dtype)
    wide = torch.randn((N, C, nm, 2 * m, 2 * k + 3), generator=gen).to(dtype)
    return _base_aligned(wide)[..., shift:shift + 2 * k]


def _q2c_ref(y, out, orients, interleaved):
    """The plain version computed in fp32 (per level: scaled by a
    multiplication by fp32(1/sqrt2), as the kernel and PyTorch on the card
    scale) and rounded once to ``out``'s dtype, written into ``out``."""
    want = torch.zeros(out.shape)
    if interleaved:
        ys = y.float() * dtcwt_fb.INV_SQRT2
        for t, (o1, o2) in enumerate(orients):
            a, b = ys[:, :, t, 0::2, 0::2], ys[:, :, t, 0::2, 1::2]
            c, d = ys[:, :, t, 1::2, 0::2], ys[:, :, t, 1::2, 1::2]
            for o, (re, im) in ((o1, (a - d, b + c)), (o2, (a + d, b - c))):
                want[:, :, o, ..., 0], want[:, :, o, ..., 1] = re, im
    else:
        quad.q2c_pack_plain(y.float(), want, orients)
    out.copy_(want.to(out.dtype))


def q2c_slots(out, k):
    """The vector instantiation's (j a slot, slots a row) for bands
    ``out`` (N, C, 6, m, k, 2) (csrc/q2c_pack.cu:vector_plan): V = 16
    bytes / one (re, im) pair, and one slot more than ceil(k / V) unless
    every row of ``out`` starts on a 16-byte line."""
    esz = out.element_size()
    V = 16 // (2 * esz)
    sn, sc, so, sh = out.stride()[:4]
    # every stride a whole number of 16-byte lines (esz a power of two)
    lines = (out.data_ptr() % 16 == 0
             and (sn | sc | so | sh) % (16 // esz) == 0)
    return V, (k - 1 + (0 if lines else V - 1)) // V + 1


def emulate_q2c_choice(y, out, orients, interleaved):
    """The instantiation K2's C entry picks (csrc/q2c_pack.cu:vector_plan):
    ``vector`` where ``out`` has re/im adjacent and w pairs adjacent,
    starts on a whole (re, im) pair, rows and planes whole pairs apart,
    ``y``'s corners run along j at unit stride (composed) or interleaved
    in pairs (per level), and a plane's offsets fit in 32 bits; else
    ``strided``."""
    nm = len(orients)
    N, C, m, k, addr, fits = quad._q2c_addr(y, nm, interleaved)
    assert fits and out.shape == (N, C, 6, m, k, 2)
    _, _, _, si, sj, oa, ob, oc, od, _ = addr
    sn, sc, so, sh, sw, sri = out.stride()
    il = sj == 2 and ob == 1 and od == oc + 1
    I32 = 2 ** 31
    _, S = q2c_slots(out, k)
    vector = (sri == 1 and sw == 2 and oa == 0 and (sj == 1 or il)
              and out.data_ptr() % (2 * out.element_size()) == 0
              and (sn | sc | so | sh) % 2 == 0
              and (m + 1) * abs(si) + 2 * k + abs(ob) + abs(oc) + abs(od)
              < I32 and (m + 1) * abs(sh) + 2 * k < I32
              and m * S < I32
              and N * C * nm * -(-m * S // (Q_T * Q_U)) < I32)
    return "vector" if vector else "strided"


def emulate_q2c_vector(y, out, orients, interleaved):
    """K2's vector instantiation (csrc/q2c_pack.cu:q2c_vector) writing
    ``out``: returns (reads of each element of y's storage, writes of each
    element of out's storage, full slots, partial slots)."""
    nm = len(orients)
    N, C, m, k, addr, _ = quad._q2c_addr(y, nm, interleaved)
    syn, syc, smem, si, sj, oa, ob, oc, od, scale = addr
    sn, sc, so, sh, sw, sri = out.stride()
    E = out.element_size()
    V, S = q2c_slots(out, k)
    per = Q_T * Q_U
    cpp = -(-m * S // per)
    blk, tid = np.divmod(np.arange(N * C * nm * cpp * Q_T), Q_T)
    pm, chunk = np.divmod(blk, cpp)
    p, t = np.divmod(pm, nm)
    n, c = np.divmod(p, C)
    ob_ = np.array(orients)[t]
    ybase = y.storage_offset() + n * syn + c * syc + t * smem
    obase = [out.storage_offset() + n * sn + c * sc + ob_[:, q] * so
             for q in (0, 1)]
    yfl, ofl = _flat(y), _flat(out)
    reads = np.zeros(yfl.numel(), np.int64)
    writes = np.zeros(ofl.numel(), np.int64)
    full_n = part_n = 0
    th, jj, ii = [], [], []
    for uu in range(Q_U):
        e = chunk * per + uu * Q_T + tid
        live = e < m * S
        i, s = np.divmod(e, S)
        r1 = obase[0] + i * sh
        h = (r1 * E % 16) // (2 * E)
        j0 = s * V - h
        full = live & (j0 >= 0) & (j0 + V <= k)
        part = live & ~full
        # a full slot's o1 store is 16-byte aligned by the anchor
        assert ((r1 + 2 * j0)[full] * E % 16 == 0).all()
        full_n += int(full.sum())
        part_n += int((part & (j0 + V > 0) & (j0 < k)).sum())
        for v in range(V):
            j = j0 + v
            ok = live & (j >= 0) & (j < k)
            # a full slot covers all of its V j, a partial one some
            assert (ok | ~full).all()
            sel = np.nonzero(ok)[0]
            th.append(sel)
            jj.append(j[sel])
            ii.append(i[sel])
    th, j, i = np.concatenate(th), np.concatenate(jj), np.concatenate(ii)
    ya = ybase[th] + i * si + j * sj
    corners = []
    for o in (oa, ob, oc, od):
        np.add.at(reads, ya + o, 1)
        corners.append(torch.mul(yfl[torch.from_numpy(ya + o)].float(),
                                 scale))
    A, B, Cc, D = corners
    for q, (re, im) in enumerate(((A - D, B + Cc), (A + D, B - Cc))):
        at = obase[q][th] + i * sh + j * sw
        for off, v in ((0, re), (sri, im)):
            np.add.at(writes, at + off, 1)
            ofl[torch.from_numpy(at + off)] = v.to(out.dtype)
    return reads, writes, full_n, part_n


Q2C_CASES = [
    # (case, m, k, interleaved, o_dim, ri_dim, out offset, y shift)
    ("composed", 3, 8, False, 2, -1, 0, 0),
    ("composed odd k", 3, 7, False, 2, -1, 0, 0),
    ("composed offset bands", 2, 6, False, 2, -1, 2, 0),
    ("composed scat layout", 3, 5, False, 1, -1, 0, 0),
    ("composed o first", 2, 9, False, 0, 5, 6, 0),
    ("per level", 3, 8, True, 2, -1, 0, 0),
    ("per level odd k", 3, 5, True, 1, -1, 0, 0),
    ("per level shifted rows", 2, 6, True, 2, -1, 4, 1),
    ("per level wide", 2, 70, True, 2, -1, 0, 2),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case,m,k,il,o_dim,ri_dim,off,shift", Q2C_CASES,
                         ids=[c[0] for c in Q2C_CASES])
def test_q2c_vector_map(case, m, k, il, o_dim, ri_dim, off, shift, dtype):
    """The vector instantiation reads every corner once and writes every
    (re, im) of the members' orientations once, bit for bit the plain
    version rounded once."""
    N, C = 2, 3
    orients = ORIENTS3 if il else ORIENTS
    y = _group(N, C, m, k, len(orients), il, dtype, shift)
    out, h = _bands(N, C, m, k, o_dim, ri_dim, dtype, off)
    assert emulate_q2c_choice(y, out, orients, il) == "vector"
    reads, writes, full, part = emulate_q2c_vector(y, out, orients, il)
    assert full > 0
    E = y.element_size()
    if k % (16 // (2 * E)) or off * E % 16:
        assert part > 0          # partial first or last slots
    _once(reads, y if not il else y[:, :, :len(orients)])
    written = [o for pair in orients for o in pair]
    _once(writes, *(out[:, :, o] for o in written))
    want = _like(out, 0.0)
    _q2c_ref(y, want, orients, il)
    got = out[:, :, written]
    assert torch.equal(got.float().view(torch.int32) if dtype ==
                       torch.float32 else got.view(torch.int16),
                       want[:, :, written].float().view(torch.int32)
                       if dtype == torch.float32 else
                       want[:, :, written].view(torch.int16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("o_dim,ri_dim,want", [
    (2, -1, "vector"), (1, -1, "vector"), (0, 5, "vector"),
    (1, 3, "strided"), (4, 2, "strided"), (2, 3, "strided")])
def test_q2c_instantiation_layouts(o_dim, ri_dim, want, dtype):
    """Every o_dim / ri_dim layout: vector where re/im are adjacent and the
    w pairs adjacent, else strided; both corner layouts."""
    for il in (False, True):
        orients = ORIENTS3 if il else ORIENTS
        y = _group(2, 3, 3, 6, len(orients), il, dtype)
        out, _ = _bands(2, 3, 3, 6, o_dim, ri_dim, dtype)
        assert emulate_q2c_choice(y, out, orients, il) == want


def test_q2c_instantiation_edges():
    """Bands that start off a whole (re, im) pair, per-level corners not at
    unit stride along w, and a group that does not fit: strided, strided,
    does not fit the wrapper's addressing; slots a row with and without
    aligned rows."""
    y = _group(2, 3, 3, 6, 2, False, torch.float32)
    out, _ = _bands(2, 3, 3, 6, offset=1)
    assert emulate_q2c_choice(y, out, ORIENTS, False) == "strided"
    yi = _group(2, 3, 3, 6, 3, True, torch.float32).transpose(3, 4) \
        .contiguous().transpose(3, 4)
    out, _ = _bands(2, 3, 3, 6)
    assert emulate_q2c_choice(yi, out, ORIENTS3, True) == "strided"
    assert not quad._q2c_addr(y[..., :-2], 2, False)[-1]
    assert not quad._q2c_addr(y.transpose(2, 3), 2, False)[-1]
    assert q2c_slots(_bands(1, 1, 2, 8)[0], 8) == (2, 4)
    assert q2c_slots(_bands(1, 1, 2, 7)[0], 7) == (2, 4)
    assert q2c_slots(_bands(1, 1, 2, 8, offset=2)[0], 8) == (2, 5)
    assert q2c_slots(_bands(1, 1, 2, 8, dtype=torch.bfloat16)[0],
                     8) == (4, 2)
    assert q2c_slots(_bands(1, 1, 2, 6, dtype=torch.bfloat16)[0],
                     6) == (4, 3)
