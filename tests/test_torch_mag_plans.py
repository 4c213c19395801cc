"""K4/K5's choice of instantiation and the vector instantiation's map,
emulated in numpy exactly as ``csrc/scat_mag.cu`` (``mag_fwd_vector`` /
``mag_bwd_vector``) walks a view: block -> plane and chunk, thread ->
coefficient pairs (one float4 of the bands each), the plane's head and
tail alone.  Every coefficient must be read and written exactly once,
every float4 load 16-byte aligned, and the emulated kernels must equal
their plain versions (``ops/scat_mag.py``), in float32, on the CPU."""
import numpy as np
import pytest
import torch

from pytorch_wavelets_tpu_torch.ops import scat_mag

# one thread, as the port's other CPU test files: the plain versions'
# elementwise ops on a few thousand values cost more in thread start-up
torch.set_num_threads(1)

MAG_TOL = dict(rtol=3e-7, atol=1e-7)   # IEEE-rounded ops in the same order
T, U = scat_mag.MAG_THREADS, scat_mag.MAG_PAIRS


def _view(shape, strides=None, offset=0, seed=0):
    """(flat float32 buffer, a view of it): ``strides`` None is the
    contiguous layout; ``offset`` in floats.  The buffer's element 0 is
    16-byte aligned, so the view's alignment is its offsets'."""
    if strides is None:
        strides = torch.empty(shape).stride()
    size = offset + 1 + sum((n - 1) * s for n, s in zip(shape, strides))
    buf = np.random.RandomState(seed).randn(size).astype(np.float32)
    assert buf.ctypes.data % 16 == 0
    return buf, torch.as_strided(torch.from_numpy(buf), shape, strides,
                                 offset)


def _indices(t):
    """The storage index of every element of view ``t``, in its order."""
    idx = np.full(t.shape, t.storage_offset(), np.int64)
    for d, s in enumerate(t.stride()):
        shape = [1] * t.ndim
        shape[d] = t.shape[d]
        idx = idx + np.arange(t.shape[d]).reshape(shape) * s
    return idx


def _band(n=2, c=3, hh=5, ww=8, seed=0):
    return _view((n, 6, c, hh, ww, 2), seed=seed)[1]


def _wide_slice(seed=0):
    """A re/im-last slice of a wider tensor (stride 3 along w)."""
    return _view((2, 6, 3, 9, 11, 3), seed=seed)[1][..., 1:10, :2]


def _offset(floats, seed=0):
    shape = (2, 6, 3, 5, 8, 2)
    return _view(shape, torch.empty(shape).stride(), floats, seed)[1]


def _cat_slice(n, c, hh, ww, seed=1):
    """The cotangent as ``torch.cat``'s backward hands it to K5: channels
    7C to 13C of a wider (N, 49C, h, w) gradient, viewed as (N, 6, C, h,
    w): each plane one run, planes 49C h w apart, offset 7C h w floats."""
    _, G = _view((n, 49 * c, hh, ww), seed=seed)
    return G[:, 7 * c:13 * c].view(n, 6, c, hh, ww)


CHOICES = [
    # (case, bands, combine, cotangent or None, instantiation)
    ("contiguous", lambda: _band(), False, None, "vector"),
    ("contiguous bwd", lambda: _band(), False,
     lambda: _view((2, 6, 3, 5, 8))[1], "vector"),
    ("combine C=3", lambda: _band(), True, None, "vector"),
    ("combine C=3 bwd", lambda: _band(), True,
     lambda: _view((2, 6, 1, 5, 8))[1], "vector"),
    ("combine C=5", lambda: _band(c=5), True, None, "strided"),
    ("re/im-last slice", _wide_slice, False, None, "strided"),
    ("transposed", lambda: _band().transpose(3, 4), False, None, "strided"),
    ("offset 4 bytes", lambda: _offset(1), False, None, "strided"),
    ("offset 8 bytes", lambda: _offset(2), False, None, "vector"),
    ("offset 16 bytes", lambda: _offset(4), True, None, "vector"),
    ("offset 8 bytes combine", lambda: _offset(2), True, None, "vector"),
    ("odd width", lambda: _band(hh=5, ww=7), False, None, "vector"),
    ("odd width combine", lambda: _band(hh=5, ww=7), True, None, "strided"),
    ("width 1", lambda: _band(hh=4, ww=1), False, None, "vector"),
    ("width 1 combine", lambda: _band(hh=4, ww=1), True, None, "vector"),
    ("cat slice cotangent", lambda: _band(hh=4, ww=6), False,
     lambda: _cat_slice(2, 3, 4, 6), "vector"),
    ("strided cotangent", lambda: _band(), False,
     lambda: _view((2, 6, 3, 5, 16))[1][..., ::2], "strided"),
    ("transposed cotangent", lambda: _band(hh=4, ww=4), False,
     lambda: _view((2, 6, 3, 4, 4))[1].transpose(3, 4), "strided"),
]


@pytest.mark.parametrize("case,bands,combine,cot,want", CHOICES,
                         ids=[c[0] for c in CHOICES])
def test_mag_instantiation(case, bands, combine, cot, want):
    """The wrapper's chooser on the views the edge cases take."""
    h = bands()
    g = cot() if cot else None
    assert scat_mag.mag_instantiation(h, combine, g) == want


def test_mag_instantiation_refuses():
    """Bands or a cotangent of the wrong shape: neither instantiation."""
    with pytest.raises(ValueError, match="not"):
        scat_mag.mag_instantiation(torch.zeros(2, 5, 3, 4, 4, 2), False)
    with pytest.raises(ValueError, match="does not fit"):
        scat_mag.mag_instantiation(torch.zeros(2, 6, 3, 4, 4, 2), True,
                                   torch.zeros(2, 6, 3, 4, 4))


def _storage(t):
    """The whole float32 storage under view ``t``, as numpy."""
    n = t.untyped_storage().nbytes() // 4
    return torch.as_strided(t, (n,), (1,), 0).numpy()


def emulate_vector(h, bias, combine, g=None):
    """K4 (``g`` None) or K5 by the vector instantiation's map and its
    arithmetic in float32 (csrc/scat_mag.cu).  Returns (result, reads of
    each element of h, of g, writes of each element of the result)."""
    N, _, C, hh, ww, _ = h.shape
    hbuf = _storage(h)
    sn, so, sc = h.stride()[:3]
    nc, cout = (C, 1) if combine else (1, C)
    P = hh * ww
    cpp = max(1, -(-(P // 2) // (T * U)))
    blk = np.arange(N * 6 * cout * cpp)
    p, chunk = np.divmod(blk, cpp)
    q_, c = np.divmod(p, cout)
    n, o = np.divmod(q_, 6)
    hoff = h.storage_offset() + n * sn + o * so + c * sc
    assert (hoff % 2 == 0).all()          # 8-byte aligned planes
    head = (hoff % 4 != 0).astype(np.int64)
    pairs = (P - head) // 2
    # thread t's pair u: q = chunk T U + u T + t, coefficients head + 2q, +1
    q = (chunk[:, None, None] * T * U + np.arange(U)[None, :, None] * T
         + np.arange(T)[None, None, :])
    live = q < pairs[:, None, None]
    for t in range(nc):                    # the float4 loads' alignment
        addr = (hoff + t * sc + 2 * head)[:, None, None] + 4 * q
        assert (addr[live] % 4 == 0).all()
    bq, _, _ = np.nonzero(live)
    k0 = head[bq] + 2 * q[live]
    # the head and the tail: thread 0 of a plane's first chunk, alone
    first = np.nonzero(chunk == 0)[0]
    hb_ = first[head[first] == 1]
    tb = first[(P - head[first]) % 2 == 1]
    b_all = np.concatenate([bq, bq, hb_, tb])
    k_all = np.concatenate([k0, k0 + 1, np.zeros(len(hb_), np.int64),
                            np.full(len(tb), P - 1)])
    reads = np.zeros(hbuf.size, np.int64)
    b2, b = np.float32(bias * bias), np.float32(bias)
    s = np.zeros(len(b_all), np.float32)
    vals = []
    for t in range(nc):                    # the sum in channel order
        at = hoff[b_all] + t * sc + 2 * k_all
        np.add.at(reads, at, 1)
        np.add.at(reads, at + 1, 1)
        re, im = hbuf[at], hbuf[at + 1]
        s = s + (re * re + im * im)
        vals.append((re, im))
    den = np.sqrt(s + b2)
    pb = p[b_all]
    if g is None:
        out = np.zeros(N * 6 * cout * P, np.float32)
        writes = np.zeros(out.size, np.int64)
        np.add.at(writes, pb * P + k_all, 1)
        out[pb * P + k_all] = den - b
        return (torch.from_numpy(out.reshape(N, 6, cout, hh, ww)), reads,
                None, writes)
    gbuf = _storage(g)
    gn, go, gc = g.stride()[:3]
    gat = (g.storage_offset() + n * gn + o * go + c * gc)[b_all] + k_all
    greads = np.zeros(gbuf.size, np.int64)
    np.add.at(greads, gat, 1)
    gv = gbuf[gat]
    out = np.zeros(N * 6 * C * P * 2, np.float32)
    writes = np.zeros(out.size, np.int64)
    with np.errstate(invalid="ignore", divide="ignore"):
        for t, (re, im) in enumerate(vals):
            at = 2 * ((pb * nc + t) * P + k_all)
            np.add.at(writes, at, 1)
            np.add.at(writes, at + 1, 1)
            out[at] = (gv * re) / den
            out[at + 1] = (gv * im) / den
    return (torch.from_numpy(out.reshape(N, 6, C, hh, ww, 2)), reads,
            greads, writes)


def _once(counts, t):
    """Every element of view ``t`` counted once, and nothing else."""
    idx = _indices(t).ravel()
    assert (counts[idx] == 1).all()
    assert counts.sum() == idx.size


EMULATED = [
    # (case, bands, combine, cotangent maker (N, cout, hh, ww) or None)
    ("contiguous", lambda: _band(), False, None),
    ("combine C=3", lambda: _band(), True, None),
    ("combine C=2 offset 16 bytes", lambda: _offset(4)[:, :, :2], True,
     None),
    ("offset 8 bytes", lambda: _offset(2), False, None),
    ("offset 8 bytes combine", lambda: _offset(2), True, None),
    ("odd width", lambda: _band(hh=5, ww=7), False, None),
    ("width 1", lambda: _band(hh=3, ww=1), False, None),
    ("one coefficient", lambda: _band(n=1, c=2, hh=1, ww=1), False, None),
    ("two chunks", lambda: _band(n=1, c=1, hh=40, ww=40), False, None),
    ("two chunks odd", lambda: _band(n=1, c=2, hh=33, ww=35), False, None),
    ("cat slice cotangent", lambda: _band(hh=4, ww=6), False, "cat"),
    ("cat slice cotangent odd", lambda: _band(hh=3, ww=5), False, "cat"),
]


@pytest.mark.parametrize("bias", [1e-2, 0.0])
@pytest.mark.parametrize("case,bands,combine,cot", EMULATED,
                         ids=[c[0] for c in EMULATED])
def test_vector_map(case, bands, combine, cot, bias):
    """The vector instantiation reads every coefficient once and writes
    every output once, and the emulated K4/K5 equal the plain versions
    (b = 0: zero coefficients, 0 forward and NaN backward)."""
    h = bands()
    h[0, 0, :, 0, 0] = 0   # a zero coefficient in every channel
    N, _, C, hh, ww, _ = h.shape
    cout = 1 if combine else C
    if cot == "cat":
        g = _cat_slice(N, cout, hh, ww)
    else:
        g = _view((N, 6, cout, hh, ww), seed=1)[1]
    assert scat_mag.mag_instantiation(h, combine, g) == "vector"
    r, reads, _, writes = emulate_vector(h, bias, combine)
    _once(reads, h)
    assert (writes == 1).all()
    assert torch.allclose(r, scat_mag.scat_mag_fwd_plain(h, bias, combine),
                          **MAG_TOL)
    dh, reads, greads, writes = emulate_vector(h, bias, combine, g)
    _once(reads, h)
    _once(greads, g)
    assert (writes == 1).all()
    want = scat_mag.scat_mag_bwd_plain(h, g, bias, combine)
    assert torch.allclose(dh, want, equal_nan=True, **MAG_TOL)
    assert bool(torch.isnan(dh).any()) == (bias == 0.0)
