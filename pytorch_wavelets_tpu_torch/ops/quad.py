"""Kernels K2 and K3: the quad <-> complex corner maps of the DTCWT, as
single passes over the bandpass tensor in whatever o_dim/ri_dim layout
it has, for the composed pyramids (``ops/fused_dtcwt.py``) and the
per-level path (``transforms/dtcwt.py``, ``interleaved=True``).

- K2 :func:`q2c_pack` (``csrc/q2c_pack.cu``) replaces the JAX package's
  ``ops/fused_dtcwt.py:_q2c_epilogue`` and the stacks around it, and its
  per-level ``ops/dtcwt_fb.py:q2c`` with the stacks of
  ``highs_to_orientations``.
- K3 :func:`c2q_unpack` (``csrc/c2q_unpack.cu``) replaces the combine and
  concatenations of its ``synthesis_pyramid``, and its per-level
  ``c2q`` as ``orientations_to_highs`` uses it.

Both are pure elementwise gathers bound by bytes, on fp32 or bf16 (both
tensors of one dtype; bf16 computed in fp32 and rounded once as it is
stored, ``csrc/elem.cuh``).  Each has its plain
PyTorch version here (the JAX slicing; per level ``ops/dtcwt_fb.py:q2c``
/ ``c2q``), which CPU tensors take.  Each C entry picks one of two
instantiations and returns it, and the wrapper counts it in
``instantiations``: ``vector``, 16-byte stores (K2) or loads (K3) of the
bands' default layout (re/im adjacent, w pairs adjacent) in slots
anchored on their 16-byte lines (``csrc/quad_slots.cuh``), or
``strided``, any other layout through its strides.
"""
from __future__ import annotations

import ctypes

import torch

from pytorch_wavelets_tpu_torch.ops import _cuda
from pytorch_wavelets_tpu_torch.ops.dtcwt_fb import INV_SQRT2, c2q, q2c

__all__ = ["q2c_pack", "q2c_pack_plain", "c2q_unpack", "c2q_unpack_plain",
           "Q2C_INSTS"]

_DTYPES = (torch.float32, torch.bfloat16)
# the C entries' instantiation codes (csrc/quad_slots.cuh:QInst)
Q2C_INSTS = ("vector", "strided")


def _pack_orients(orients):
    code = 0
    for t, (o1, o2) in enumerate(orients):
        code |= (o1 | (o2 << 4)) << (8 * t)
    return code


def q2c_pack_plain(y, out, orients, interleaved=False):
    """Plain PyTorch version of :func:`q2c_pack` (the JAX slicing)."""
    if interleaved:
        for t, (o1, o2) in enumerate(orients):
            (r1, i1), (r2, i2) = q2c(y[:, :, t])
            out[:, :, o1, :, :, 0] = r1
            out[:, :, o1, :, :, 1] = i1
            out[:, :, o2, :, :, 0] = r2
            out[:, :, o2, :, :, 1] = i2
        return
    nm = len(orients)
    m, k = y.shape[2] // (2 * nm), y.shape[3] // 2
    for t, (o1, o2) in enumerate(orients):
        r = 2 * m * t
        a, b = y[:, :, r:r + m, :k], y[:, :, r:r + m, k:]
        c, d = y[:, :, r + m:r + 2 * m, :k], y[:, :, r + m:r + 2 * m, k:]
        out[:, :, o1, :, :, 0] = a - d
        out[:, :, o1, :, :, 1] = b + c
        out[:, :, o2, :, :, 0] = a + d
        out[:, :, o2, :, :, 1] = b - c


def _q2c_addr(y, nm, interleaved):
    """(N, C, m, k, the C entry's input addressing, whether ``y`` fits
    the kernel): (syn, syc, smem, si, sj, oa, ob, oc, od, scale)."""
    if interleaved:
        N, C, nmy, m2, k2 = y.shape
        m, k = m2 // 2, k2 // 2
        s0, s1, s2, s3, s4 = y.stride()
        addr = (s0, s1, s2, 2 * s3, 2 * s4, 0, s4, s3, s3 + s4, INV_SQRT2)
        fits = nmy == nm and m2 == 2 * m and k2 == 2 * k
    else:
        N, C, rows, k2 = y.shape
        m, k = rows // (2 * nm), k2 // 2
        addr = (C * rows * k2, rows * k2, 2 * m * k2, k2, 1, 0, k, m * k2,
                m * k2 + k, 1.0)
        fits = y.is_contiguous() and rows == 2 * m * nm and k2 == 2 * k
    return N, C, m, k, addr, fits


def q2c_pack(y, out, orients, interleaved=False):
    """Write one subband group's butterfly into its bandpass tensor.

    y: (N, C, nm*2m, 2k) stage-2 output of the group, member t's corner
    quadrants at rows [2mt, 2mt + 2m); or, with ``interleaved`` (the
    per-level path), (N, C, nm, 2m, 2k) filtered planes read through
    their strides, member t's corners interleaved as the JAX ``q2c``
    takes them, its 1/sqrt2 applied here.  out: the level's bands as a
    (N, C, 6, m, k, 2) view (``fused_dtcwt.canonical_bands``), written in
    place at each member's orientation pair (o1, o2) of ``orients``.
    CPU tensors take :func:`q2c_pack_plain`; CUDA tensors launch K2.
    """
    if y.device.type == "cpu":
        return q2c_pack_plain(y, out, orients, interleaved)
    _cuda.check_inputs("q2c_pack", y, out, dtypes=_DTYPES)
    nm = len(orients)
    N, C, m, k, addr, fits = _q2c_addr(y, nm, interleaved)
    if not fits or out.shape != (N, C, 6, m, k, 2):
        raise ValueError(f"q2c_pack: group output {tuple(y.shape)} does not "
                         f"fit bands {tuple(out.shape)} for {nm} members "
                         f"(interleaved={interleaved}; even sizes, and "
                         f"contiguous when not interleaved)")
    if out.numel() == 0:
        return
    lib = _cuda.library("q2c_pack")
    inst = ctypes.c_int(-1)
    _cuda.check(lib, "q2c_pack", lib.q2c_pack(
        y.data_ptr(), out.data_ptr(), N * C, C, m, k, nm,
        _pack_orients(orients), *addr, *out.stride(),
        int(y.dtype == torch.bfloat16), ctypes.addressof(inst),
        _cuda.stream_of(y)))
    q2c_pack.launches += 1
    q2c_pack.instantiations[Q2C_INSTS[inst.value]] += 1


def c2q_unpack_plain(h, orients, interleaved=False):
    """Plain PyTorch version of :func:`c2q_unpack` (the JAX combine)."""
    r, i = h[..., 0], h[..., 1]
    if interleaved:
        return torch.stack([c2q((r[:, :, o1], i[:, :, o1]),
                                (r[:, :, o2], i[:, :, o2]))
                            for o1, o2 in orients], dim=2)
    xqs = []
    for o1, o2 in orients:
        w1r, w1i, w2r, w2i = r[:, :, o1], i[:, :, o1], r[:, :, o2], i[:, :, o2]
        top = torch.cat([w1r + w2r, w1i + w2i], dim=-1)
        bot = torch.cat([w1i - w2i, w2r - w1r], dim=-1)
        xqs.append(torch.cat([top, bot], dim=-2))
    return torch.cat(xqs, dim=-2) if len(xqs) > 1 else xqs[0]


def _c2q_addr(h, nm, interleaved):
    """(the contiguous output's shape, the C entry's output addressing:
    sxp, sxm, sxi, sxj, x1o, x2o, x3o, x4o, scale) of bands ``h``
    (N, C, 6, h, w, 2) and ``nm`` members."""
    N, C, _, hh, ww, _ = h.shape
    plane = 4 * hh * ww
    if interleaved:
        return ((N, C, nm, 2 * hh, 2 * ww),
                (nm * plane, plane, 4 * ww, 2, 0, 1, 2 * ww, 2 * ww + 1,
                 INV_SQRT2))
    return ((N, C, nm * 2 * hh, 2 * ww),
            (nm * plane, plane, 2 * ww, 1, 0, ww, 2 * hh * ww,
             2 * hh * ww + ww, 1.0))


def c2q_unpack(h, orients, interleaved=False, out=None):
    """Combine each member's orientation pair (o1, o2) of ``orients`` into
    its quadrant planes: h is a level's bands as a (N, C, 6, h, w, 2) view
    (:func:`canonical_bands`, read through its strides); returns the
    contiguous (N, C, nm*2h, 2w) group input of the row stage, or with
    ``interleaved`` (the per-level path) the contiguous (N, C, nm, 2h, 2w)
    images of the JAX ``c2q``, its 1/sqrt2 applied here; written into
    ``out`` (contiguous, of that shape) where one is given.
    CPU tensors take :func:`c2q_unpack_plain`; CUDA tensors launch K3.
    """
    nm = len(orients)
    shape, addr = _c2q_addr(h, nm, interleaved)
    if out is not None and (tuple(out.shape) != shape or out.dtype !=
                            h.dtype or not out.is_contiguous()):
        raise ValueError(f"c2q_unpack: out {tuple(out.shape)} {out.dtype} "
                         f"is not a contiguous {shape} {h.dtype} tensor")
    if h.device.type == "cpu":
        xq = c2q_unpack_plain(h, orients, interleaved)
        return xq if out is None else out.copy_(xq)
    _cuda.check_inputs("c2q_unpack", h, *([] if out is None else [out]),
                       dtypes=_DTYPES)
    N, C, no, hh, ww, nri = h.shape
    if (no, nri) != (6, 2):
        raise ValueError(f"c2q_unpack: bands {tuple(h.shape)} are not "
                         f"(N, C, 6, h, w, 2)")
    xq = torch.empty(shape, device=h.device, dtype=h.dtype) if out is None \
        else out
    if xq.numel() == 0:
        return xq
    lib = _cuda.library("c2q_unpack")
    inst = ctypes.c_int(-1)
    _cuda.check(lib, "c2q_unpack", lib.c2q_unpack(
        h.data_ptr(), xq.data_ptr(), N * C, C, hh, ww, nm,
        _pack_orients(orients), *h.stride(), *addr,
        int(h.dtype == torch.bfloat16), ctypes.addressof(inst),
        _cuda.stream_of(h)))
    c2q_unpack.launches += 1
    c2q_unpack.instantiations[Q2C_INSTS[inst.value]] += 1
    return xq


q2c_pack.launches = 0
q2c_pack.instantiations = dict.fromkeys(Q2C_INSTS, 0)
c2q_unpack.launches = 0
c2q_unpack.instantiations = dict.fromkeys(Q2C_INSTS, 0)
