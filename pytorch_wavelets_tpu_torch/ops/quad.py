"""Kernels K2 and K3: the quad <-> complex corner maps of the composed
DTCWT pyramids (``ops/fused_dtcwt.py``), as single passes over the
bandpass tensor in whatever o_dim/ri_dim layout it has.

- K2 :func:`q2c_pack` (``csrc/q2c_pack.cu``) replaces the JAX package's
  ``ops/fused_dtcwt.py:_q2c_epilogue`` and the stacks around it.
- K3 :func:`c2q_unpack` (``csrc/c2q_unpack.cu``) replaces the combine and
  concatenations of its ``synthesis_pyramid``.

Both are pure elementwise gathers bound by bytes.  Each has its plain
PyTorch version here (the JAX slicing), which CPU tensors take.
"""
from __future__ import annotations

import torch

from pytorch_wavelets_tpu_torch.ops import _cuda

__all__ = ["q2c_pack", "q2c_pack_plain", "c2q_unpack", "c2q_unpack_plain"]


def _pack_orients(orients):
    code = 0
    for t, (o1, o2) in enumerate(orients):
        code |= (o1 | (o2 << 4)) << (8 * t)
    return code


def q2c_pack_plain(y, out, orients):
    """Plain PyTorch version of :func:`q2c_pack` (the JAX slicing)."""
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


def q2c_pack(y, out, orients):
    """Write one subband group's butterfly into its bandpass tensor.

    y: (N, C, nm*2m, 2k) stage-2 output of the group, member t's corner
    quadrants at rows [2mt, 2mt + 2m); out: the level's bands as a
    (N, C, 6, m, k, 2) view (``fused_dtcwt.canonical_bands``), written in place
    at each member's orientation pair (o1, o2) of ``orients``.
    CPU tensors take :func:`q2c_pack_plain`; CUDA tensors launch K2.
    """
    if y.device.type == "cpu":
        return q2c_pack_plain(y, out, orients)
    _cuda.check_inputs("q2c_pack", y, out)
    N, C, rows, k2 = y.shape
    nm = len(orients)
    m, k = rows // (2 * nm), k2 // 2
    if (not y.is_contiguous() or rows != 2 * m * nm or k2 != 2 * k
            or out.shape != (N, C, 6, m, k, 2)):
        raise ValueError(f"q2c_pack: group output {tuple(y.shape)} (must be "
                         f"contiguous) does not fit bands "
                         f"{tuple(out.shape)} for {nm} members")
    lib = _cuda.library("q2c_pack")
    _cuda.check(lib, "q2c_pack", lib.q2c_pack(
        y.data_ptr(), out.data_ptr(), N * C, C, m, k, nm,
        _pack_orients(orients), rows * k2, *out.stride(),
        _cuda.stream_of(y)))
    q2c_pack.launches += 1


def c2q_unpack_plain(h, orients):
    """Plain PyTorch version of :func:`c2q_unpack` (the JAX combine)."""
    r, i = h[..., 0], h[..., 1]
    xqs = []
    for o1, o2 in orients:
        w1r, w1i, w2r, w2i = r[:, :, o1], i[:, :, o1], r[:, :, o2], i[:, :, o2]
        top = torch.cat([w1r + w2r, w1i + w2i], dim=-1)
        bot = torch.cat([w1i - w2i, w2r - w1r], dim=-1)
        xqs.append(torch.cat([top, bot], dim=-2))
    return torch.cat(xqs, dim=-2) if len(xqs) > 1 else xqs[0]


def c2q_unpack(h, orients):
    """Combine each member's orientation pair (o1, o2) of ``orients`` into
    its quadrant planes: h is a level's bands as a (N, C, 6, h, w, 2) view
    (:func:`canonical_bands`, read through its strides); returns the
    contiguous (N, C, nm*2h, 2w) group input of the row stage.
    CPU tensors take :func:`c2q_unpack_plain`; CUDA tensors launch K3.
    """
    if h.device.type == "cpu":
        return c2q_unpack_plain(h, orients)
    _cuda.check_inputs("c2q_unpack", h)
    N, C, no, hh, ww, nri = h.shape
    if (no, nri) != (6, 2):
        raise ValueError(f"c2q_unpack: bands {tuple(h.shape)} are not "
                         f"(N, C, 6, h, w, 2)")
    nm = len(orients)
    xq = torch.empty((N, C, nm * 2 * hh, 2 * ww), device=h.device,
                     dtype=torch.float32)
    lib = _cuda.library("c2q_unpack")
    _cuda.check(lib, "c2q_unpack", lib.c2q_unpack(
        h.data_ptr(), xq.data_ptr(), N * C, C, hh, ww, nm,
        _pack_orients(orients), *h.stride(), _cuda.stream_of(h)))
    c2q_unpack.launches += 1
    return xq


q2c_pack.launches = 0
c2q_unpack.launches = 0
