"""Kernels K4, K5 and K18: the scattering layers' smooth magnitude, its
backward and that backward's backward (``csrc/scat_mag.cu``).  The
autograd entry point over them is ``transforms/scatternet.py:smooth_mag``.

K4 :func:`scat_mag_fwd` replaces the JAX package's
``transforms/scatternet.py:smooth_mag`` and ``_combined_mag``; K5
:func:`scat_mag_bwd` replaces their JAX autodiff, and K18
:func:`scat_mag_bwd2` the JAX autodiff of that (second-order gradients).
All three read a level's bands as a (N, 6, C, h, w, 2) view, and all are
bound by bytes.  Each wrapper picks one of two instantiations
(:func:`mag_instantiation`) and counts it in ``instantiations``:
``vector``, 16-byte loads of the layout the scattering pyramids write
(re/im adjacent, each plane's rows one run), or ``strided``, any other
view through its strides.  Each kernel has its plain PyTorch version
here, which CPU tensors take.
"""
from __future__ import annotations

import torch

from pytorch_wavelets_tpu_torch.ops import _cuda

__all__ = ["scat_mag_fwd", "scat_mag_fwd_plain", "scat_mag_bwd",
           "scat_mag_bwd_plain", "scat_mag_bwd2", "scat_mag_bwd2_plain",
           "mag_instantiation", "MAG_INSTS",
           "MAG_THREADS", "MAG_PAIRS", "MAG_MAX_COMBINE"]

# csrc/scat_mag.cu: a block's threads; the vector instantiation's float4s
# of the bands a thread (two coefficients each, MAG_THREADS apart) and the
# most channels it sums in registers with ``combine``
MAG_THREADS, MAG_PAIRS, MAG_MAX_COMBINE = 256, 2, 4
# the C entries' instantiation codes (csrc/scat_mag.cu:MagInst)
MAG_INSTS = {"vector": 0, "strided": 1}
_I32 = 2 ** 30   # the vector instantiation's 32-bit sizes


def _sum_sq(h, combine):
    re, im = h[..., 0], h[..., 1]
    s = re * re + im * im
    return s.sum(dim=2, keepdim=True) if combine else s


def scat_mag_fwd_plain(h, bias, combine=False):
    """Plain PyTorch version of :func:`scat_mag_fwd` (the JAX formula)."""
    return torch.sqrt(_sum_sq(h, combine) + bias * bias) - bias


def scat_mag_bwd_plain(h, g, bias, combine=False):
    """Plain PyTorch version of :func:`scat_mag_bwd`."""
    den = torch.sqrt(_sum_sq(h, combine) + bias * bias)
    return torch.stack((g * h[..., 0] / den, g * h[..., 1] / den), dim=-1)


def scat_mag_bwd2_plain(h, g, u, bias, combine=False):
    """Plain PyTorch version of :func:`scat_mag_bwd2`."""
    den = torch.sqrt(_sum_sq(h, combine) + bias * bias)
    t = u[..., 0] * h[..., 0] + u[..., 1] * h[..., 1]
    if combine:
        t = t.sum(dim=2, keepdim=True)
    dg = t / den
    q, a = dg / den, g / den
    return dg, torch.stack(((u[..., 0] - h[..., 0] * q) * a,
                            (u[..., 1] - h[..., 1] * q) * a), dim=-1)


def _unit_planes(t):
    """Every (n, o, c) plane of the (N, 6, C, h, w, 2) ``t`` one run of
    2 h w floats (re/im adjacent, rows contiguous) starting 8-byte
    aligned: the vector walks read the bands, and K18's its cotangent
    ``u``, so."""
    N, _, C, hh, ww, _ = t.shape
    sn, so, sc, sh, sw, sri = t.stride()
    return (sri == 1 and (ww == 1 or sw == 2) and (hh == 1 or sh == 2 * ww)
            and t.data_ptr() % 8 == 0
            and all(s % 2 == 0 for s, n in zip((sn, so, sc), (N, 6, C))
                    if n > 1))


def mag_instantiation(h, combine, g=None, u=None):
    """K4's (given the cotangent ``g``, K5's, and given also the cotangent
    ``u`` of K5's output, K18's) instantiation for the bands ``h``:
    ``vector`` where every (n, o, c) plane of ``h`` is one run of 2 h w
    floats (re/im adjacent, rows contiguous) starting 8-byte aligned, with
    ``combine`` at most MAG_MAX_COMBINE channels a multiple of 16 bytes
    apart, each plane of ``g`` one run of h w floats, and each plane of
    ``u`` laid out as those of ``h``; else ``strided``.  Raises on bands
    that are not (N, 6, C, h, w, 2) or cotangents that do not fit them,
    which none takes."""
    kernel = ("scat_mag_fwd" if g is None else "scat_mag_bwd" if u is None
              else "scat_mag_bwd2")
    if h.ndim != 6 or h.shape[1] != 6 or h.shape[5] != 2:
        raise ValueError(f"{kernel}: bands {tuple(h.shape)} are not "
                         f"(N, 6, C, h, w, 2)")
    N, _, C, hh, ww, _ = h.shape
    if g is not None and tuple(g.shape) != (N, 6, 1 if combine else C, hh,
                                            ww):
        raise ValueError(f"{kernel}: cotangent {tuple(g.shape)} does "
                         f"not fit bands {tuple(h.shape)}")
    if u is not None and u.shape != h.shape:
        raise ValueError(f"{kernel}: cotangent {tuple(u.shape)} does not "
                         f"fit bands {tuple(h.shape)}")
    sc = h.stride(2)
    nc, cout = (C, 1) if combine else (1, C)
    P = hh * ww
    per = MAG_THREADS * MAG_PAIRS
    chunks = max(1, -(-(P // 2) // per))
    vector = (_unit_planes(h)
              and (nc == 1 or (1 < nc <= MAG_MAX_COMBINE and sc % 4 == 0))
              and 2 * P < _I32
              and N * 6 * cout * chunks < _I32)
    if g is not None:
        vector = (vector and (ww == 1 or g.stride(4) == 1)
                  and (hh == 1 or g.stride(3) == ww))
    if u is not None:
        vector = vector and _unit_planes(u)
    return "vector" if vector else "strided"


def _fwd_launch(h, bias, combine, inst):
    """Launch K4's ``inst`` on CUDA bands; the contiguous output."""
    N, _, C, hh, ww, _ = h.shape
    r = torch.empty((N, 6, 1 if combine else C, hh, ww), device=h.device,
                    dtype=torch.float32)
    lib = _cuda.library("scat_mag")
    _cuda.check(lib, "scat_mag_fwd", lib.scat_mag_fwd(
        h.data_ptr(), r.data_ptr(), N, C, hh, ww, int(combine), *h.stride(),
        bias * bias, bias, MAG_INSTS[inst], _cuda.stream_of(h)))
    return r


def _bwd_launch(h, g, bias, combine, inst):
    """Launch K5's ``inst`` on CUDA bands and cotangent; the contiguous
    band gradient."""
    N, _, C, hh, ww, _ = h.shape
    dh = torch.empty((N, 6, C, hh, ww, 2), device=h.device,
                     dtype=torch.float32)
    lib = _cuda.library("scat_mag")
    _cuda.check(lib, "scat_mag_bwd", lib.scat_mag_bwd(
        h.data_ptr(), g.data_ptr(), dh.data_ptr(), N, C, hh, ww,
        int(combine), *h.stride(), *g.stride(), bias * bias,
        MAG_INSTS[inst], _cuda.stream_of(h)))
    return dh


def _bwd2_launch(h, g, u, bias, combine, inst):
    """Launch K18's ``inst`` on CUDA bands and cotangents; the contiguous
    (dg, dh')."""
    N, _, C, hh, ww, _ = h.shape
    dg = torch.empty((N, 6, 1 if combine else C, hh, ww), device=h.device,
                     dtype=torch.float32)
    dh = torch.empty((N, 6, C, hh, ww, 2), device=h.device,
                     dtype=torch.float32)
    lib = _cuda.library("scat_mag")
    _cuda.check(lib, "scat_mag_bwd2", lib.scat_mag_bwd2(
        h.data_ptr(), g.data_ptr(), u.data_ptr(), dg.data_ptr(),
        dh.data_ptr(), N, C, hh, ww, int(combine), *h.stride(), *g.stride(),
        *u.stride(), bias * bias, MAG_INSTS[inst], _cuda.stream_of(h)))
    return dg, dh


@_cuda.via_fp32
def scat_mag_fwd(h, bias, combine=False):
    """r = sqrt(re^2 + im^2 + bias^2) - bias of the (N, 6, C, h, w, 2)
    bands ``h``, as a contiguous (N, 6, C, h, w) tensor; with ``combine``
    re^2 + im^2 is summed over C first and r is (N, 6, 1, h, w).
    CPU tensors take :func:`scat_mag_fwd_plain`; CUDA tensors launch K4 in
    the instantiation :func:`mag_instantiation` picks.
    """
    if h.device.type == "cpu":
        return scat_mag_fwd_plain(h, bias, combine)
    _cuda.check_inputs("scat_mag_fwd", h)
    inst = mag_instantiation(h, combine)
    r = _fwd_launch(h, bias, combine, inst)
    scat_mag_fwd.launches += 1
    scat_mag_fwd.instantiations[inst] += 1
    return r


@_cuda.via_fp32
def scat_mag_bwd(h, g, bias, combine=False):
    """The bands' gradient g * (re, im) / sqrt(re^2 + im^2 + bias^2) (the
    root summed over C with ``combine``, and g broadcast over C), for the
    output cotangent ``g`` (any strides), as a contiguous
    (N, 6, C, h, w, 2) tensor.  CPU tensors take
    :func:`scat_mag_bwd_plain`; CUDA tensors launch K5 in the
    instantiation :func:`mag_instantiation` picks.
    """
    if h.device.type == "cpu":
        return scat_mag_bwd_plain(h, g, bias, combine)
    _cuda.check_inputs("scat_mag_bwd", h, g)
    inst = mag_instantiation(h, combine, g)
    dh = _bwd_launch(h, g, bias, combine, inst)
    scat_mag_bwd.launches += 1
    scat_mag_bwd.instantiations[inst] += 1
    return dh


@_cuda.via_fp32
def scat_mag_bwd2(h, g, u, bias, combine=False):
    """:func:`scat_mag_bwd` as a function of (h, g), differentiated for the
    cotangent ``u`` of its output (any strides, the bands' shape): with
    s = sqrt(re^2 + im^2 + bias^2) (summed over C with ``combine``) and
    t = the sum of u * h over (re, im) (and C),
    dg = t / s and dh' = g (u - h t / s^2) / s, as a contiguous
    (N, 6, C or 1, h, w) and a contiguous (N, 6, C, h, w, 2) tensor.  At
    bias 0 a zero coefficient gives 0/0 = NaN, as :func:`scat_mag_bwd`
    does there.  CPU tensors take :func:`scat_mag_bwd2_plain`; CUDA
    tensors launch K18 in the instantiation :func:`mag_instantiation`
    picks.
    """
    if h.device.type == "cpu":
        return scat_mag_bwd2_plain(h, g, u, bias, combine)
    _cuda.check_inputs("scat_mag_bwd2", h, g, u)
    inst = mag_instantiation(h, combine, g, u)
    out = _bwd2_launch(h, g, u, bias, combine, inst)
    scat_mag_bwd2.launches += 1
    scat_mag_bwd2.instantiations[inst] += 1
    return out


scat_mag_fwd.launches = 0
scat_mag_bwd.launches = 0
scat_mag_bwd2.launches = 0
scat_mag_fwd.instantiations = dict.fromkeys(MAG_INSTS, 0)
scat_mag_bwd.instantiations = dict.fromkeys(MAG_INSTS, 0)
scat_mag_bwd2.instantiations = dict.fromkeys(MAG_INSTS, 0)
