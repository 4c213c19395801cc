"""Kernel K19: the on-card halves of the ring halo exchange
(``csrc/halo.cu``), for ``parallel/halo.py``.

K19 replaces the slices, flips, selects and concatenate around the two
``lax.ppermute`` rings of the JAX package's
``parallel/halo.py:halo_exchange_1d``; the rings themselves become one
``torch.distributed.batch_isend_irecv`` (not a kernel).  Three entries,
each with its plain PyTorch version here, which CPU tensors take:

- :func:`halo_pack`: the tile's last ``tail`` and first ``head`` samples
  along the axis into two contiguous blocks (the ring's send buffers);
- :func:`halo_assemble`: the (left + tile + right)-wide window, each
  halo from a received block, the flipped own edge or zeros;
- :func:`halo_fold`: its adjoint, the window cotangent's tile part plus
  the flipped 'symmetric' edge cotangents plus the received halo
  cotangents, added into the edges they came from.

A tile is an (N, C, H, W) view at any strides, fp32 or bf16; the axis is
2 (H) or 3 (W).  The copies are exact; the fold adds in fp32 in a fixed
order and rounds once, as its plain version does.
"""
from __future__ import annotations

import torch

from pytorch_wavelets_tpu_torch.ops import _cuda

__all__ = ["halo_pack", "halo_pack_plain", "halo_assemble",
           "halo_assemble_plain", "halo_fold", "halo_fold_plain", "SRC",
           "block_shape"]

_DTYPES = (torch.float32, torch.bfloat16)
# a halo's source, by the code the C entries take (csrc/halo.cu:Src): the
# ring, the flipped own edge ('symmetric' at the global edge), zeros
SRC = {"recv": 0, "flip": 1, "zero": 2}


def block_shape(x, axis, k):
    """The shape of a ``k``-wide block of tile ``x`` along ``axis``."""
    shape = list(x.shape)
    shape[axis] = k
    return shape


def _check_axis(shape, axis, *widths):
    if len(shape) != 4 or axis not in (2, 3):
        raise ValueError(f"K19 takes a 4-D tile and axis 2 or 3, got "
                         f"{tuple(shape)} and axis {axis}")
    if min(widths) < 0 or max(widths) > shape[axis]:
        raise ValueError(f"K19: halo widths {widths} exceed the tile "
                         f"length {shape[axis]} along axis {axis}")


def halo_pack_plain(x, axis, tail, head, tail_out, head_out):
    """Plain PyTorch version of :func:`halo_pack`."""
    L = x.shape[axis]
    if tail:
        tail_out.view(block_shape(x, axis, tail)).copy_(
            x.narrow(axis, L - tail, tail))
    if head:
        head_out.view(block_shape(x, axis, head)).copy_(
            x.narrow(axis, 0, head))


def _flat(t, n, like, what):
    """The pointer of block ``t``: contiguous, ``n`` values of ``like``'s
    dtype on its device."""
    if t is None or not t.is_contiguous() or t.numel() != n or \
            t.dtype != like.dtype or t.device != like.device:
        raise ValueError(f"K19: {what} must be a contiguous block of {n} "
                         f"{like.dtype} values on {like.device}")
    return t.data_ptr()


def halo_pack(x, axis, tail, head, tail_out, head_out):
    """Write the last ``tail`` and the first ``head`` samples of tile ``x``
    along ``axis`` into the contiguous blocks ``tail_out`` and
    ``head_out`` (shapes :func:`block_shape`; a zero width leaves its
    block alone).  CPU tensors take :func:`halo_pack_plain`; CUDA tensors
    launch K19's ``halo_pack``."""
    _check_axis(x.shape, axis, tail, head)
    if x.device.type == "cpu":
        return halo_pack_plain(x, axis, tail, head, tail_out, head_out)
    _cuda.check_inputs("halo_pack", x, dtypes=_DTYPES)
    per = x.numel() // x.shape[axis]
    tp = _flat(tail_out, per * tail, x, "tail_out") if tail else 0
    hp = _flat(head_out, per * head, x, "head_out") if head else 0
    if per * (tail + head) == 0:
        return
    lib = _cuda.library("halo")
    _cuda.check(lib, "halo_pack", lib.halo_pack(
        x.data_ptr(), tp, hp, *x.shape, *x.stride(), axis, tail, head,
        int(x.dtype == torch.bfloat16), _cuda.stream_of(x)))
    halo_pack.launches += 1


def halo_assemble_plain(x, axis, left, right, lsrc, rsrc, recv_l, recv_r,
                        out):
    """Plain PyTorch version of :func:`halo_assemble`."""
    L = x.shape[axis]
    out.narrow(axis, left, L).copy_(x)
    for src, k, ofs, recv, edge in (
            (lsrc, left, 0, recv_l, 0), (rsrc, right, left + L, recv_r,
                                         L - right)):
        if not k:
            continue
        part = out.narrow(axis, ofs, k)
        if src == "recv":
            part.copy_(recv.view(block_shape(x, axis, k)))
        elif src == "flip":
            part.copy_(torch.flip(x.narrow(axis, edge, k), [axis]))
        else:
            part.zero_()
    return out


def halo_assemble(x, axis, left, right, lsrc, rsrc, recv_l, recv_r, out):
    """Write the window of tile ``x`` along ``axis`` into ``out`` (any view
    of shape :func:`block_shape` ``(x, axis, left + L + right)``): its
    left halo from ``recv_l`` (a contiguous ``left``-wide block), the
    flipped first ``left`` samples of ``x`` or zeros, as ``lsrc`` names
    ("recv", "flip", "zero"); its right halo likewise from ``recv_r``, the
    flipped last ``right`` samples or zeros.  Returns ``out``.  CPU
    tensors take :func:`halo_assemble_plain`; CUDA tensors launch K19's
    ``halo_assemble``."""
    _check_axis(x.shape, axis, left, right)
    if list(out.shape) != block_shape(x, axis, left + x.shape[axis] + right):
        raise ValueError(f"K19: window {tuple(out.shape)} does not fit tile "
                         f"{tuple(x.shape)} with halos ({left}, {right})")
    if x.device.type == "cpu":
        return halo_assemble_plain(x, axis, left, right, lsrc, rsrc, recv_l,
                                   recv_r, out)
    _cuda.check_inputs("halo_assemble", x, out, dtypes=_DTYPES)
    per = x.numel() // x.shape[axis]
    rl = _flat(recv_l, per * left, x, "recv_l") \
        if lsrc == "recv" and left else 0
    rr = _flat(recv_r, per * right, x, "recv_r") \
        if rsrc == "recv" and right else 0
    if out.numel() == 0:
        return out
    lib = _cuda.library("halo")
    _cuda.check(lib, "halo_assemble", lib.halo_assemble(
        x.data_ptr(), rl, rr, out.data_ptr(), *x.shape, *x.stride(),
        *out.stride(), axis, left, right, SRC[lsrc], SRC[rsrc],
        int(x.dtype == torch.bfloat16), _cuda.stream_of(x)))
    halo_assemble.launches += 1
    return out


def halo_fold_plain(gw, axis, left, right, lsrc, rsrc, from_l, from_r):
    """Plain PyTorch version of :func:`halo_fold` (sums in the kernel's
    order, in fp32 for bf16 and rounded once)."""
    L = gw.shape[axis] - left - right
    acc = torch.promote_types(gw.dtype, torch.float32)
    dx = gw.narrow(axis, left, L).to(acc, copy=True)
    if lsrc == "flip" and left:
        dx.narrow(axis, 0, left).add_(
            torch.flip(gw.narrow(axis, 0, left), [axis]).to(acc))
    if rsrc == "flip" and right:
        dx.narrow(axis, L - right, right).add_(
            torch.flip(gw.narrow(axis, left + L, right), [axis]).to(acc))
    if lsrc == "recv" and right:
        dx.narrow(axis, 0, right).add_(
            from_l.view(block_shape(dx, axis, right)).to(acc))
    if rsrc == "recv" and left:
        dx.narrow(axis, L - left, left).add_(
            from_r.view(block_shape(dx, axis, left)).to(acc))
    return dx.to(gw.dtype)


def halo_fold(gw, axis, left, right, lsrc, rsrc, from_l, from_r):
    """The adjoint of :func:`halo_assemble` followed by the ring: from the
    window cotangent ``gw`` (any view, ``left + L + right`` long along
    ``axis``), the contiguous tile cotangent: ``gw``'s tile part, plus
    the flipped cotangent of a "flip" halo, plus ``from_l`` (the left
    neighbour's cotangent of its right halo, a contiguous ``right``-wide
    block, where ``lsrc`` is "recv") added into the first ``right``
    samples and ``from_r`` (``left`` wide, where ``rsrc`` is "recv") into
    the last ``left``.  CPU tensors take :func:`halo_fold_plain`; CUDA
    tensors launch K19's ``halo_fold``."""
    L = gw.shape[axis] - left - right
    shape = block_shape(gw, axis, L)
    _check_axis(shape, axis, left, right)
    if gw.device.type == "cpu":
        return halo_fold_plain(gw, axis, left, right, lsrc, rsrc, from_l,
                               from_r)
    _cuda.check_inputs("halo_fold", gw, dtypes=_DTYPES)
    per = gw.numel() // gw.shape[axis]
    fl = _flat(from_l, per * right, gw, "from_l") \
        if lsrc == "recv" and right else 0
    fr = _flat(from_r, per * left, gw, "from_r") \
        if rsrc == "recv" and left else 0
    dx = torch.empty(shape, dtype=gw.dtype, device=gw.device)
    if dx.numel() == 0:
        return dx
    lib = _cuda.library("halo")
    _cuda.check(lib, "halo_fold", lib.halo_fold(
        gw.data_ptr(), fl, fr, dx.data_ptr(), *shape, *gw.stride(), axis,
        left, right, SRC[lsrc], SRC[rsrc], int(gw.dtype == torch.bfloat16),
        _cuda.stream_of(gw)))
    halo_fold.launches += 1
    return dx


halo_pack.launches = 0
halo_assemble.launches = 0
halo_fold.launches = 0
