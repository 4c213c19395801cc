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
2 (H) or 3 (W).  Each entry also takes several parts at once (the column
blocks of a multi-block operator: tiles of one shape but along the axis),
their blocks back to back and their windows side by side along the axis,
in one launch of up to :data:`MAX_PARTS` parts (:func:`part_groups`).
The copies are exact; the fold adds in fp32 in a fixed order and rounds
once, as its plain version does.  Each C entry picks its walk and returns
it, and the wrapper counts it in ``instantiations``: ``vector`` (16-byte
stores and runs of loads along W) where every tile and window has unit
stride along W, else ``strided`` (:func:`halo_walk` mirrors the rule).
"""
from __future__ import annotations

import ctypes
import math

import torch

from pytorch_wavelets_tpu_torch.ops import _cuda

__all__ = ["halo_pack", "halo_pack_plain", "halo_assemble",
           "halo_assemble_plain", "halo_fold", "halo_fold_plain", "SRC",
           "HALO_WALKS", "MAX_PARTS", "block_shape", "halo_walk",
           "part_groups"]

_DTYPES = (torch.float32, torch.bfloat16)
# a halo's source, by the code the C entries take (csrc/halo.cu:Src): the
# ring, the flipped own edge ('symmetric' at the global edge), zeros
SRC = {"recv": 0, "flip": 1, "zero": 2}
# the walks, by the code the C entries return (csrc/halo.cu:Walk)
HALO_WALKS = ("vector", "strided")
MAX_PARTS = 8   # parts a launch (csrc/halo.cu:MAX_PARTS)

_LL4 = ctypes.c_longlong * 4


class _Part(ctypes.Structure):
    """One part of a launch (``csrc/halo.cu:HaloPart``)."""
    _fields_ = [("x", ctypes.c_void_p), ("y", ctypes.c_void_p),
                ("y2", ctypes.c_void_p), ("rl", ctypes.c_void_p),
                ("rr", ctypes.c_void_p), ("xs", _LL4), ("ys", _LL4),
                ("L", ctypes.c_longlong)]


def block_shape(x, axis, k):
    """The shape of a ``k``-wide block of tile ``x`` along ``axis``."""
    shape = list(x.shape)
    shape[axis] = k
    return shape


def part_groups(n):
    """The launches of ``n`` parts: (first, end) ranges of at most
    :data:`MAX_PARTS` parts."""
    return [(i, min(n, i + MAX_PARTS)) for i in range(0, n, MAX_PARTS)]


def halo_walk(*views) -> str:
    """The walk a launch takes (``csrc/halo.cu:vector_view``): "vector"
    where every strided operand of it (the tiles of a pack or an
    assemble, the assemble's windows, the fold's window cotangent parts)
    has unit stride along W (or one sample along it), wherever its rows
    start, else "strided"."""
    return "vector" if all(v.shape[3] == 1 or v.stride(3) == 1
                           for v in views) else "strided"


def _per(shape, axis):
    """Samples of a tile for each position along ``axis``."""
    return math.prod(s for d, s in enumerate(shape) if d != axis)


def _parts(x, axis, *widths):
    """Tile ``x`` or the tiles of sequence ``x``, checked: 4-D, axis 2 or
    3, the same shape but along the axis, halos within each tile."""
    parts = [x] if isinstance(x, torch.Tensor) else list(x)
    if not parts:
        raise ValueError("K19: no tile")
    for p in parts:
        _check_axis(p.shape, axis, *widths)
        if block_shape(p, axis, 0) != block_shape(parts[0], axis, 0) or \
                p.dtype != parts[0].dtype or p.device != parts[0].device:
            raise ValueError(f"K19: parts of one launch differ but along "
                             f"axis {axis}: {[tuple(q.shape) for q in parts]}")
    return parts


def _check_axis(shape, axis, *widths):
    if len(shape) != 4 or axis not in (2, 3):
        raise ValueError(f"K19 takes a 4-D tile and axis 2 or 3, got "
                         f"{tuple(shape)} and axis {axis}")
    if min(widths) < 0 or max(widths) > shape[axis]:
        raise ValueError(f"K19: halo widths {widths} exceed the tile "
                         f"length {shape[axis]} along axis {axis}")


def _block(buf, i, n):
    """Part ``i``'s ``n``-value block of the blocks back to back in
    ``buf``."""
    return buf[i * n:(i + 1) * n]


def _windows(out, axis, lengths, left, right):
    ws, ofs = [], 0
    for L in lengths:
        ws.append(out.narrow(axis, ofs, left + L + right))
        ofs += left + L + right
    return ws


def halo_pack_plain(x, axis, tail, head, tail_out, head_out):
    """Plain PyTorch version of :func:`halo_pack`."""
    parts = _parts(x, axis, tail, head)
    per = _per(parts[0].shape, axis)
    for i, p in enumerate(parts):
        L = p.shape[axis]
        if tail:
            _block(tail_out, i, per * tail).view(
                block_shape(p, axis, tail)).copy_(p.narrow(axis, L - tail,
                                                           tail))
        if head:
            _block(head_out, i, per * head).view(
                block_shape(p, axis, head)).copy_(p.narrow(axis, 0, head))


def _check_block(t, n, like, what):
    """Raise unless block ``t`` is contiguous, ``n`` values of ``like``'s
    dtype on its device."""
    if t is None or not t.is_contiguous() or t.numel() != n or \
            t.dtype != like.dtype or t.device != like.device:
        raise ValueError(f"K19: {what} must be a contiguous block of {n} "
                         f"{like.dtype} values on {like.device}")


def _launch(wrapper, table, like, axis, a, b, lsrc=0, rsrc=0):
    """One launch of K19's entry ``wrapper.__name__`` over the parts of
    ``table`` (at most MAX_PARTS ``_Part``s) of tiles shaped as ``like``
    but along ``axis``; counts it and its walk."""
    arr = (_Part * len(table))(*table)
    walk = ctypes.c_int(-1)
    lib = _cuda.library("halo")
    name = wrapper.__name__
    _cuda.check(lib, name, getattr(lib, name)(
        ctypes.addressof(arr), len(table), *like.shape, axis, a, b, lsrc,
        rsrc, int(like.dtype == torch.bfloat16), ctypes.addressof(walk),
        _cuda.stream_of(like)))
    wrapper.launches += 1
    wrapper.instantiations[HALO_WALKS[walk.value]] += 1


def halo_pack(x, axis, tail, head, tail_out, head_out):
    """Write the last ``tail`` and the first ``head`` samples of tile ``x``
    along ``axis`` into the contiguous blocks ``tail_out`` and
    ``head_out`` (shapes :func:`block_shape`; a zero width leaves its
    block alone).  ``x`` may be a sequence of tiles: their blocks go back
    to back.  CPU tensors take :func:`halo_pack_plain`; CUDA tensors
    launch K19's ``halo_pack`` (once for every MAX_PARTS tiles)."""
    parts = _parts(x, axis, tail, head)
    if parts[0].device.type == "cpu":
        return halo_pack_plain(parts, axis, tail, head, tail_out, head_out)
    _cuda.check_inputs("halo_pack", *parts, dtypes=_DTYPES)
    per = _per(parts[0].shape, axis)
    n = per * len(parts)
    if tail:
        _check_block(tail_out, n * tail, parts[0], "tail_out")
    if head:
        _check_block(head_out, n * head, parts[0], "head_out")
    if n * (tail + head) == 0:
        return
    for lo, hi in part_groups(len(parts)):
        table = [_Part(p.data_ptr(),
                       _block(tail_out, i, per * tail).data_ptr() if tail
                       else None,
                       _block(head_out, i, per * head).data_ptr() if head
                       else None,
                       None, None, _LL4(*p.stride()), _LL4(),
                       p.shape[axis])
                 for i, p in enumerate(parts[lo:hi], lo)]
        _launch(halo_pack, table, parts[0], axis, tail, head)


def _assemble_one(x, axis, left, right, lsrc, rsrc, recv_l, recv_r, out):
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


def halo_assemble_plain(x, axis, left, right, lsrc, rsrc, recv_l, recv_r,
                        out):
    """Plain PyTorch version of :func:`halo_assemble`."""
    parts = _parts(x, axis, left, right)
    per = _per(parts[0].shape, axis)
    wins = _windows(out, axis, [p.shape[axis] for p in parts], left, right)
    for i, (p, w) in enumerate(zip(parts, wins)):
        _assemble_one(p, axis, left, right, lsrc, rsrc,
                      _block(recv_l, i, per * left) if lsrc == "recv" and
                      left else None,
                      _block(recv_r, i, per * right) if rsrc == "recv" and
                      right else None, w)
    return out


def halo_assemble(x, axis, left, right, lsrc, rsrc, recv_l, recv_r, out):
    """Write the window of tile ``x`` along ``axis`` into ``out`` (any view
    of shape :func:`block_shape` ``(x, axis, left + L + right)``): its
    left halo from ``recv_l`` (a contiguous ``left``-wide block), the
    flipped first ``left`` samples of ``x`` or zeros, as ``lsrc`` names
    ("recv", "flip", "zero"); its right halo likewise from ``recv_r``, the
    flipped last ``right`` samples or zeros.  ``x`` may be a sequence of
    tiles: their received blocks back to back, their windows side by side
    along ``axis`` in ``out``.  Returns ``out``.  CPU tensors take
    :func:`halo_assemble_plain`; CUDA tensors launch K19's
    ``halo_assemble`` (once for every MAX_PARTS tiles)."""
    parts = _parts(x, axis, left, right)
    lengths = [p.shape[axis] for p in parts]
    if list(out.shape) != block_shape(parts[0], axis, sum(lengths) + len(
            parts) * (left + right)):
        raise ValueError(f"K19: window {tuple(out.shape)} does not fit tiles "
                         f"{[tuple(p.shape) for p in parts]} with halos "
                         f"({left}, {right})")
    if parts[0].device.type == "cpu":
        return halo_assemble_plain(parts, axis, left, right, lsrc, rsrc,
                                   recv_l, recv_r, out)
    _cuda.check_inputs("halo_assemble", *parts, out, dtypes=_DTYPES)
    per = _per(parts[0].shape, axis)
    n = per * len(parts)
    rl = lsrc == "recv" and left
    rr = rsrc == "recv" and right
    if rl:
        _check_block(recv_l, n * left, parts[0], "recv_l")
    if rr:
        _check_block(recv_r, n * right, parts[0], "recv_r")
    if out.numel() == 0:
        return out
    wins = _windows(out, axis, lengths, left, right)
    for lo, hi in part_groups(len(parts)):
        table = [_Part(p.data_ptr(), w.data_ptr(), None,
                       _block(recv_l, i, per * left).data_ptr() if rl
                       else None,
                       _block(recv_r, i, per * right).data_ptr() if rr
                       else None,
                       _LL4(*p.stride()), _LL4(*w.stride()), p.shape[axis])
                 for i, (p, w) in enumerate(zip(parts[lo:hi], wins[lo:hi]),
                                            lo)]
        _launch(halo_assemble, table, parts[0], axis, left, right,
                SRC[lsrc], SRC[rsrc])
    return out


def _fold_one(gw, axis, left, right, lsrc, rsrc, from_l, from_r):
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


def _fold_lengths(gw, axis, left, right, lengths):
    lengths = [gw.shape[axis] - left - right] if lengths is None \
        else list(lengths)
    if sum(lengths) + len(lengths) * (left + right) != gw.shape[axis]:
        raise ValueError(f"K19: window cotangent {tuple(gw.shape)} does not "
                         f"fit tiles of lengths {lengths} with halos "
                         f"({left}, {right}) along axis {axis}")
    for L in lengths:
        _check_axis(block_shape(gw, axis, L), axis, left, right)
    return lengths


def halo_fold_plain(gw, axis, left, right, lsrc, rsrc, from_l, from_r,
                    lengths=None):
    """Plain PyTorch version of :func:`halo_fold` (sums in the kernel's
    order, in fp32 for bf16 and rounded once)."""
    Ls = _fold_lengths(gw, axis, left, right, lengths)
    per = _per(gw.shape, axis)
    dxs = tuple(
        _fold_one(g, axis, left, right, lsrc, rsrc,
                  _block(from_l, i, per * right) if lsrc == "recv" and
                  right else None,
                  _block(from_r, i, per * left) if rsrc == "recv" and
                  left else None)
        for i, g in enumerate(_windows(gw, axis, Ls, left, right)))
    return dxs[0] if lengths is None else dxs


def halo_fold(gw, axis, left, right, lsrc, rsrc, from_l, from_r,
              lengths=None):
    """The adjoint of :func:`halo_assemble` followed by the ring: from the
    window cotangent ``gw`` (any view, ``left + L + right`` long along
    ``axis``), the contiguous tile cotangent: ``gw``'s tile part, plus
    the flipped cotangent of a "flip" halo, plus ``from_l`` (the left
    neighbour's cotangent of its right halo, a contiguous ``right``-wide
    block, where ``lsrc`` is "recv") added into the first ``right``
    samples and ``from_r`` (``left`` wide, where ``rsrc`` is "recv") into
    the last ``left``.  With ``lengths`` (the tiles' lengths), ``gw``
    holds the windows of several tiles side by side along ``axis`` and
    their blocks go back to back: returns a tuple of tile cotangents.
    CPU tensors take :func:`halo_fold_plain`; CUDA tensors launch K19's
    ``halo_fold`` (once for every MAX_PARTS tiles)."""
    Ls = _fold_lengths(gw, axis, left, right, lengths)
    if gw.device.type == "cpu":
        return halo_fold_plain(gw, axis, left, right, lsrc, rsrc, from_l,
                               from_r, lengths)
    _cuda.check_inputs("halo_fold", gw, dtypes=_DTYPES)
    per = _per(gw.shape, axis)
    n = per * len(Ls)
    fl = lsrc == "recv" and right
    fr = rsrc == "recv" and left
    if fl:
        _check_block(from_l, n * right, gw, "from_l")
    if fr:
        _check_block(from_r, n * left, gw, "from_r")
    dxs = [torch.empty(block_shape(gw, axis, L), dtype=gw.dtype,
                       device=gw.device) for L in Ls]
    if per * sum(Ls):
        wins = _windows(gw, axis, Ls, left, right)
        for lo, hi in part_groups(len(Ls)):
            table = [_Part(g.data_ptr(), d.data_ptr(), None,
                           _block(from_l, i, per * right).data_ptr() if fl
                           else None,
                           _block(from_r, i, per * left).data_ptr() if fr
                           else None,
                           _LL4(*g.stride()), _LL4(), L)
                     for i, (g, d, L) in enumerate(
                         zip(wins[lo:hi], dxs[lo:hi], Ls[lo:hi]), lo)]
            _launch(halo_fold, table, gw, axis, left, right, SRC[lsrc],
                    SRC[rsrc])
    return dxs[0] if lengths is None else tuple(dxs)


for _k in (halo_pack, halo_assemble, halo_fold):
    _k.launches = 0
    _k.instantiations = dict.fromkeys(HALO_WALKS, 0)
del _k
