"""Ring halo exchange for spatially sharded operators (port of
``pytorch_wavelets_tpu/parallel/halo.py``).

Each rank of a mesh dim's process group holds a contiguous tile of one
image axis.  An operator apply needs ``left`` / ``right`` samples of its
neighbours' tiles: the ring sends each tile's last ``left`` samples to
the right neighbour (its left halo) and its first ``right`` samples to
the left neighbour (its right halo).  At the global edge the halo is the
neighbour's across the ring ('wrap'), the tile's own edge flipped
('symmetric') or zeros ('zero'), as in the JAX package, which selects
with a ``where`` after a full ring; here the edge links are not sent.

The on-card passes are kernel K19 (``ops/halo.py``: pack, assemble,
fold; one launch each for all the parts of an exchange), the ring one
``torch.distributed.batch_isend_irecv`` of one contiguous buffer each
way (counted in :data:`EXCHANGES`).  A group whose backend cannot send
CUDA tensors (gloo) takes them through pinned host memory: an explicit
branch on the group's backend, counted in :data:`STAGED_BYTES`.  The exchange
is an autograd Function whose backward is its adjoint (the halo
cotangents go back to the ranks that sent them and add into the edges
they came from, K19's fold), and whose backward's backward is the
exchange again (``ops/_linear.py``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from pytorch_wavelets_tpu_torch.ops._linear import linear_backward
from pytorch_wavelets_tpu_torch.ops.halo import (
    halo_assemble, halo_fold, halo_pack,
)

__all__ = ["halo_exchange_1d", "halo_window", "STAGED_BYTES",
           "reset_staged_bytes", "EXCHANGES", "reset_exchanges"]

# bytes copied between the card and pinned host memory for gloo groups:
# device to host and host to device
STAGED_BYTES = {"d2h": 0, "h2d": 0}
# exchanges run (the windows' and their adjoints') and the parts they
# carried: each is one K19 pack and one assemble or fold
EXCHANGES = {"forward": 0, "adjoint": 0, "forward_parts": 0,
             "adjoint_parts": 0}

_BOUNDARY_SRC = {"wrap": "recv", "symmetric": "flip", "zero": "zero"}


def reset_staged_bytes() -> None:
    STAGED_BYTES["d2h"] = STAGED_BYTES["h2d"] = 0


def reset_exchanges() -> None:
    EXCHANGES.update(dict.fromkeys(EXCHANGES, 0))


def stages_through_host(group, t) -> bool:
    """Whether ``group`` takes ``t`` through pinned host memory: a CUDA
    tensor on a gloo group (gloo sends and gathers host tensors only)."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def to_host(t):
    """``t`` copied into pinned host memory (counted)."""
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    STAGED_BYTES["d2h"] += t.numel() * t.element_size()
    return h


def from_host(dst, h):
    """``h`` copied back into the card tensor ``dst`` (counted)."""
    dst.copy_(h)
    STAGED_BYTES["h2d"] += h.numel() * h.element_size()
    return dst


class _Ring(NamedTuple):
    """One rank's place on a mesh dim's ring: its group, size, rank in the
    group, the global ranks of its neighbours, and each side's halo
    source at this rank ("recv" across the ring, else the global edge's
    "flip" or "zero")."""
    group: object
    n: int
    rank: int
    left_nb: int
    right_nb: int
    lsrc: str
    rsrc: str


def _ring(group, boundary) -> _Ring:
    if boundary not in _BOUNDARY_SRC:
        raise ValueError(f"unsupported halo boundary: {boundary}")
    n, r = dist.get_world_size(group), dist.get_rank(group)
    edge = _BOUNDARY_SRC[boundary]
    return _Ring(group, n, r,
                 dist.get_global_rank(group, (r - 1) % n),
                 dist.get_global_rank(group, (r + 1) % n),
                 edge if r == 0 else "recv",
                 edge if r == n - 1 else "recv")


def _exchange(ring: _Ring, send, n_tail, n_head, n_from_l, n_from_r):
    """One ring step: ``send`` holds ``n_tail`` values for the right
    neighbour, then ``n_head`` for the left one; returns the buffer of
    ``n_from_l`` values from the left neighbour, then ``n_from_r`` from
    the right one.  A side whose source is not "recv" sends and receives
    nothing (its counts are 0).  A ring of one is its own neighbour: the
    send buffer is the received one."""
    if ring.n == 1:
        return send
    recv = send.new_empty(n_from_l + n_from_r)
    stage = stages_through_host(ring.group, send)
    s, rv = (to_host(send), torch.empty(recv.shape, dtype=recv.dtype,
                                        pin_memory=True)) if stage \
        else (send, recv)
    ops = []
    # tag 0: toward the right neighbour; tag 1: toward the left one (a
    # ring of two has one neighbour on both sides)
    if n_tail:
        ops.append(dist.P2POp(dist.isend, s[:n_tail], ring.right_nb,
                              ring.group, 0))
    if n_head:
        ops.append(dist.P2POp(dist.isend, s[n_tail:], ring.left_nb,
                              ring.group, 1))
    if n_from_l:
        ops.append(dist.P2POp(dist.irecv, rv[:n_from_l], ring.left_nb,
                              ring.group, 0))
    if n_from_r:
        ops.append(dist.P2POp(dist.irecv, rv[n_from_l:], ring.right_nb,
                              ring.group, 1))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    return from_host(recv, rv) if stage else recv


class _Spec(NamedTuple):
    ring: _Ring
    axis: int
    left: int
    right: int


def _swap(ring, parts, axis, tail, head, from_l, from_r):
    """One ring step for all ``parts``: each part's last ``tail`` and
    first ``head`` samples packed (one K19 launch) into one buffer, sent
    right and left; returns the received (``from_l``-wide blocks from the
    left neighbour, ``from_r``-wide blocks from the right one), each
    part's block back to back."""
    n = parts[0].numel() // parts[0].shape[axis] * len(parts)
    send = parts[0].new_empty(n * (tail + head))
    halo_pack(parts, axis, tail, head, send[:n * tail], send[n * tail:])
    recv = _exchange(ring, send, n * tail, n * head, n * from_l, n * from_r)
    return recv[:n * from_l], recv[n * from_l:]


def _live(ring, k_left, k_right):
    """(k_left, k_right), each 0 where its side is a global edge."""
    return (k_left if ring.lsrc == "recv" else 0,
            k_right if ring.rsrc == "recv" else 0)


def _window(spec: _Spec, parts):
    """Every part's (left + tile + right) window, concatenated along the
    axis: each tile's last ``left`` samples go right, its first ``right``
    left, and come back as the neighbours' halos (one pack, one
    assemble)."""
    ring, axis, left, right = spec
    heads, tails = _live(ring, right, left)
    from_l, from_r = _live(ring, left, right)
    recv_l, recv_r = _swap(ring, parts, axis, tails, heads, from_l, from_r)
    shape = list(parts[0].shape)
    shape[axis] = sum(p.shape[axis] + left + right for p in parts)
    EXCHANGES["forward"] += 1
    EXCHANGES["forward_parts"] += len(parts)
    return halo_assemble(parts, axis, left, right, ring.lsrc, ring.rsrc,
                         recv_l, recv_r, parts[0].new_empty(shape))


def _window_adjoint(spec: _Spec, shapes, gw):
    """The tiles' cotangents from the window cotangent ``gw``: each halo's
    cotangent goes back to the rank it came from (the right halo's right,
    the left halo's left) and is added into the edge it was taken from
    (one pack, one K19 fold)."""
    ring, axis, left, right = spec
    heads, tails = _live(ring, left, right)
    from_l, from_r = _live(ring, right, left)
    parts, ofs = [], 0
    for s in shapes:
        w = s[axis] + left + right
        parts.append(gw.narrow(axis, ofs, w))
        ofs += w
    fl, fr = _swap(ring, parts, axis, tails, heads, from_l, from_r)
    EXCHANGES["adjoint"] += 1
    EXCHANGES["adjoint_parts"] += len(parts)
    return halo_fold(gw, axis, left, right, ring.lsrc, ring.rsrc, fl, fr,
                     [s[axis] for s in shapes])


class _HaloExchange(torch.autograd.Function):
    """The windows of ``parts`` (one exchange); backward: the adjoint,
    whose own backward is this Function again."""

    @staticmethod
    def forward(ctx, spec, *parts):
        ctx.spec = spec
        ctx.shapes = tuple(p.shape for p in parts)
        return _window(spec, parts)

    @staticmethod
    def backward(ctx, gw):
        spec, shapes = ctx.spec, ctx.shapes

        def adjoint(g):
            return _window_adjoint(spec, shapes, g)

        def primal(*us):
            us = [torch.zeros(s, dtype=gw.dtype, device=gw.device)
                  if u is None else u for u, s in zip(us, shapes)]
            return _HaloExchange.apply(spec, *us)
        dxs = linear_backward(adjoint, primal, gw)
        if isinstance(dxs, torch.Tensor):
            dxs = (dxs,)
        return (None, *dxs)


def _canon_axis(axis):
    if axis not in (2, 3, -2, -1):
        raise ValueError(f"halo axis must be H (2) or W (3), got {axis}")
    return axis % 4


def halo_window(parts, axis, group, left, right, boundary="wrap"):
    """The (left, right)-halo'd windows of local tiles ``parts`` (NCHW,
    one per column block of an operator, the same sizes but along
    ``axis``), concatenated along ``axis``: one ring exchange over
    ``group`` for all of them.  Differentiable to any order."""
    axis = _canon_axis(axis)
    for p in parts:
        if max(left, right) > p.shape[axis]:
            raise ValueError(
                f"halo ({left}, {right}) exceeds the local tile width "
                f"{p.shape[axis]} on axis {axis}: a single ring exchange "
                "only reaches the immediate neighbour — reduce the level "
                "count J or the number of spatial shards")
    spec = _Spec(_ring(group, boundary), axis, int(left), int(right))
    return _HaloExchange.apply(spec, *parts)


def halo_exchange_1d(x, axis: int, group, left: int, right: int,
                     boundary: str = "wrap"):
    """Attach (left, right) halos to the local tile ``x`` (NCHW) along
    ``axis`` (2 or 3) from its neighbours on ``group`` (a mesh dim's
    process group: ``DeviceMesh.get_group(name)``).

    boundary, at the global image edge:
      'wrap'      : the ring all the way around (periodization),
      'symmetric' : the tile's own edge, flipped,
      'zero'      : zeros.
    Interior tile edges always receive their neighbours' samples.
    Raises ValueError when a halo exceeds the tile (one ring step only
    reaches the immediate neighbour)."""
    return halo_window([x], axis, group, left, right, boundary)
