"""Sharded evaluation of constant operator matrices (port of
``pytorch_wavelets_tpu/parallel/banded_shard.py``).

The operator path applies each 1-D filterbank op, and the whole composed
DTCWT pyramid, as a constant operator along one image axis.  Spatial
sharding tiles that axis, so the operator is split by output rows on the
host: rank i computes its row chunk from its own input tile plus a fixed
halo (the row chunk's band reaches only ``halo`` samples past its home
tile), exchanged once per apply by the ring (``parallel/halo.py``, K19).
Each rank keeps only its own block ``B[rank]`` on its device, as an
``ops/banded.Operator`` with K1's / K17's segment table from that block.

Block structure (stacked sub-operators on the row axis, concatenated
inputs on the column axis) is tiled over the ranks block by block, as in
the JAX package, so the local layout mirrors the global one.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from pytorch_wavelets_tpu_torch.ops._linear import linear_backward
from pytorch_wavelets_tpu_torch.ops.banded import (
    Operator, _merged_stride, apply_col, apply_row,
)
from pytorch_wavelets_tpu_torch.ops.precision import (
    get_matmul_precision, matmul_precision,
)
from pytorch_wavelets_tpu_torch.parallel.halo import halo_window

__all__ = ["ShardedOp", "build_sharded_op", "apply_sharded_op",
           "operator_apply"]


class ShardedOp:
    """The host plan of one sharded operator apply.

    halo_left / halo_right: samples to exchange per input block.
    blocks: (n_shards, M_local, win_total) stacked per-shard matrices,
        win_total = the sum over column blocks of (tile + halo_left +
        halo_right).
    col_tiles: per column block, the local tile width.
    wrap: whether halos wrap at the global boundary (ring) or are zero
        outside (boundary behaviour folded into the matrix).

    :meth:`local` gives a rank's block and its transpose as operators on
    a device, made at first use and kept.  (The JAX package's
    ``band_plan`` is K1's segment table here, planned per block.)"""

    def __init__(self, halo_left, halo_right, blocks, col_tiles, wrap):
        self.halo_left, self.halo_right = halo_left, halo_right
        self.blocks, self.col_tiles, self.wrap = blocks, col_tiles, wrap
        self._local: dict = {}

    def local(self, rank, device):
        """(B[rank], B[rank]^T) as ``Operator``s on ``device``."""
        key = (rank, torch.device(device))
        ops = self._local.get(key)
        if ops is None:
            B = self.blocks[rank]
            ops = self._local[key] = (
                Operator(B, device), Operator(np.ascontiguousarray(B.T),
                                              device))
        return ops

    @property
    def nbytes(self):
        return self.blocks.nbytes + sum(o.nbytes for pair in
                                        self._local.values() for o in pair)


def _chunks(sizes: Sequence[int], n: int):
    """Per-block (offset, size) with the divisibility check."""
    out = []
    ofs = 0
    for s in sizes:
        if s % n:
            raise ValueError(
                f"operator block of size {s} does not divide over {n} "
                "shards — choose a shard count dividing every per-level "
                "output length")
        out.append((ofs, s))
        ofs += s
    return out


def build_sharded_op(T, n: int, row_blocks: Sequence[int],
                     col_blocks: Sequence[int], wrap: bool) -> ShardedOp:
    """Split operator ``T`` (M, K) into per-shard row-chunk matrices.

    row_blocks / col_blocks: sizes of the stacked sub-operators on each
    axis (sum to M / K); every block is tiled into ``n`` equal parts.
    ``wrap=True`` folds out-of-range columns circularly (periodization
    operators couple the two image ends); ``wrap=False`` zero-fills them
    (symmetric/zero-mode operators have no mass outside the axis).

    Raises ValueError when a block does not divide by ``n`` or the needed
    halo exceeds one tile (a single ring hop only reaches the immediate
    neighbour).
    """
    T = np.asarray(T)
    M, K = T.shape
    if sum(row_blocks) != M or sum(col_blocks) != K:
        raise ValueError("row/col block sizes must sum to the operator "
                         f"shape {T.shape}")
    rb = _chunks(row_blocks, n)
    cb = _chunks(col_blocks, n)
    nz = np.abs(T) > (np.abs(T).max() * 1e-12 + 0.0)

    # halo = max overhang of any row chunk's nonzero band beyond its home
    # column tile, measured per column block
    hl = hr = 0
    for (rofs, rsz) in rb:
        rloc = rsz // n
        for i in range(n):
            cols = np.nonzero(nz[rofs + i * rloc:
                                 rofs + (i + 1) * rloc].any(axis=0))[0]
            for (cofs, csz) in cb:
                w = csz // n
                local = cols[(cols >= cofs) & (cols < cofs + csz)] - cofs
                home0, home1 = i * w, (i + 1) * w
                for c in local:
                    if home0 <= c < home1:
                        continue
                    if wrap:
                        lov = (home0 - c) % csz
                        rov = (c - (home1 - 1)) % csz
                        if lov <= rov:
                            hl = max(hl, int(lov))
                        else:
                            hr = max(hr, int(rov))
                    elif c < home0:
                        hl = max(hl, int(home0 - c))
                    else:
                        hr = max(hr, int(c - home1 + 1))
    min_tile = min(csz // n for _, csz in cb)
    if max(hl, hr) > min_tile:
        raise ValueError(
            f"sharded operator needs a ({hl}, {hr}) halo but the smallest "
            f"local tile is {min_tile}: one ring exchange only reaches the "
            "immediate neighbour — reduce the level count or shard count")

    m_local = sum(s // n for _, s in rb)
    win_total = sum(s // n + hl + hr for _, s in cb)
    B = np.zeros((n, m_local, win_total), dtype=T.dtype)
    for i in range(n):
        r_out = 0
        for (rofs, rsz) in rb:
            rloc = rsz // n
            rows = T[rofs + i * rloc: rofs + (i + 1) * rloc]
            c_out = 0
            for (cofs, csz) in cb:
                w = csz // n
                cols = np.arange(i * w - hl, (i + 1) * w + hr)
                if wrap:
                    gcols = cols % csz
                    sub = rows[:, cofs + gcols].copy()
                    # a window wider than the block aliases some source
                    # columns into several positions; the halo'd input
                    # carries the same sample at each, so keep exactly one
                    # occurrence of the weight
                    seen: set = set()
                    for p, c in enumerate(gcols):
                        if c in seen:
                            sub[:, p] = 0.0
                        else:
                            seen.add(c)
                else:
                    sub = np.zeros((rloc, w + hl + hr), dtype=T.dtype)
                    valid = (cols >= 0) & (cols < csz)
                    sub[:, valid] = rows[:, cofs + cols[valid]]
                B[i, r_out:r_out + rloc,
                  c_out:c_out + w + hl + hr] = sub
                c_out += w + hl + hr
            r_out += rloc
    return ShardedOp(hl, hr, np.ascontiguousarray(B),
                     tuple(s // n for _, s in cb), wrap)


def _k1_input(x, axis):
    """``x`` as K1 / K17 read it: columns contiguous and the planes
    (column entry, axis 2) or rows (row entry, axis 3) at one stride;
    a copy only where ``x`` is not."""
    if ((x.shape[3] > 1 and x.stride(3) != 1)
            or _merged_stride(x.shape[:axis], x.stride()[:axis]) is None):
        return x.contiguous()
    return x


class _OperatorApply(torch.autograd.Function):
    """``op`` along ``axis`` (K1 / K17 through ``ops/banded.py``); the
    backward applies ``opT`` at the forward's matmul precision level, and
    that backward's backward is this Function again."""

    @staticmethod
    def forward(ctx, x, op, opT, axis):
        ctx.args = (op, opT, axis)
        ctx.level = get_matmul_precision()
        return _apply(x, op, axis)

    @staticmethod
    def backward(ctx, g):
        op, opT, axis = ctx.args
        level = ctx.level

        def adjoint(u):
            with matmul_precision(level):
                return _apply(u, opT, axis)

        def primal(u):
            with matmul_precision(level):
                return _OperatorApply.apply(u, op, opT, axis)
        return linear_backward(adjoint, primal, g), None, None, None


def _apply(x, op, axis):
    x = _k1_input(x, axis)
    return apply_col(x, op) if axis == 2 else apply_row(x, op)


def operator_apply(x, op, opT, axis):
    """Differentiable ``y = op`` along ``axis`` (2: columns, 3: rows) of
    NCHW ``x``, with ``opT`` its transpose as ``Operator``s."""
    return _OperatorApply.apply(x, op, opT, axis)


def apply_sharded_op(parts, op: ShardedOp, axis: int, group):
    """Apply a sharded operator along ``axis`` of local tiles.

    parts: local tensors, one per column block (each this rank's tile of
    that block's axis).  Halos are exchanged for all blocks at once (K19
    and one ring step over ``group``), the halo'd blocks concatenated,
    and this rank's own block ``B[rank]`` applied (K1, or K17 at the
    "high" / "default" levels and on bf16).  Returns the local chunk of
    the output rows.  The backward is K1 on ``B[rank]^T``, then the
    exchange's adjoint."""
    axis = axis % 4
    if dist.get_world_size(group) == 1 and not (op.halo_left
                                                or op.halo_right):
        # one shard without halos: B[0] is the operator, applied to the
        # blocks as they are
        window = parts[0] if len(parts) == 1 else torch.cat(parts, axis)
    else:
        window = halo_window(parts, axis, group, op.halo_left,
                             op.halo_right, "wrap" if op.wrap else "zero")
    B, BT = op.local(dist.get_rank(group), window.device)
    return operator_apply(window, B, BT, axis)
