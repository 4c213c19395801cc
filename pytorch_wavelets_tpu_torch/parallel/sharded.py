"""Sharded DTCWT on a device mesh (port of the composed-pyramid part of
``pytorch_wavelets_tpu/parallel/sharded.py``).

The forward runs the composed whole-pyramid DTCWT with the image tiled
over the mesh: batch over 'data', W over 'spatial', and on a 2-D tiling
mesh H over 'spatial_h'.  Every rank:

- applies its row chunk of the stacked stage-1 row operator to its
  halo'd tile (``parallel/banded_shard.py``: one ring exchange, K19, then
  K1 on its own block);
- runs each subband group's stage-2 column operator under a strategy
  along H: 'local' (H not sharded: K1 on the whole column operator),
  'shard' (a halo'd row chunk, as stage 1) or 'gather' (the tile has
  shrunk below the halo: the small axis is gathered with one
  ``all_gather``, the full operator applied, and the rank keeps its own
  output chunk);
- writes the bands with K2 (``ops/quad.py:q2c_pack``).

The inverse combines each group's orientation pairs with K3
(``ops/quad.py:c2q_unpack``), applies the row merge and the column
operator under their strategies, and sums the groups and the lowpass
term.  Every step is an autograd Function whose backward is its adjoint
(the halo's, K1 on the transposed operators, K3 for K2 and K2 for K3,
``reduce_scatter`` for the gather), differentiable again to any order.

Inputs and outputs are ``torch.distributed.tensor.DTensor``s placed as
the JAX package's ``in_specs`` / ``out_specs``; a plain tensor is taken
as the full tensor, present on every rank, and each rank takes its own
chunk of it (its gradient flows back to that chunk).  The work between
runs on the local tensors (``to_local`` / ``DTensor.from_local``, which
autograd follows).

Where the composed route has no plan (an axis past ``MAX_MATMUL_N`` =
8832, a halo wider than the tile, an inverse without the lowpass or a
level's bands, tiles that do not divide, odd sizes on a DTensor), both
entries run the **per-level route** ('perlevel'): each level its own
sharded stage-1 row apply and stage-2 column applies under the same
strategies, the lowpass passed on as local tiles, to ``_SHARDED_MM_CAP``
= 32768 samples an axis (the per-level operators synthesized from small
probes, ``ops/banded.py:extend_operator``).  Its operators are
zero-embedded into shard-divisible storage (the JAX package's
``_embed_blocks`` technique, :func:`_embedded_strategy`), the level-1
replicate pad and the %4 pads folded in, so any H and W tile the mesh:
the inputs are zero-padded to their storage (``_local(..., storage=)``),
the outputs cut to their logical sizes (``_global(..., logical=)``).
Where the JAX package runs GSPMD past that (the operator route off, an
axis past 32768), both entries take the stencil halo route
(``parallel/sharded_conv.py``, 'conv').  No route holds the whole image
on one rank.  The host planners are numpy copies of the JAX ones.
"""
from __future__ import annotations

import math
import warnings
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from pytorch_wavelets_tpu_torch.ops import banded
from pytorch_wavelets_tpu_torch.ops._linear import linear_backward
from pytorch_wavelets_tpu_torch.ops.banded import Operator
from pytorch_wavelets_tpu_torch.ops.dtcwt_fb import (
    _dfilt_matrix, _filter_matrix, _ifilt_matrix,
)
from pytorch_wavelets_tpu_torch.ops.fused_dtcwt import (
    _SB_ORIENTS, _cat, _cstack, _member_groups, _pyramid_layout,
    canonical_bands,
)
from pytorch_wavelets_tpu_torch.ops.quad import c2q_unpack, q2c_pack
from pytorch_wavelets_tpu_torch.parallel.banded_shard import (
    apply_sharded_op, build_sharded_op, operator_apply,
)
from pytorch_wavelets_tpu_torch.parallel.halo import (
    from_host, stages_through_host, to_host,
)
from pytorch_wavelets_tpu_torch.parallel.mesh import placements
from pytorch_wavelets_tpu_torch.transforms.dtcwt import (
    _fwd_pyramid_plan, _inv_pyramid_plan, _pad4_matrix, get_dimensions5,
    get_dimensions6,
)
from pytorch_wavelets_tpu_torch.transforms.dtcwt_xfm import (
    _replicate_pad_even,
)
from pytorch_wavelets_tpu_torch.transforms.plan_cache import (
    budgeted_plan_cache,
)

__all__ = ["sharded_dtcwt2d", "sharded_idtcwt2d", "sharded_batch_apply",
           "LAST_PATH"]

# Which path each public sharded_* entry last took: name -> 'matmul' (the
# operator route: the DTCWT's and the scattering layers' composed
# pyramids, the DWT's and SWT's per-level operators, the ISWT's dense
# least-squares merge), 'perlevel' (the DTCWT and the scattering fronts
# level by level on zero-embedded storage past the composed route) or
# 'conv' (the DWT's and SWT's conv halo route, parallel/sharded_dwt.py;
# the DTCWT's and the scattering layers' stencil halo route,
# parallel/sharded_conv.py); the JAX package has 'gspmd' where this port
# runs 'perlevel', 'matmul' or 'conv'.
LAST_PATH: dict = {}

# The JAX package's cap of the sharded operator routes: a 32768-wide
# operator takes GBs of host memory while it is built.
_SHARDED_MM_CAP = 32768

_WARNED: set = set()


def warn_once(key, message):
    """A ``UserWarning`` the first time ``key`` is seen in this process:
    the routes that move more than a halo name themselves once, as the
    JAX package's ``_note_path`` names its GSPMD fallback."""
    if key not in _WARNED:
        _WARNED.add(key)
        warnings.warn(message, UserWarning, stacklevel=3)


def _mm_enabled(n):
    """Whether an axis of length ``n`` may take the composed route (the
    JAX package's gate of the same name)."""
    return banded.composed_enabled(n)


def _sharded_mm_wanted(n):
    """Whether an axis of length ``n`` may take a sharded operator route
    level by level."""
    return banded.matmul_requested() and n <= _SHARDED_MM_CAP


# --------------------------------------------------------------------------
# Mesh axes
# --------------------------------------------------------------------------

class _Axis(NamedTuple):
    """One mesh dim as a rank sees it: its process group (None for an
    absent dim), its size and the rank's coordinate on it."""
    group: object
    n: int
    rank: int


def _axis(mesh, name) -> _Axis:
    names = mesh.mesh_dim_names
    if name not in names:
        return _Axis(None, 1, 0)
    return _Axis(mesh.get_group(name), mesh.size(names.index(name)),
                 mesh.get_local_rank(name))


def _mesh_sp(mesh):
    """(n_spatial_h, n_spatial) of a 1-D or 2-D tiling mesh."""
    return _axis(mesh, "spatial_h").n, _axis(mesh, "spatial").n


def _n_data(mesh):
    return _axis(mesh, "data").n


def _check_mesh(mesh):
    if tuple(mesh.mesh_dim_names or ()) not in (
            ("data", "spatial"), ("data", "spatial_h", "spatial")):
        raise ValueError(f"expected a ('data', 'spatial') or ('data', "
                         f"'spatial_h', 'spatial') mesh (parallel.make_mesh),"
                         f" got dims {mesh.mesh_dim_names}")


# --------------------------------------------------------------------------
# Collectives as autograd Functions
# --------------------------------------------------------------------------

def _all_gather_dim0(x, group):
    """(n, *x.shape): every rank's ``x`` (through pinned host memory on a
    gloo group holding CUDA tensors)."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    shape = (n * x.shape[0], *x.shape[1:])   # the ranks' tiles along dim 0
    if stages_through_host(group, x):
        out = torch.empty(shape, dtype=x.dtype, pin_memory=True)
        dist.all_gather_into_tensor(out, to_host(x), group=group)
        out = from_host(x.new_empty(shape), out)
    else:
        out = x.new_empty(shape)
        dist.all_gather_into_tensor(out, x, group=group)
    return out.view(n, *x.shape)


def _reduce_scatter_dim0(y, group):
    """The sum over ranks of ``y`` (n, ...), each rank keeping its own
    slice along dim 0."""
    y = y.contiguous().flatten(0, 1)
    shape = (y.shape[0] // dist.get_world_size(group), *y.shape[1:])
    if stages_through_host(group, y):
        out = torch.empty(shape, dtype=y.dtype, pin_memory=True)
        dist.reduce_scatter_tensor(out, to_host(y), group=group)
        return from_host(y.new_empty(shape), out)
    out = y.new_empty(shape)
    dist.reduce_scatter_tensor(out, y, group=group)
    return out


class _AllGather(torch.autograd.Function):
    """Every rank's tile concatenated along ``axis`` (``all_gather``); the
    backward sums the cotangent over the ranks and keeps this rank's
    chunk (``reduce_scatter``), and its backward is the gather again."""

    @staticmethod
    def forward(ctx, x, axis, group):
        ctx.args = (axis, group)
        g = _all_gather_dim0(x, group)               # (n, N, C, H, W)
        return g.movedim(0, axis).flatten(axis, axis + 1)

    @staticmethod
    def backward(ctx, gy):
        axis, group = ctx.args
        n = dist.get_world_size(group)

        def adjoint(g):
            parts = g.unflatten(axis, (n, g.shape[axis] // n))
            return _reduce_scatter_dim0(parts.movedim(axis, 0), group)

        def primal(u):
            return _AllGather.apply(u, axis, group)
        return linear_backward(adjoint, primal, gy), None, None


def _bands_like(orients):
    """``torch.empty`` where the groups' orientation pairs write all six
    orientations of a level's bands, else ``torch.zeros``."""
    covered = {o for ors in orients for pair in ors for o in pair}
    return torch.empty if len(covered) == 6 else torch.zeros


class _QuadsToBands(torch.autograd.Function):
    """One level's bands from its subband groups' stage-2 outputs (K2,
    ``q2c_pack``); backward K3 (``c2q_unpack``, K2's adjoint), whose own
    backward is this Function again."""

    @staticmethod
    def forward(ctx, meta, *ys):
        orients, o_dim, ri_dim = meta
        ctx.meta = meta
        N, C, rows, k2 = ys[0].shape
        shape = [N, C, rows // (2 * len(orients[0])), k2 // 2]
        shape.insert(o_dim, 6)
        shape.insert(ri_dim, 2)
        h = _bands_like(orients)(shape, dtype=ys[0].dtype,
                                 device=ys[0].device)
        hc = canonical_bands(h, o_dim, ri_dim)
        for y, ors in zip(ys, orients):
            q2c_pack(y.contiguous(), hc, ors)
        return h

    @staticmethod
    def backward(ctx, gh):
        meta = ctx.meta
        orients, o_dim, ri_dim = meta

        def adjoint(g):
            gc = canonical_bands(g, o_dim, ri_dim)
            return tuple(c2q_unpack(gc, ors) for ors in orients)

        def primal(*us):
            return _QuadsToBands.apply(meta, *us)
        gys = linear_backward(adjoint, primal, gh)
        if isinstance(gys, torch.Tensor):
            gys = (gys,)
        return (None, *gys)


class _BandsToQuads(torch.autograd.Function):
    """Each subband group's quadrant planes from a level's bands (K3,
    ``c2q_unpack``: per member rows [x1 | x2; x3 | x4]); backward K2,
    whose own backward is this Function again."""

    @staticmethod
    def forward(ctx, meta, h):
        orients, o_dim, ri_dim = meta
        ctx.meta, ctx.h_meta = meta, (h.shape, h.dtype, h.device)
        hc = canonical_bands(h, o_dim, ri_dim)
        return tuple(c2q_unpack(hc, ors) for ors in orients)

    @staticmethod
    def backward(ctx, *gqs):
        meta, (shape, dtype, device) = ctx.meta, ctx.h_meta
        orients, o_dim, ri_dim = meta

        def adjoint(*gs):
            dh = _bands_like(orients)(shape, dtype=dtype, device=device)
            dc = canonical_bands(dh, o_dim, ri_dim)
            for g, ors in zip(gs, orients):
                q2c_pack(g.contiguous(), dc, ors)
            return dh

        def primal(u):
            return _BandsToQuads.apply(meta, u)
        return None, linear_backward(adjoint, primal, *gqs)


# --------------------------------------------------------------------------
# Per-axis strategies: 'local' (axis not sharded), 'shard' (halo'd
# per-shard operator chunks), 'gather' (the tile has shrunk below the
# halo: the small axis is all-gathered, the level computed on the full
# axis, and each rank keeps its own output chunk)
# --------------------------------------------------------------------------

class _Strategy:
    """A strategy's kind and host object (a ShardedOp, or the operator T
    with the row and column block sizes); :meth:`operators` gives T and
    its transpose on a device ('local' / 'gather'), made once."""

    def __init__(self, kind, obj):
        self.kind, self.obj = kind, obj
        self._dev: dict = {}

    def operators(self, device):
        device = torch.device(device)
        ops = self._dev.get(device)
        if ops is None:
            T = self.obj if self.kind == "local" else self.obj[0]
            ops = self._dev[device] = (
                Operator(T, device), Operator(np.ascontiguousarray(T.T),
                                              device))
        return ops

    @property
    def nbytes(self):
        own = sum(o.nbytes for pair in self._dev.values() for o in pair)
        if self.kind == "shard":
            return own + self.obj.nbytes
        return own + (self.obj if self.kind == "local"
                      else self.obj[0]).nbytes


def _strategy(T, n, row_blocks, col_blocks, wrap=True):
    if n == 1:
        return _Strategy("local", np.ascontiguousarray(T))
    try:
        return _Strategy("shard", build_sharded_op(T, n, row_blocks,
                                                   col_blocks, wrap=wrap))
    except ValueError:
        for s in (*row_blocks, *col_blocks):
            if s % n:
                raise
        return _Strategy("gather", (np.ascontiguousarray(T),
                                    tuple(row_blocks), tuple(col_blocks)))


def _own_row_chunks(y, row_blocks, n, axis, rank):
    """From a full-axis result whose ``axis`` is the concat of
    ``row_blocks``, keep this rank's chunk of every block."""
    parts = []
    ofs = 0
    for s in row_blocks:
        loc = s // n
        parts.append(y.narrow(axis, ofs + rank * loc, loc))
        ofs += s
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=axis)


def _split(x, sizes, axis):
    parts, ofs = [], 0
    for s in sizes:
        parts.append(x.narrow(axis, ofs, s))
        ofs += s
    return parts


def _gathered_apply(parts, strat, axis, ax):
    T, row_blocks, _ = strat.obj
    g = [_AllGather.apply(p, axis, ax.group) for p in parts]
    xg = g[0] if len(g) == 1 else torch.cat(g, dim=axis)
    y = operator_apply(xg, *strat.operators(xg.device), axis)
    return _own_row_chunks(y, row_blocks, ax.n, axis, ax.rank)


def _apply_strategy(x, strat, axis, ax):
    """One operator apply along ``axis`` under a strategy.

    ``x`` holds the concatenation of the operator's column blocks along
    ``axis``; multi-block operators are split back into per-block parts
    so halos (and gathers) happen per block."""
    if strat.kind == "local":
        return operator_apply(x, *strat.operators(x.device), axis)
    if strat.kind == "shard":
        op = strat.obj
        parts = [x] if len(op.col_tiles) == 1 else _split(x, op.col_tiles,
                                                          axis)
        return apply_sharded_op(parts, op, axis, ax.group)
    _, _, col_blocks = strat.obj
    return _gathered_apply(_split(x, [c // ax.n for c in col_blocks], axis),
                           strat, axis, ax)


def _apply_merge(q, strat, axis, ax):
    """Synthesis merge (an operator over [lo | hi]) along ``axis`` of
    ``q``, which holds lo and hi side by side along it."""
    if strat.kind == "local":
        return operator_apply(q, *strat.operators(q.device), axis)
    w = q.shape[axis] // 2
    return _apply_merge2(q.narrow(axis, 0, w), q.narrow(axis, w, w), strat,
                         axis, ax)


def _apply_merge2(lo, hi, strat, axis, ax):
    """Synthesis merge (an operator over [lo | hi]) along ``axis`` of lo
    and hi given apart: one exchange (or gather) for both."""
    if strat.kind == "shard":
        return apply_sharded_op([lo, hi], strat.obj, axis, ax.group)
    if strat.kind == "local":
        return operator_apply(torch.cat([lo, hi], dim=axis),
                              *strat.operators(lo.device), axis)
    return _gathered_apply([lo, hi], strat, axis, ax)


# --------------------------------------------------------------------------
# Composed-pyramid plans (host numpy, cached)
# --------------------------------------------------------------------------

def _pyramid_shard_op(plan, W, n_sp):
    """The 'shard' strategy of a composed pyramid's stage-1 row operator
    (every block tiled over the spatial axis); None when the layout does
    not divide or the halo exceeds a tile."""
    blocks, _ = _pyramid_layout(plan)
    try:
        return _Strategy("shard", build_sharded_op(
            _cat(*blocks), n_sp, [b.shape[0] for b in blocks], [W],
            wrap=False))
    except ValueError:
        return None


def _pyramid_stage2_strategies(plan, n_h):
    """Per-entry stage-2 (H axis) strategies for a composed pyramid;
    None when a row block does not divide over the 'spatial_h' shards."""
    _, layout = _pyramid_layout(plan)
    out = []
    try:
        for entry in layout:
            e = {"groups": [], "ll": None}
            for members, go, gn in entry["groups"]:
                C = np.ascontiguousarray(_cstack(members))
                rb = []
                for _, Cm in members:
                    m = Cm[0::2].shape[0]
                    rb += [m, m]
                e["groups"].append(
                    (tuple(_SB_ORIENTS[name] for name, _ in members), go, gn,
                     _strategy(C, n_h, rb, [C.shape[1]], wrap=False)))
            if entry["ll"] is not None:
                Cl, go, gn = entry["ll"]
                Cl = np.ascontiguousarray(Cl)
                e["ll"] = (go, gn, _strategy(Cl, n_h, [Cl.shape[0]],
                                             [Cl.shape[1]], wrap=False))
            out.append(e)
    except ValueError:
        return None
    return out


@budgeted_plan_cache
def _dtcwt_fwd_shard_plans(h0o, h1o, h0a, h1a, h0b, h1b, J, skips, incs,
                           mode, H, W, n_sp, n_h):
    """(stage-1 ShardedOp, stage-2 strategies) for the composed forward
    pyramid, or None."""
    plan = _fwd_pyramid_plan(h0o, h1o, h0a, h1a, h0b, h1b, J,
                             skips, incs, mode, H, W)
    if plan is None:
        return None
    op = _pyramid_shard_op(plan, W, n_sp)
    s2 = _pyramid_stage2_strategies(plan, n_h)
    if op is None or s2 is None:
        return None
    return op, s2


def _band_group_strategies(bands, hb, wb, n_sp, n_h, embed=False):
    """One synthesis level's subband groups: per group of bands that share
    a row operator, (orientation pairs, the row merge's strategy over
    [lo | hi], the members' column operators' strategy).  ``bands`` is
    [(name, (R, C))] with (hb, wb) the bands' size.  Raises ValueError
    where a block does not divide, unless ``embed``: then every block is
    zero-embedded (:func:`_embedded_strategy`)."""
    groups: dict = {}
    for name, (R, C) in bands:
        groups.setdefault(id(R), (R, []))[1].append((name, C))
    lv = []
    for R, members in groups.values():
        Rt = np.ascontiguousarray(
            _cat(R[:, 0::2].T, R[:, 1::2].T).T * (1.0 / math.sqrt(2.0)))
        cms = [np.concatenate([C[:, 0::2], C[:, 1::2]], axis=1)
               for _, C in members]
        Cm = np.ascontiguousarray(np.concatenate(cms, axis=1))
        row = _block_strategy(Rt, n_sp, [Rt.shape[0]], [wb, wb], embed)
        col = _block_strategy(Cm, n_h, [Cm.shape[0]],
                              [hb, hb] * len(members), embed)
        lv.append((tuple(_SB_ORIENTS[name] for name, _ in members), row,
                   col))
    return lv


def _block_strategy(T, n, row_blocks, col_blocks, embed):
    """:func:`_embedded_strategy` of ``T`` with ``embed``, else
    :func:`_strategy` (which raises where a block does not divide)."""
    if embed:
        return _embedded_strategy(T, n, row_blocks, col_blocks)[0]
    return _strategy(T, n, row_blocks, col_blocks, wrap=False)


def _low_strategies(R, C, in_hw, n_sp, n_h, embed=False):
    """The (row, column) strategies of a lowpass term R along W and C
    along H on an input of ``in_hw`` (``embed`` as for
    :func:`_band_group_strategies`)."""
    R, C = np.ascontiguousarray(R), np.ascontiguousarray(C)
    return (_block_strategy(R, n_sp, [R.shape[0]], [in_hw[1]], embed),
            _block_strategy(C, n_h, [C.shape[0]], [in_hw[0]], embed))


@budgeted_plan_cache
def _dtcwt_inv_shard_plans(g0o, g1o, g0a, g1a, g0b, g1b, mode, yl_hw,
                           sizes, n_sp, n_h):
    """(per-level group strategies, ll row strategy, ll col strategy) for
    the composed inverse pyramid, or None."""
    plan = _inv_pyramid_plan(g0o, g1o, g0a, g1a, g0b, g1b, mode, yl_hw,
                             sizes)
    if plan is None:
        return None
    levels, ll_spec, _ = plan
    try:
        ginfo = [_band_group_strategies(lev["bands"], hb, wb, n_sp, n_h)
                 for lev, (hb, wb) in zip(levels, sizes)]
        ll_row, ll_col = _low_strategies(*ll_spec, yl_hw, n_sp, n_h)
    except ValueError:
        return None
    return ginfo, ll_row, ll_col


# --------------------------------------------------------------------------
# Per-level plans (host numpy, cached): past the composed route, each
# level's own operators (synthesized from small probes past
# banded.DIRECT_PROBE_N), every one sharded as the composed pyramid's
# --------------------------------------------------------------------------

def pad_widths(n, pad):
    """(before, after) of the replicate pad of a level-1 input axis of
    ``n`` samples: 'even' one sample after an odd axis
    (``dtcwt_xfm._replicate_pad_even``, ``ScatLayer``), 'mod8' up to a
    multiple of 8, split before / after as ``scatternet._pad_mod8`` takes
    it (``ScatLayerj2``: the axis's first samples before, its last ones
    after)."""
    if pad == "even":
        return 0, n % 2
    rem = n % 8
    return ((8 - rem) // 2, (9 - rem) // 2) if rem else (0, 0)


def _pad_matrix(n, pad):
    """The (n', n) selection of :func:`pad_widths`' pad, or None where
    nothing is padded."""
    before, after = pad_widths(n, pad)
    if not (before or after):
        return None
    # the modules' slices x[:before] and x[-after:], as short as the axis
    idx = np.concatenate([np.arange(min(before, n)), np.arange(n),
                          np.arange(max(0, n - after), n)])
    P = np.zeros((len(idx), n), dtype=np.float32)
    P[np.arange(len(idx)), idx] = 1.0
    return P


def _fwd_level_plans(h0o, h1o, h0a, h1a, h0b, h1b, J, skips, mode, H, W,
                     pad="even"):
    """Per-level (uncomposed) forward plans: level j's operators act on
    level j-1's lowpass, the level-1 replicate pad (``pad``, as
    :func:`_pad_matrix`) and the %4 replicate pad between levels composed
    in.  A tuple of (level, (in_h, in_w)), a level as the composed plan's
    (``ll`` always present: it feeds the next level), or None where the
    filters and sizes admit no parity-folded form."""
    out = []
    nh, nw = H, W
    for j in range(J):
        in_hw = (nh, nw)
        if j == 0:
            Ph, Pw = _pad_matrix(nh, pad), _pad_matrix(nw, pad)
            nhp = nh if Ph is None else Ph.shape[0]
            nwp = nw if Pw is None else Pw.shape[0]
            Cl, Ch = (_filter_matrix(h0o, mode, nhp),
                      _filter_matrix(h1o, mode, nhp))
            Rl, Rh = (_filter_matrix(h0o, mode, nwp),
                      _filter_matrix(h1o, mode, nwp))
            if any(m.shape[0] % 2 for m in (Cl, Ch, Rl, Rh)):
                return None
        else:
            Ph, Pw = _pad4_matrix(nh), _pad4_matrix(nw)
            nhp = nh if Ph is None else nh + 2
            nwp = nw if Pw is None else nw + 2
            if nhp % 4 or nwp % 4:
                return None
            Cl, Ch = (_dfilt_matrix(h0b, h0a, False, nhp),
                      _dfilt_matrix(h1b, h1a, True, nhp))
            Rl, Rh = (_dfilt_matrix(h0b, h0a, False, nwp),
                      _dfilt_matrix(h1b, h1a, True, nwp))
            if Cl.shape[0] % 2 or Rl.shape[0] % 2:
                return None
        if Ph is not None:
            Cl, Ch = (np.ascontiguousarray(banded.compose(Cl, Ph)),
                      np.ascontiguousarray(banded.compose(Ch, Ph)))
        if Pw is not None:
            Rl, Rh = (np.ascontiguousarray(banded.compose(Rl, Pw)),
                      np.ascontiguousarray(banded.compose(Rh, Pw)))
        lev = {"bands": None, "ll": (Rl, Cl)}
        if not skips[j]:
            lev["bands"] = [("lh", (Rl, Ch)), ("hl", (Rh, Cl)),
                            ("hh", (Rh, Ch))]
        out.append((lev, in_hw))
        nh, nw = Cl.shape[0], Rl.shape[0]
    return tuple(out)


def embed_blocks(T, n, row_blocks, col_blocks, row_quanta=None):
    """``T`` zero-embedded into shard-divisible storage (the JAX
    package's ``_embed_blocks`` technique for ragged axes): each row
    block (sizes ``row_blocks``) lands at the top of a block of
    ``ceil(size, n * quantum)`` rows (``row_quanta``, 1 each by default;
    2 for a lowpass pooled 2x2 on the tiles next), each column block at
    the left of ``ceil(size, n)`` columns, zeros elsewhere.  The DTCWT's
    and the ISWT's operators never wrap, so the embedded operator
    computes the logical one and keeps the storage tails zero.  Returns
    (the embedded operator, its row blocks' and column blocks' storage
    sizes)."""
    T = np.asarray(T)
    quanta = row_quanta or [1] * len(row_blocks)
    rs = [_ceil_to(b, n * q) for b, q in zip(row_blocks, quanta)]
    cs = [_ceil_to(c, n) for c in col_blocks]
    if rs == list(row_blocks) and cs == list(col_blocks):
        return np.ascontiguousarray(T), rs, cs
    E = np.zeros((sum(rs), sum(cs)), dtype=T.dtype)
    r0 = rr = 0
    for b, bs in zip(row_blocks, rs):
        c0 = cc = 0
        for c, csz in zip(col_blocks, cs):
            E[rr:rr + b, cc:cc + c] = T[r0:r0 + b, c0:c0 + c]
            c0 += c
            cc += csz
        r0 += b
        rr += bs
    return E, rs, cs


def _embedded_strategy(T, n, row_blocks, col_blocks, row_quanta=None):
    """:func:`_strategy` of ``T`` on :func:`embed_blocks`' storage.
    Returns (strategy, the row blocks' storage sizes)."""
    E, rs, cs = embed_blocks(T, n, row_blocks, col_blocks, row_quanta)
    return _strategy(E, n, rs, cs, wrap=False), rs


class _LevelSizes(NamedTuple):
    """A per-level forward level's logical sizes: its lowpass (h, w) and
    its bands' (h, w) (None for a skipped level)."""
    ll: tuple
    bands: object


@budgeted_plan_cache
def _dtcwt_fwd_perlevel_shard_plans(h0o, h1o, h0a, h1a, h0b, h1b, J,
                                    skips, mode, H, W, n_sp, n_h,
                                    pad="even", pool=False):
    """The per-level route's forward plans on zero-embedded storage, for
    an (H, W) input of any size (its storage ``ceil(H, n_h)`` x
    ``ceil(W, n_sp)``; the level-1 pad folded into level 1): per level
    ((stage-1 strategy over 'spatial', [stage-2 entry]), its
    :class:`_LevelSizes`), or None.  ``pool``: the last lowpass is pooled
    2x2 on the tiles next, so its storage is a multiple of twice the
    shard counts."""
    levels = _fwd_level_plans(h0o, h1o, h0a, h1a, h0b, h1b, J, skips,
                              mode, H, W, pad)
    if levels is None:
        return None
    plans = []
    for j, (lev, (in_h, in_w)) in enumerate(levels):
        q_ll = 2 if pool and j == J - 1 else 1
        blocks, groups = [], []
        for R, members in _member_groups(lev["bands"] or ()):
            blocks += [R[0::2], R[1::2]]
            groups.append(members)
        Rl, Cl = lev["ll"]
        blocks.append(Rl)
        st1, rs = _embedded_strategy(
            _cat(*blocks), n_sp, [b.shape[0] for b in blocks], [in_w],
            [1] * (len(blocks) - 1) + [q_ll])
        entry = {"groups": [], "ll": None}
        go = 0
        for g, members in enumerate(groups):
            m = members[0][1][0::2].shape[0]
            st2, _ = _embedded_strategy(_cstack(members), n_h,
                                        [m] * (2 * len(members)), [in_h])
            gn = rs[2 * g] + rs[2 * g + 1]
            entry["groups"].append(
                (tuple(_SB_ORIENTS[name] for name, _ in members), go, gn,
                 st2))
            go += gn
        st_ll, _ = _embedded_strategy(Cl, n_h, [Cl.shape[0]], [in_h],
                                      [q_ll])
        entry["ll"] = (go, rs[-1], st_ll)
        bands = None
        if groups:
            bands = (groups[0][0][1][0::2].shape[0], blocks[0].shape[0])
        plans.append(((st1, (entry,)),
                      _LevelSizes((Cl.shape[0], Rl.shape[0]), bands)))
    return tuple(plans)


def _crop_sel(n, cur):
    """The [1:-1] crop of a lowpass two samples longer than ``n``."""
    K = np.zeros((n, cur), dtype=np.float32)
    K[np.arange(n), np.arange(1, n + 1)] = 1.0
    return K


@budgeted_plan_cache
def _dtcwt_inv_perlevel_shard_plans(g0o, g1o, g0a, g1a, g0b, g1b, mode,
                                    yl_hw, sizes, n_sp, n_h):
    """Coarse-first per-level synthesis plans on zero-embedded storage
    (each coefficient's storage ``ceil(size, n)`` along a sharded axis):
    (per level (its band groups' strategies, or () for a missing level;
    the lowpass's row and column strategies, the [1:-1] crop composed
    in), the output's logical (h, w)), or None."""
    cur_h, cur_w = yl_hw
    levels = []
    for j in range(len(sizes) - 1, -1, -1):
        if sizes[j] is None:
            # a missing level: the lowpass alone, its size passed on
            # uncropped (the composed plan's walk rule)
            nh, nw = cur_h, cur_w
            if j == 0:
                # the reference's lowpass-only branch filters in its
                # default 'symmetric' mode, not the caller's
                # (reference dtcwt/transform_funcs.py:166-177)
                C0 = _filter_matrix(g0o, "symmetric", nh)
                R0 = _filter_matrix(g0o, "symmetric", nw)
            else:
                if nh % 2 or nw % 2:
                    return None
                C0 = _ifilt_matrix(g0b, g0a, False, nh)
                R0 = _ifilt_matrix(g0b, g0a, False, nw)
            levels.append(((), *_low_strategies(R0, C0, (nh, nw), n_sp,
                                                n_h, True)))
            cur_h, cur_w = C0.shape[0], R0.shape[0]
            continue
        hb, wb = sizes[j]
        nh, nw = 2 * hb, 2 * wb
        if cur_h not in (nh, nh + 2) or cur_w not in (nw, nw + 2):
            return None
        if j == 0:
            C0, C1 = (_filter_matrix(g0o, mode, nh),
                      _filter_matrix(g1o, mode, nh))
            R0, R1 = (_filter_matrix(g0o, mode, nw),
                      _filter_matrix(g1o, mode, nw))
        else:
            C0, C1 = (_ifilt_matrix(g0b, g0a, False, nh),
                      _ifilt_matrix(g1b, g1a, True, nh))
            R0, R1 = (_ifilt_matrix(g0b, g0a, False, nw),
                      _ifilt_matrix(g1b, g1a, True, nw))
        lv = _band_group_strategies(
            [("lh", (R0, C1)), ("hl", (R1, C0)), ("hh", (R1, C1))], hb,
            wb, n_sp, n_h, True)
        Rl = R0 if cur_w == nw else banded.compose(R0, _crop_sel(nw, cur_w))
        Cl = C0 if cur_h == nh else banded.compose(C0, _crop_sel(nh, cur_h))
        levels.append((lv, *_low_strategies(Rl, Cl, (cur_h, cur_w), n_sp,
                                            n_h, True)))
        cur_h, cur_w = C0.shape[0], R0.shape[0]
    return tuple(levels), (cur_h, cur_w)


# --------------------------------------------------------------------------
# The local pyramids
# --------------------------------------------------------------------------

def _sharded_pyramid(xl, o_dim, ri_dim, st_w, s2, sp, hh):
    """Composed analysis pyramid on local tiles: stage 1 over 'spatial'
    under its strategy ``st_w``, then per-group stage 2 over 'spatial_h'
    (local when H is not sharded), then K2.  Mirrors
    ``ops/fused_dtcwt.py:_analysis`` with every global offset divided by
    the shard counts."""
    z = _apply_strategy(xl, st_w, 3, sp)
    lls, highs = [], []
    for e in s2:
        ys = [_apply_strategy(z[..., go // sp.n:(go + gn) // sp.n], strat,
                              2, hh)
              for _, go, gn, strat in e["groups"]]
        orients = tuple(ors for ors, _, _, _ in e["groups"])
        highs.append(_QuadsToBands.apply((orients, o_dim, ri_dim), *ys)
                     if ys else None)
        if e["ll"] is not None:
            go, gn, strat = e["ll"]
            lls.append(_apply_strategy(z[..., go // sp.n:(go + gn) // sp.n],
                                       strat, 2, hh))
        else:
            lls.append(None)
    return lls, highs


def _sharded_synthesis(ll, hs, plans, o_dim, ri_dim, sp, hh):
    """Composed synthesis pyramid on local tiles: per level K3, then per
    subband group the row merge over 'spatial' and the column operator
    over 'spatial_h', summed with the lowpass term."""
    ginfo, ll_row, ll_col = plans
    y = None
    for h, lv in zip(hs, ginfo):
        qs = _BandsToQuads.apply((tuple(g[0] for g in lv), o_dim, ri_dim),
                                 h)
        for q, (_, row, col) in zip(qs, lv):
            t = _apply_merge(q, row, 3, sp)
            contrib = _apply_strategy(t, col, 2, hh)
            y = contrib if y is None else y + contrib
    t_ll = _apply_strategy(ll, ll_row, 3, sp)
    return y + _apply_strategy(t_ll, ll_col, 2, hh)


def _sharded_levels(xl, plans, o_dim, ri_dim, sp, hh):
    """The per-level analysis on local tiles: each level one
    :func:`_sharded_pyramid` on its own plan (as
    :func:`_dtcwt_fwd_perlevel_shard_plans` makes them), fed the last
    level's lowpass tiles.  Returns (every level's lowpass, every level's
    bands or None)."""
    ll, lls, highs = xl, [], []
    for (op, s2), _ in plans:
        ls, hs = _sharded_pyramid(ll, o_dim, ri_dim, op, s2, sp, hh)
        ll = ls[0]
        lls.append(ll)
        highs.append(hs[0])
    return lls, highs


def _sharded_synthesis_levels(ll, hs, plans, o_dim, ri_dim, sp, hh):
    """The per-level synthesis on local tiles, coarse to fine: per level
    its band groups as :func:`_sharded_synthesis` runs them (none for a
    missing level, ``hs[j]`` None), plus its lowpass term (none for a
    missing lowpass, ``ll`` None: it starts the coarsest level)."""
    for (lv, ll_row, ll_col), h in zip(plans, hs[::-1]):
        low = None
        if ll is not None:
            t_ll = _apply_strategy(ll, ll_row, 3, sp)
            low = _apply_strategy(t_ll, ll_col, 2, hh)
        if h is None:
            ll = low
            continue
        qs = _BandsToQuads.apply((tuple(g[0] for g in lv), o_dim, ri_dim),
                                 h)
        y = None
        for q, (_, row, col) in zip(qs, lv):
            t = _apply_merge(q, row, 3, sp)
            contrib = _apply_strategy(t, col, 2, hh)
            y = contrib if y is None else y + contrib
        ll = y if low is None else y + low
    return ll


# --------------------------------------------------------------------------
# DTensors in and out
# --------------------------------------------------------------------------

def _ceil_to(n, q):
    return -(-n // q) * q


def _pad_axis_to(a, n_to, axis=0):
    """Zero-pad ``a`` along ``axis`` up to length ``n_to`` (transforms
    are per sample along the batch axis, so padded rows are dropped
    after the sharded call)."""
    d = n_to - a.shape[axis]
    if d == 0:
        return a
    shape = list(a.shape)
    shape[axis] = d
    return torch.cat([a, a.new_zeros(shape)], dim=axis)


def _yh_batch_axis6(o_dim, ri_dim):
    """Batch axis of a 6-D bandpass tensor in any o_dim/ri_dim layout
    (same derivation as _dtcwt_yh_spec)."""
    od6, rd = o_dim % 6, ri_dim % 6
    _, _, h6, w6 = get_dimensions6(o_dim, ri_dim)
    return [i for i in range(6) if i not in (od6, rd, h6, w6)][0]


def _dtcwt_yh_spec(o_dim, ri_dim, hx):
    """Spec of a 6-D bandpass tensor in any o_dim/ri_dim layout: H over
    ``hx`` ('spatial_h' or None), W over 'spatial', batch over 'data' at
    whichever axis the stack insertions left it."""
    _, _, h6, w6 = get_dimensions6(o_dim, ri_dim)
    spec = [None] * 6
    spec[h6], spec[w6] = hx, "spatial"
    spec[_yh_batch_axis6(o_dim, ri_dim)] = "data"
    return tuple(spec)


def _sp4(mesh):
    hx = "spatial_h" if "spatial_h" in mesh.mesh_dim_names else None
    return ("data", None, hx, "spatial")


def _local(x, mesh, spec, what, batch_axis, storage=None):
    """This rank's chunk of ``x`` placed as ``spec``, its batch padded
    with zeros to a multiple of the 'data' size: a DTensor's local tensor
    (placed so; a short last chunk padded), or the slices of a full
    tensor (padded first).  ``storage`` {dim: length} zero-pads those
    dims to shard-divisible storage (a multiple of the dim's shard count):
    a full tensor before it is sliced, a DTensor's chunk (``torch.chunk``'s
    layout, ceil(M / n) a rank, the last ones short) on each rank to
    length / n."""
    nd = _n_data(mesh)
    s = _ceil_to(x.shape[batch_axis], nd) // nd
    storage = storage or {}
    if isinstance(x, DTensor):
        want = placements(mesh, spec)
        if x.device_mesh != mesh or list(x.placements) != want:
            raise ValueError(f"{what}: expected a DTensor on this mesh "
                             f"placed {want}, got {list(x.placements)}")
        xl = _pad_axis_to(x.to_local(), s, batch_axis)
        for d, n in storage.items():
            xl = _pad_axis_to(xl, n // _axis(mesh, spec[d]).n, d)
        return xl
    x = _pad_axis_to(x, s * nd, batch_axis)
    for d, n in storage.items():
        x = _pad_axis_to(x, n, d)
    for d, name in enumerate(spec):
        if name is None:
            continue
        ax = _axis(mesh, name)
        if x.shape[d] % ax.n:
            raise ValueError(f"{what}: dim {d} of {tuple(x.shape)} does not "
                             f"divide over the {ax.n} '{name}' ranks")
        k = x.shape[d] // ax.n
        x = x.narrow(d, ax.rank * k, k)
    return x


def _global(local, mesh, spec, n_batch, batch_axis, logical=None):
    """A DTensor of ``local`` placed as ``spec``, its batch axis cut to
    ``n_batch`` and each dim of ``logical`` {dim: length} cut from its
    storage to that length: a per-rank ``narrow``, so that the ranks hold
    ``torch.chunk``'s split of the cut tensor."""
    shape = list(local.shape)
    for d, name in enumerate(spec):
        if name is not None:
            shape[d] *= _axis(mesh, name).n
    for d, M in {batch_axis: n_batch, **(logical or {})}.items():
        s = local.shape[d]
        d0 = (_axis(mesh, spec[d]).rank if spec[d] else 0) * s
        keep = max(0, min(s, M - d0))
        if keep != s:
            local = local.narrow(d, 0, keep)
        shape[d] = M
    stride, acc = [0] * len(shape), 1
    for d in range(len(shape) - 1, -1, -1):
        stride[d] = acc
        acc *= shape[d]
    return DTensor.from_local(local, mesh, placements(mesh, spec),
                              run_check=False, shape=torch.Size(shape),
                              stride=tuple(stride))


# --------------------------------------------------------------------------
# The public entries
# --------------------------------------------------------------------------

def _dtcwt_taps(filters, prefix):
    """The six tap tuples of a DTCWT filter dict, in the plans' order
    (``prefix`` 'h' for the analysis bank, 'g' for the synthesis one)."""
    return tuple(filters[prefix + k] for k in ("0o", "1o", "0a", "1a", "0b",
                                               "1b"))


def sharded_dtcwt2d(x, mesh, filters, J=3, mode="symmetric",
                    skip_hps=False, include_scale=False, o_dim=2,
                    ri_dim=-1):
    """DTCWT forward with the batch over 'data' and W over 'spatial' (and
    H over 'spatial_h' on a 2-D mesh), on one of three routes
    (``LAST_PATH['dtcwt2d']``): the composed pyramid as halo'd per-rank
    operator chunks where it has a plan ('matmul'); else, on the operator
    route (``banded.set_operator_matmul`` None or True, axes of at most
    32768), level by level on zero-embedded storage ('perlevel': an axis
    past 8832, a halo wider than the tile, tiles that do not divide, odd
    sizes); else the stencil halo route of ``parallel/sharded_conv.py``
    ('conv').

    x: an (N, C, H, W) DTensor placed as ``parallel.spatial_placements``
    (any H and W: an odd size takes the replicate even pad inside level
    1), or the full tensor on every rank (an odd size is padded even
    first, and a batch that does not divide over 'data' is zero-padded
    and cut again, as in the JAX package).  filters: dict from
    ``transforms/dtcwt_xfm.py:dtcwt_fwd_filters``.  ``skip_hps`` /
    ``include_scale`` / ``o_dim`` / ``ri_dim`` as for ``DTCWTForward``.
    Returns (yl, yh) DTensors: yl (or the list of scales) placed as x, yh
    with H / W / batch on their 6-D axes."""
    _check_mesh(mesh)
    if o_dim % 6 == ri_dim % 6:
        raise ValueError("Orientations and real/imaginary parts must be "
                         "in different dimensions.")
    if not isinstance(skip_hps, (list, tuple)):
        skip_hps = [skip_hps] * J
    if not isinstance(include_scale, (list, tuple)):
        include_scale = [include_scale] * J
    sp4 = _sp4(mesh)
    N = x.shape[0]
    if not isinstance(x, DTensor):
        x = _replicate_pad_even(x)
    H, W = x.shape[2], x.shape[3]
    n_h, n_sp = _mesh_sp(mesh)
    taps = _dtcwt_taps(filters, "h")
    plans = perlevel = None
    if (J > 0 and H % 2 == 0 and W % 2 == 0 and W % n_sp == 0
            and H % n_h == 0 and _mm_enabled(H) and _mm_enabled(W)):
        plans = _dtcwt_fwd_shard_plans(
            *taps, J, tuple(skip_hps), tuple(include_scale), mode, H, W,
            n_sp, n_h)
    if (plans is None and J > 0 and _sharded_mm_wanted(H)
            and _sharded_mm_wanted(W)):
        perlevel = _dtcwt_fwd_perlevel_shard_plans(
            *taps, J, tuple(skip_hps), mode, H, W, n_sp, n_h)
    if plans is None and perlevel is None:
        from pytorch_wavelets_tpu_torch.parallel.sharded_conv import (
            conv_dtcwt2d,
        )
        return conv_dtcwt2d(x, mesh, filters, J, mode, skip_hps,
                            include_scale, o_dim, ri_dim)
    xl = _local(x, mesh, sp4, "sharded_dtcwt2d", 0,
                {2: _ceil_to(H, n_h), 3: _ceil_to(W, n_sp)}).contiguous()
    od, rd, _, _ = get_dimensions5(o_dim, ri_dim)
    sp, hh = _axis(mesh, "spatial"), _axis(mesh, "spatial_h")
    _, _, h6, w6 = get_dimensions6(o_dim, ri_dim)
    b6 = _yh_batch_axis6(o_dim, ri_dim)
    yh_spec = _dtcwt_yh_spec(o_dim, ri_dim, sp4[2])
    if plans is not None:
        lls, highs = _sharded_pyramid(xl, od, rd, *plans, sp, hh)
        LAST_PATH["dtcwt2d"] = "matmul"
        yh = [None if h is None else _global(h, mesh, yh_spec, N, b6)
              for h in highs]
        lls = [None if ll is None else _global(ll, mesh, sp4, N, 0)
               for ll in lls]
    else:
        lls, highs = _sharded_levels(xl, perlevel, od, rd, sp, hh)
        LAST_PATH["dtcwt2d"] = "perlevel"
        sizes = [s for _, s in perlevel]
        yh = [None if h is None else
              _global(h, mesh, yh_spec, N, b6,
                      {h6: s.bands[0], w6: s.bands[1]})
              for h, s in zip(highs, sizes)]
        lls = [_global(ll, mesh, sp4, N, 0, {2: s.ll[0], 3: s.ll[1]})
               for ll, s in zip(lls, sizes)]
    if True in include_scale:
        return [lls[j] if include_scale[j] else None for j in range(J)], yh
    return lls[-1], yh


def _perlevel_dims(yl_hw, sizes):
    """Every axis length the per-level inverse runs at (the JAX package's
    envelope check): each level's input, coarse to fine, a missing level
    passing the running lowpass size on uncropped; None where a missing
    level gets an odd size."""
    cur_h, cur_w = yl_hw
    ns = []
    for j in range(len(sizes) - 1, -1, -1):
        if sizes[j] is not None:
            cur_h, cur_w = 2 * sizes[j][0], 2 * sizes[j][1]
        elif j > 0 and (cur_h % 2 or cur_w % 2):
            return None
        ns += [cur_h, cur_w]
        if j > 0:
            cur_h, cur_w = 2 * cur_h, 2 * cur_w
    return ns + [2 * yl_hw[0], 2 * yl_hw[1]]


def sharded_idtcwt2d(coeffs, mesh, filters, mode="symmetric", o_dim=2,
                     ri_dim=-1):
    """DTCWT inverse on a mesh (1-D W or 2-D HxW tiling): per subband
    group K3, the halo'd row merge and the column operator, summed with
    the lowpass term; as one composed pyramid where it has a plan and
    every coefficient is present (``LAST_PATH['idtcwt2d']`` 'matmul'),
    else on the operator route level by level on zero-embedded storage
    ('perlevel': a missing lowpass or level, ``None`` or a size-0
    placeholder, counts as zeros, as in the JAX package; any band sizes),
    else on the stencil halo route of ``parallel/sharded_conv.py``
    ('conv').  Without the lowpass the coarsest present level starts from
    no lowpass term, and missing levels below none add nothing, as in
    ``transforms/dtcwt_xfm.py:idtcwt2d``.

    coeffs: (yl, yh) as :func:`sharded_dtcwt2d` returns them (DTensors),
    or full tensors on every rank.  filters: dict from
    ``transforms/dtcwt_xfm.py:dtcwt_inv_filters``.  Returns the
    reconstruction as an (N, C, H, W) DTensor placed as yl."""
    _check_mesh(mesh)
    low, highs = coeffs
    highs = [None if h is None or h.numel() == 0 else h for h in highs]
    od5, rd5, _, _ = get_dimensions5(o_dim, ri_dim)
    _, _, h6, w6 = get_dimensions6(o_dim, ri_dim)
    b6 = _yh_batch_axis6(o_dim, ri_dim)
    n_h, n_sp = _mesh_sp(mesh)
    sp4 = _sp4(mesh)
    yh_spec = _dtcwt_yh_spec(o_dim, ri_dim, sp4[2])
    for h in highs:
        if h is not None and (h.ndim != 6 or h.shape[o_dim % 6] != 6
                              or h.shape[ri_dim % 6] != 2):
            raise ValueError(f"sharded_idtcwt2d: bands {tuple(h.shape)} "
                             f"are not 6-D with 6 orientations at o_dim "
                             f"and re/im at ri_dim")
    if low is None:
        # the levels coarser than the coarsest present one add nothing
        while highs and highs[-1] is None:
            highs.pop()
    if not highs and low is None:
        raise ValueError("sharded_idtcwt2d: no lowpass and no bandpass to "
                         "invert")
    if not highs:
        raise ValueError("sharded_idtcwt2d: no bandpass levels")
    sizes = tuple(None if h is None else (h.shape[h6], h.shape[w6])
                  for h in highs)
    yl_hw = ((low.shape[2], low.shape[3]) if low is not None
             else (2 * sizes[-1][0], 2 * sizes[-1][1]))
    taps = _dtcwt_taps(filters, "g")
    plans = perlevel = None
    if (low is not None and None not in sizes
            and all(_mm_enabled(2 * d) for hw in sizes + (yl_hw,)
                    for d in hw)):
        plans = _dtcwt_inv_shard_plans(*taps, mode, yl_hw, sizes, n_sp,
                                       n_h)
    dims = _perlevel_dims(yl_hw, sizes)
    if (plans is None and dims is not None
            and all(_sharded_mm_wanted(d) for d in dims)):
        perlevel = _dtcwt_inv_perlevel_shard_plans(*taps, mode, yl_hw,
                                                   sizes, n_sp, n_h)
    if plans is None and perlevel is None:
        from pytorch_wavelets_tpu_torch.parallel.sharded_conv import (
            conv_idtcwt2d,
        )
        return conv_idtcwt2d(low, highs, mesh, filters, mode, o_dim,
                             ri_dim)
    N = low.shape[0] if low is not None else highs[-1].shape[b6]

    def storage(hw, dh, dw):
        """The per-level route's zero-embedded storage of a coefficient
        of logical (h, w) on dims (dh, dw)."""
        if plans is not None:
            return None
        return {dh: _ceil_to(hw[0], n_h), dw: _ceil_to(hw[1], n_sp)}
    hs = [None if h is None else
          _local(h, mesh, yh_spec, "sharded_idtcwt2d", b6,
                 storage(hw, h6, w6))
          for h, hw in zip(highs, sizes)]
    ll = None
    if low is not None:
        ll = _local(low, mesh, sp4, "sharded_idtcwt2d", 0,
                    storage(yl_hw, 2, 3)).contiguous()
    sp, hh = _axis(mesh, "spatial"), _axis(mesh, "spatial_h")
    if plans is not None:
        y = _sharded_synthesis(ll, hs, plans, od5, rd5, sp, hh)
        LAST_PATH["idtcwt2d"] = "matmul"
        return _global(y, mesh, sp4, N, 0)
    levels, out_hw = perlevel
    y = _sharded_synthesis_levels(ll, hs, levels, od5, rd5, sp, hh)
    LAST_PATH["idtcwt2d"] = "perlevel"
    return _global(y, mesh, sp4, N, 0, {2: out_hw[0], 3: out_hw[1]})


def _tree_map(fn, tree):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    return None if tree is None else fn(tree)


def _first_leaf(tree):
    if isinstance(tree, (list, tuple)):
        for t in tree:
            leaf = _first_leaf(t)
            if leaf is not None:
                return leaf
        return None
    return tree


def sharded_batch_apply(fn, tree, mesh, what):
    """Batch data parallelism for a transform without a sharded plan (the
    JAX package's ``_gspmd_apply``, which batch-shards every leaf over
    'data'): every tensor leaf of ``tree`` (nested lists / tuples, None
    passing through) split over 'data' along its first dim, a DTensor
    placed so (replicated over the other mesh dims) or the full tensor on
    every rank, a batch that does not divide zero-padded; ``fn`` runs the
    transform without a mesh on the rank's chunk; every tensor leaf of its
    result comes back a DTensor placed so, cut to the batch."""
    _check_mesh(mesh)
    N = _first_leaf(tree).shape[0]

    def spec(t):
        return ("data",) + (None,) * (t.ndim - 1)
    local = _tree_map(lambda t: _local(t, mesh, spec(t), what, 0), tree)
    return _tree_map(lambda t: _global(t, mesh, spec(t), N, 0), fn(local))
