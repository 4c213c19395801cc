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

Where the JAX package leaves the composed route (its per-level sharded
path past the composed cap, or GSPMD), the port raises
``NotImplementedError`` (``ROADMAP.md`` A5d / A5e); it never gathers the
image.  The host planners are numpy copies of the JAX ones.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from pytorch_wavelets_tpu_torch.ops import banded
from pytorch_wavelets_tpu_torch.ops._linear import linear_backward
from pytorch_wavelets_tpu_torch.ops.banded import Operator
from pytorch_wavelets_tpu_torch.ops.fused_dtcwt import (
    _SB_ORIENTS, _cat, _cstack, _pyramid_layout, canonical_bands,
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
    _fwd_pyramid_plan, _inv_pyramid_plan, get_dimensions5, get_dimensions6,
)
from pytorch_wavelets_tpu_torch.transforms.dtcwt_xfm import (
    _replicate_pad_even,
)
from pytorch_wavelets_tpu_torch.transforms.plan_cache import (
    budgeted_plan_cache,
)

__all__ = ["sharded_dtcwt2d", "sharded_idtcwt2d", "LAST_PATH"]

# Which path each public sharded_* entry last took: name -> 'matmul' (the
# composed sharded route, the only one ported; the JAX package also has
# 'perlevel' and 'gspmd').
LAST_PATH: dict = {}

_NOT_PORTED = ("the per-level sharded DTCWT past the composed route "
               "(ROADMAP.md A5d) and the GSPMD fallbacks (A5e) are not "
               "ported")


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
        for s in row_blocks:
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
    w = q.shape[axis] // 2
    lo, hi = q.narrow(axis, 0, w), q.narrow(axis, w, w)
    if strat.kind == "shard":
        return apply_sharded_op([lo, hi], strat.obj, axis, ax.group)
    if strat.kind == "local":
        return operator_apply(q, *strat.operators(q.device), axis)
    return _gathered_apply([lo, hi], strat, axis, ax)


# --------------------------------------------------------------------------
# Composed-pyramid plans (host numpy, cached)
# --------------------------------------------------------------------------

def _pyramid_shard_op(plan, W, n_sp):
    """The ShardedOp of a composed pyramid's stage-1 row operator (every
    block tiled over the spatial axis); None when the layout does not
    divide or the halo exceeds a tile."""
    blocks, _ = _pyramid_layout(plan)
    try:
        return build_sharded_op(_cat(*blocks), n_sp,
                                [b.shape[0] for b in blocks], [W],
                                wrap=False)
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
    sqrt2 = math.sqrt(2.0)
    try:
        ginfo = []                         # per level: list of group plans
        for lev, (hb, wb) in zip(levels, sizes):
            groups: dict = {}
            for name, (R, C) in lev["bands"]:
                groups.setdefault(id(R), (R, []))[1].append((name, C))
            lv = []
            for R, members in groups.values():
                Rt = np.ascontiguousarray(
                    _cat(R[:, 0::2].T, R[:, 1::2].T).T * (1.0 / sqrt2))
                row = _strategy(Rt, n_sp, [Rt.shape[0]], [wb, wb],
                                wrap=False)
                cms = [np.concatenate([C[:, 0::2], C[:, 1::2]], axis=1)
                       for _, C in members]
                Cm = np.ascontiguousarray(np.concatenate(cms, axis=1))
                col = _strategy(Cm, n_h, [Cm.shape[0]],
                                [hb, hb] * len(members), wrap=False)
                lv.append((tuple(_SB_ORIENTS[name] for name, _ in members),
                           row, col))
            ginfo.append(lv)
        R_ll, C_ll = ll_spec
        ll_row = _strategy(np.ascontiguousarray(R_ll), n_sp,
                           [R_ll.shape[0]], [yl_hw[1]], wrap=False)
        ll_col = _strategy(np.ascontiguousarray(C_ll), n_h,
                           [C_ll.shape[0]], [yl_hw[0]], wrap=False)
    except ValueError:
        return None
    return ginfo, ll_row, ll_col


# --------------------------------------------------------------------------
# The local pyramids
# --------------------------------------------------------------------------

def _sharded_pyramid(xl, o_dim, ri_dim, op_w, s2, sp, hh):
    """Composed analysis pyramid on local tiles: sharded stage 1 over
    'spatial', then per-group stage 2 over 'spatial_h' (local when H is
    not sharded), then K2.  Mirrors ``ops/fused_dtcwt.py:_analysis`` with
    every global offset divided by the shard counts."""
    z = apply_sharded_op([xl], op_w, 3, sp.group)
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


def _local(x, mesh, spec, what, batch_axis):
    """This rank's chunk of ``x`` placed as ``spec``, its batch padded
    with zeros to a multiple of the 'data' size: a DTensor's local tensor
    (placed so; a short last chunk padded), or the slices of a full
    tensor (padded first)."""
    nd = _n_data(mesh)
    s = _ceil_to(x.shape[batch_axis], nd) // nd
    if isinstance(x, DTensor):
        want = placements(mesh, spec)
        if x.device_mesh != mesh or list(x.placements) != want:
            raise ValueError(f"{what}: expected a DTensor on this mesh "
                             f"placed {want}, got {list(x.placements)}")
        return _pad_axis_to(x.to_local(), s, batch_axis)
    x = _pad_axis_to(x, s * nd, batch_axis)
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


def _global(local, mesh, spec, n_batch, batch_axis):
    """A DTensor of ``local`` placed as ``spec``, its batch axis cut to
    ``n_batch`` (the chunks of the padded batch, as ``torch.chunk``
    splits ``n_batch``)."""
    shape = list(local.shape)
    for d, name in enumerate(spec):
        if name is not None:
            shape[d] *= _axis(mesh, name).n
    s = local.shape[batch_axis]
    d0 = _axis(mesh, "data").rank * s
    keep = max(0, min(s, n_batch - d0))
    if keep != s:
        local = local.narrow(batch_axis, 0, keep)
    shape[batch_axis] = n_batch
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

def sharded_dtcwt2d(x, mesh, filters, J=3, mode="symmetric",
                    skip_hps=False, include_scale=False, o_dim=2,
                    ri_dim=-1):
    """DTCWT forward with the batch over 'data' and W over 'spatial' (and
    H over 'spatial_h' on a 2-D mesh): the composed pyramid as halo'd
    per-rank operator chunks.

    x: an (N, C, H, W) DTensor placed as ``parallel.spatial_placements``,
    or the full tensor on every rank (odd sizes take the replicate even
    pad, and a batch that does not divide over 'data' is zero-padded and
    cut again, as in the JAX package).  filters: dict from
    ``transforms/dtcwt_xfm.py:dtcwt_fwd_filters``.  ``skip_hps`` /
    ``include_scale`` / ``o_dim`` / ``ri_dim`` as for ``DTCWTForward``.
    Returns (yl, yh) DTensors: yl (or the list of scales) placed as x, yh
    with H / W / batch on their 6-D axes.  Raises NotImplementedError
    where no composed sharded plan exists."""
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
    plans = None
    if (J > 0 and H % 2 == 0 and W % 2 == 0
            and banded.composed_enabled(H) and banded.composed_enabled(W)
            and W % n_sp == 0 and H % n_h == 0):
        plans = _dtcwt_fwd_shard_plans(
            filters["h0o"], filters["h1o"], filters["h0a"], filters["h1a"],
            filters["h0b"], filters["h1b"], J, tuple(skip_hps),
            tuple(include_scale), mode, H, W, n_sp, n_h)
    if plans is None:
        raise NotImplementedError(
            f"sharded_dtcwt2d: no composed sharded plan for a "
            f"{tuple(x.shape)} input, J={J}, mode={mode!r} on a "
            f"{n_h}x{n_sp} spatial mesh; {_NOT_PORTED}")
    xl = _local(x, mesh, sp4, "sharded_dtcwt2d", 0).contiguous()
    od, rd, _, _ = get_dimensions5(o_dim, ri_dim)
    op, s2 = plans
    lls, highs = _sharded_pyramid(xl, od, rd, op, s2,
                                  _axis(mesh, "spatial"),
                                  _axis(mesh, "spatial_h"))
    LAST_PATH["dtcwt2d"] = "matmul"
    b6 = _yh_batch_axis6(o_dim, ri_dim)
    yh_spec = _dtcwt_yh_spec(o_dim, ri_dim, sp4[2])
    yh = [None if h is None else _global(h, mesh, yh_spec, N, b6)
          for h in highs]
    if True in include_scale:
        return [_global(lls[j], mesh, sp4, N, 0) if include_scale[j]
                else None for j in range(J)], yh
    return _global(lls[-1], mesh, sp4, N, 0), yh


def sharded_idtcwt2d(coeffs, mesh, filters, mode="symmetric", o_dim=2,
                     ri_dim=-1):
    """DTCWT inverse on a mesh (the composed pyramid, 1-D W or 2-D HxW
    tiling): per subband group K3, the halo'd row merge and the column
    operator, summed with the lowpass term.

    coeffs: (yl, yh) as :func:`sharded_dtcwt2d` returns them (DTensors),
    or full tensors on every rank.  filters: dict from
    ``transforms/dtcwt_xfm.py:dtcwt_inv_filters``.  Returns the
    reconstruction as an (N, C, H, W) DTensor placed as yl.  The composed
    route needs the lowpass and every level's bands; without them, or
    where no plan exists, raises NotImplementedError."""
    _check_mesh(mesh)
    low, highs = coeffs
    od5, rd5, _, _ = get_dimensions5(o_dim, ri_dim)
    _, _, h6, w6 = get_dimensions6(o_dim, ri_dim)
    b6 = _yh_batch_axis6(o_dim, ri_dim)
    n_h, n_sp = _mesh_sp(mesh)
    sp4 = _sp4(mesh)
    yh_spec = _dtcwt_yh_spec(o_dim, ri_dim, sp4[2])
    if low is None or any(h is None or h.numel() == 0 for h in highs):
        raise NotImplementedError(
            f"sharded_idtcwt2d: the composed route needs the lowpass and "
            f"every level's bands; {_NOT_PORTED}")
    for h in highs:
        if (h.ndim != 6 or h.shape[o_dim % 6] != 6
                or h.shape[ri_dim % 6] != 2):
            raise ValueError(f"sharded_idtcwt2d: bands {tuple(h.shape)} "
                             f"are not 6-D with 6 orientations at o_dim "
                             f"and re/im at ri_dim")
    N = low.shape[0]
    sizes = tuple((h.shape[h6], h.shape[w6]) for h in highs)
    yl_hw = (low.shape[2], low.shape[3])
    dims = [d for hw in sizes for d in hw] + list(yl_hw)
    plans = None
    if all(banded.composed_enabled(2 * d) for d in dims):
        plans = _dtcwt_inv_shard_plans(
            filters["g0o"], filters["g1o"], filters["g0a"], filters["g1a"],
            filters["g0b"], filters["g1b"], mode, yl_hw, sizes, n_sp, n_h)
    if plans is None:
        raise NotImplementedError(
            f"sharded_idtcwt2d: no composed sharded plan for lowpass "
            f"{yl_hw} and bands {sizes}, mode={mode!r} on a {n_h}x{n_sp} "
            f"spatial mesh; {_NOT_PORTED}")
    ll = _local(low, mesh, sp4, "sharded_idtcwt2d", 0).contiguous()
    hs = [_local(h, mesh, yh_spec, "sharded_idtcwt2d", b6) for h in highs]
    y = _sharded_synthesis(ll, hs, plans, od5, rd5, _axis(mesh, "spatial"),
                           _axis(mesh, "spatial_h"))
    LAST_PATH["idtcwt2d"] = "matmul"
    return _global(y, mesh, sp4, N, 0)
