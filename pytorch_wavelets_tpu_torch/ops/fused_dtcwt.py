"""Whole-transform DTCWT pyramids as operator products, and kernels K2/K3.

Port of ``pytorch_wavelets_tpu/ops/fused_dtcwt.py``.  Every DTCWT level
is linear, so the planners (``transforms/dtcwt.py``) compose each level's
separable operators through the lowpass chain; the corner parities of
q2c/c2q fold into the operators' row/column parities.

- Forward (:func:`analysis_pyramid`, JAX ``_analysis_pyramid_impl``):
  one stage-1 row product with every row operator stacked (K1 row), one
  stage-2 column product per subband group over its slice of the stage-1
  output (K1 column), then K2 (``ops/quad.py:q2c_pack``) writes the
  butterfly straight into the level's bandpass tensor.
- Inverse (:func:`synthesis_pyramid`): per subband group K3
  (``ops/quad.py:c2q_unpack``) combines the orientation pairs into quadrant
  planes, a K1 row product applies the group's row operator, and every
  column product accumulates into the one output (K1 column with
  accumulate: JAX ``_sum_col_apply``).

Both pyramids are ``torch.autograd.Function``s whose backwards run the
same kernels in their adjoint roles, on the CPU (plain versions) and on
the card alike:

- the forward's backward (JAX ``analysis_pyramid.transpose_fn``, B4):
  per subband group K3 combines the band cotangent into quadrant planes
  (the adjoint of K2's butterfly), a K1 column product with the group's
  transposed column stack writes the group's slice of ``dz`` in place,
  the lowpass block likewise, and one K1 row product with the stacked
  row operators' transpose gives ``dx``;
- the inverse's backward (plain autodiff in JAX): per group a K1 column
  product with the transposed column operator, a K1 row product with the
  transposed row operator, and K2 writes the band gradient (K2 is the
  adjoint of K3's combine).

A backward runs its products at the matmul precision level of its forward
(kept on the autograd context), as JAX's transposes run at the precision
of the traced forward.

The operators of a plan, and their transposes, live on the device as
:class:`~.banded.Operator` objects, built once per plan and device by
:func:`analysis_operators` / :func:`synthesis_operators`.  Double
backward is not ported (ROADMAP.md, A4).
"""
from __future__ import annotations

import math
from collections import namedtuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from pytorch_wavelets_tpu_torch.ops.banded import (
    Operator, apply_col, apply_row,
)
from pytorch_wavelets_tpu_torch.ops.precision import (
    get_matmul_precision, matmul_precision,
)
from pytorch_wavelets_tpu_torch.ops.quad import c2q_unpack, q2c_pack

__all__ = ["analysis_operators", "synthesis_operators", "analysis_pyramid",
           "synthesis_pyramid", "canonical_bands"]

_SQRT2 = math.sqrt(2.0)

# orientation index pairs per subband (reference transform_funcs.py:75-95)
_SB_ORIENTS = {"lh": (0, 5), "hl": (2, 3), "hh": (1, 4)}

# One forward subband group: its members' orientation pairs, the members'
# corner height m, its slice [go, go + gn) of the stage-1 output, and its
# stacked stage-2 column operator and that operator's transpose.
_AnaGroup = namedtuple("_AnaGroup", "orients m go gn op opT")
# One inverse subband group: orientation pairs, the parity-split row
# operator (1/sqrt2 folded in), the concatenated column operator, and
# their transposes.
_SynGroup = namedtuple("_SynGroup", "orients row col rowT colT")
# The forward's final lowpass: its column operator, that operator's
# transpose, and its slice [go, go + gn) of the stage-1 output.
_AnaLow = namedtuple("_AnaLow", "op opT go gn")


def _cat(*mats):
    return np.ascontiguousarray(np.concatenate(mats, axis=0))


def _member_groups(bands):
    """Subbands grouped by their (shared) row operator, in order."""
    groups: dict = {}
    for name, (R, C) in bands:
        groups.setdefault(id(R), (R, []))[1].append((name, C))
    return list(groups.values())


def _pyramid_layout(levels):
    """Stage-1 row-operator blocks + per-level stage-2 plan."""
    blocks = []
    ofs = 0
    plan = []
    for lev in levels:
        entry = {"groups": [], "ll": None}
        if lev.get("bands"):
            for R, members in _member_groups(lev["bands"]):
                k = R[0::2].shape[0]
                blocks += [R[0::2], R[1::2]]
                entry["groups"].append((members, ofs, 2 * k))
                ofs += 2 * k
        if lev.get("ll") is not None:
            R, C = lev["ll"]
            blocks.append(R)
            entry["ll"] = (C, ofs, R.shape[0])
            ofs += R.shape[0]
        plan.append(entry)
    return blocks, plan


def _cstack(members):
    return _cat(*[C[p::2] for _, C in members
                  for p in (0, 1)]) * (1.0 / _SQRT2)


def _op_pair(T, device):
    """An operator and its transpose, both on ``device``."""
    return Operator(T, device), Operator(np.ascontiguousarray(T.T), device)


def analysis_operators(levels, device):
    """Device form of a forward plan (``levels`` as for the JAX
    ``analysis_pyramid``): (R_all, R_all^T, [(groups, ll) per level]),
    ll an ``_AnaLow`` or None."""
    blocks, plan = _pyramid_layout(levels)
    out = []
    for entry in plan:
        groups = [_AnaGroup(tuple(_SB_ORIENTS[name] for name, _ in members),
                            members[0][1][0::2].shape[0], go, gn,
                            *_op_pair(_cstack(members), device))
                  for members, go, gn in entry["groups"]]
        ll = None
        if entry["ll"] is not None:
            C, go, gn = entry["ll"]
            ll = _AnaLow(*_op_pair(C, device), go, gn)
        out.append((groups, ll))
    return (*_op_pair(_cat(*blocks), device), out)


def synthesis_operators(levels, ll_spec, device):
    """Device form of an inverse plan (``levels`` and ``ll_spec`` from
    ``_inv_pyramid_plan``): ([groups or None per level], the lowpass's
    operators as a ``_SynGroup`` without orientations, or None)."""
    out = []
    for lev in levels:
        if lev is None or not lev.get("bands"):
            out.append(None)
            continue
        groups = []
        for R, members in _member_groups(lev["bands"]):
            Rt = np.ascontiguousarray(
                _cat(R[:, 0::2].T, R[:, 1::2].T).T * (1.0 / _SQRT2))
            Ccat = np.concatenate(
                [np.concatenate([C[:, 0::2], C[:, 1::2]], axis=1)
                 for _, C in members], axis=1)
            (row, rowT), (col, colT) = (_op_pair(Rt, device),
                                        _op_pair(Ccat, device))
            groups.append(_SynGroup(
                tuple(_SB_ORIENTS[name] for name, _ in members),
                row, col, rowT, colT))
        out.append(groups)
    ll = None
    if ll_spec is not None:
        (row, rowT), (col, colT) = (_op_pair(ll_spec[0], device),
                                    _op_pair(ll_spec[1], device))
        ll = _SynGroup((), row, col, rowT, colT)
    return out, ll


def canonical_bands(h, o_dim, ri_dim):
    """View of a bandpass tensor as (N, C, 6, H, W, 2), whatever its
    o_dim/ri_dim layout (dims as from ``get_dimensions5``)."""
    return h.movedim(ri_dim, -1).movedim(o_dim, 2)


# --------------------------------------------------------------------------
# The pyramids
# --------------------------------------------------------------------------

def _analysis(x, ops, o_dim, ri_dim):
    R_all, _, levels = ops
    z = apply_row(x, R_all)
    N, C = x.shape[:2]
    lls, yh = [], []
    for groups, ll in levels:
        h = None
        if groups:
            shape = [N, C, groups[0].m, groups[0].gn // 2]
            shape.insert(o_dim, 6)
            shape.insert(ri_dim, 2)
            h = torch.empty(shape, dtype=x.dtype, device=x.device)
            hc = canonical_bands(h, o_dim, ri_dim)
            for g in groups:
                q2c_pack(apply_col(z[..., g.go:g.go + g.gn], g.op), hc,
                         g.orients)
        yh.append(h)
        lls.append(None if ll is None
                   else apply_col(z[..., ll.go:ll.go + ll.gn], ll.op))
    return lls, yh


def _analysis_adjoint(gls, ghs, ops, o_dim, ri_dim, x_shape, dtype, device):
    """dx from the cotangents of each level's lowpass and bands (None:
    no cotangent, zeros in its blocks of dz)."""
    R_all, R_allT, levels = ops
    N, C, H, _ = x_shape
    dz = torch.empty((N, C, H, R_all.shape[0]), dtype=dtype, device=device)
    for (groups, ll), gl, gh in zip(levels, gls, ghs):
        hc = None if gh is None else canonical_bands(gh.to(dtype), o_dim,
                                                     ri_dim)
        for g in groups:
            blk = dz[..., g.go:g.go + g.gn]
            if hc is None:
                blk.zero_()
            else:
                apply_col(c2q_unpack(hc, g.orients), g.opT, blk,
                          accumulate=False)
        if ll is not None:
            blk = dz[..., ll.go:ll.go + ll.gn]
            if gl is None:
                blk.zero_()
            else:
                apply_col(gl.to(dtype).contiguous(), ll.opT, blk,
                          accumulate=False)
    return apply_row(dz, R_allT)


class _AnalysisPyramid(torch.autograd.Function):
    """The composed forward; its backward is B4 (see the module notes).
    Outputs: the non-None lowpasses and bands, level by level."""

    @staticmethod
    def forward(ctx, x, ops, o_dim, ri_dim):
        lls, yh = _analysis(x, ops, o_dim, ri_dim)
        ctx.set_materialize_grads(False)
        ctx.ops, ctx.dims = ops, (o_dim, ri_dim)
        ctx.level = get_matmul_precision()
        ctx.x_meta = (x.shape, x.dtype, x.device)
        ctx.present = [(ll is not None, h is not None)
                       for ll, h in zip(lls, yh)]
        return tuple(t for pair in zip(lls, yh) for t in pair
                     if t is not None)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        it = iter(grads)
        gls, ghs = [], []
        for has_ll, has_h in ctx.present:
            gls.append(next(it) if has_ll else None)
            ghs.append(next(it) if has_h else None)
        with matmul_precision(ctx.level):
            dx = _analysis_adjoint(gls, ghs, ctx.ops, *ctx.dims,
                                   *ctx.x_meta)
        return dx, None, None, None


def analysis_pyramid(x, ops, o_dim, ri_dim):
    """Multi-level composed analysis of a contiguous (N, C, H, W) ``x``,
    differentiable (B4 backward).

    ``ops``: :func:`analysis_operators` of the plan; ``o_dim``/``ri_dim``:
    the 5-D orientation dim and the 6-D re/im dim (``get_dimensions5``).
    Returns (lls, yh): per level the lowpass output or None, and the 6-D
    bandpass tensor or None.
    """
    outs = _AnalysisPyramid.apply(x, ops, o_dim, ri_dim)
    if isinstance(outs, torch.Tensor):
        outs = (outs,)
    it = iter(outs)
    lls, yh = [], []
    for groups, ll in ops[2]:
        lls.append(None if ll is None else next(it))
        yh.append(next(it) if groups else None)
    return lls, yh


def _synthesis(ll, highs, ops):
    levels, ll_ops = ops
    y = None
    for groups, h in zip(levels, highs):
        if groups is None or h is None:
            continue
        for g in groups:
            y = apply_col(apply_row(c2q_unpack(h, g.orients), g.row), g.col,
                          y)
    if ll is not None and ll_ops is not None:
        y = apply_col(apply_row(ll, ll_ops.row), ll_ops.col, y)
    return y


def _synthesis_adjoint(gy, ops, need_ll, used, band_shapes, need_bands):
    """The lowpass gradient (or None) and the gradients of the bands of
    the levels in ``used`` (None where ``need_bands`` is False)."""
    levels, ll_ops = ops
    gy = gy.contiguous()
    d_ll = apply_row(apply_col(gy, ll_ops.colT), ll_ops.rowT) if need_ll \
        else None
    d_bands = []
    for j, shape, need in zip(used, band_shapes, need_bands):
        if not need:
            d_bands.append(None)
            continue
        groups = levels[j]
        written = {o for g in groups for pair in g.orients for o in pair}
        dh = (torch.empty if len(written) == 6 else torch.zeros)(
            shape, dtype=gy.dtype, device=gy.device)
        for g in groups:
            q2c_pack(apply_row(apply_col(gy, g.colT), g.rowT), dh,
                     g.orients)
        d_bands.append(dh)
    return d_ll, d_bands


class _SynthesisPyramid(torch.autograd.Function):
    """The composed inverse; its backward is the adjoint (see the module
    notes).  Inputs after ``ops``: the lowpass (or None), then the bands
    of the levels listed in ``used``."""

    @staticmethod
    def forward(ctx, ops, used, ll, *bands):
        highs = [None] * len(ops[0])
        for j, h in zip(used, bands):
            highs[j] = h
        ctx.ops, ctx.used = ops, used
        ctx.level = get_matmul_precision()
        ctx.band_shapes = [h.shape for h in bands]
        return _synthesis(ll, highs, ops)

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        with matmul_precision(ctx.level):
            d_ll, d_bands = _synthesis_adjoint(
                gy, ctx.ops, ctx.needs_input_grad[2], ctx.used,
                ctx.band_shapes, ctx.needs_input_grad[3:])
        return (None, None, d_ll, *d_bands)


def synthesis_pyramid(ll, highs, ops):
    """Multi-level composed synthesis, differentiable (adjoint backward).

    ``ll``: the contiguous lowpass or None; ``highs``: per level (fine
    first) the bands as (N, C, 6, h, w, 2) views (:func:`canonical_bands`)
    or None; ``ops``: :func:`synthesis_operators` of the plan.  Returns
    the reconstruction, or None when nothing contributes.
    """
    levels, ll_ops = ops
    used = tuple(j for j, (groups, h) in enumerate(zip(levels, highs))
                 if groups is not None and h is not None)
    if ll_ops is None:
        ll = None
    if ll is None and not used:
        return None
    return _SynthesisPyramid.apply(ops, used, ll,
                                   *[highs[j] for j in used])
