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

The operators of a plan live on the device as :class:`~.banded.Operator`
objects, built once per plan and device by :func:`analysis_operators` /
:func:`synthesis_operators`.  The JAX forward's hand-written transpose
(its ``linear_call``) is the training slice: ROADMAP.md, "Still to port"
item 1 (B4).
"""
from __future__ import annotations

import math
from collections import namedtuple

import numpy as np
import torch

from pytorch_wavelets_tpu_torch.ops.banded import (
    Operator, apply_col, apply_row,
)
from pytorch_wavelets_tpu_torch.ops.quad import c2q_unpack, q2c_pack

__all__ = ["analysis_operators", "synthesis_operators", "analysis_pyramid",
           "synthesis_pyramid", "canonical_bands"]

_SQRT2 = math.sqrt(2.0)

# orientation index pairs per subband (reference transform_funcs.py:75-95)
_SB_ORIENTS = {"lh": (0, 5), "hl": (2, 3), "hh": (1, 4)}

# One forward subband group: its members' orientation pairs, the members'
# corner height m, its slice [go, go + gn) of the stage-1 output, and its
# stacked stage-2 column operator.
_AnaGroup = namedtuple("_AnaGroup", "orients m go gn op")
# One inverse subband group: orientation pairs, the parity-split row
# operator (1/sqrt2 folded in) and the concatenated column operator.
_SynGroup = namedtuple("_SynGroup", "orients row col")


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


def analysis_operators(levels, device):
    """Device form of a forward plan (``levels`` as for the JAX
    ``analysis_pyramid``): (R_all, [(groups, ll) per level])."""
    blocks, plan = _pyramid_layout(levels)
    out = []
    for entry in plan:
        groups = [_AnaGroup(tuple(_SB_ORIENTS[name] for name, _ in members),
                            members[0][1][0::2].shape[0], go, gn,
                            Operator(_cstack(members), device))
                  for members, go, gn in entry["groups"]]
        ll = None
        if entry["ll"] is not None:
            C, go, gn = entry["ll"]
            ll = (Operator(C, device), go, gn)
        out.append((groups, ll))
    return Operator(_cat(*blocks), device), out


def synthesis_operators(levels, ll_spec, device):
    """Device form of an inverse plan (``levels`` and ``ll_spec`` from
    ``_inv_pyramid_plan``): ([groups or None per level], ll operators)."""
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
            groups.append(_SynGroup(
                tuple(_SB_ORIENTS[name] for name, _ in members),
                Operator(Rt, device), Operator(Ccat, device)))
        out.append(groups)
    ll = None
    if ll_spec is not None:
        ll = (Operator(ll_spec[0], device), Operator(ll_spec[1], device))
    return out, ll


def canonical_bands(h, o_dim, ri_dim):
    """View of a bandpass tensor as (N, C, 6, H, W, 2), whatever its
    o_dim/ri_dim layout (dims as from ``get_dimensions5``)."""
    return h.movedim(ri_dim, -1).movedim(o_dim, 2)


# --------------------------------------------------------------------------
# The pyramids
# --------------------------------------------------------------------------

def analysis_pyramid(x, ops, o_dim, ri_dim):
    """Multi-level composed analysis of a contiguous (N, C, H, W) ``x``.

    ``ops``: :func:`analysis_operators` of the plan; ``o_dim``/``ri_dim``:
    the 5-D orientation dim and the 6-D re/im dim (``get_dimensions5``).
    Returns (lls, yh): per level the lowpass output or None, and the 6-D
    bandpass tensor or None.
    """
    R_all, levels = ops
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
                   else apply_col(z[..., ll[1]:ll[1] + ll[2]], ll[0]))
    return lls, yh


def synthesis_pyramid(ll, highs, ops):
    """Multi-level composed synthesis.

    ``ll``: the contiguous lowpass or None; ``highs``: per level (fine
    first) the bands as (N, C, 6, h, w, 2) views (:func:`canonical_bands`)
    or None; ``ops``: :func:`synthesis_operators` of the plan.  Returns
    the reconstruction, or None when nothing contributes.
    """
    levels, ll_ops = ops
    y = None
    for groups, h in zip(levels, highs):
        if groups is None or h is None:
            continue
        for g in groups:
            y = apply_col(apply_row(c2q_unpack(h, g.orients), g.row), g.col,
                          y)
    if ll is not None and ll_ops is not None:
        y = apply_col(apply_row(ll, ll_ops[0]), ll_ops[1], y)
    return y
