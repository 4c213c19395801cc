"""DTCWT level functions and their backwards, and the whole-transform
planners.

Port of ``pytorch_wavelets_tpu/transforms/dtcwt.py`` (reference semantics:
pytorch_wavelets/dtcwt/transform_funcs.py and transform2d.py), in two
parts:

- The per-level path: the level functions (``fwd_j1`` ... ``inv_j2plus``;
  given the bandpass-diagonal filters h2 / (h2a, h2b) they are the JAX
  package's ``_rot`` variants) over the stencils of
  ``ops/dtcwt_fb.py`` (K8-K10 on the card), the bands written and read by
  K2/K3 in their per-level mode (``highs_to_orientations`` /
  ``orientations_to_highs``), and the JAX custom VJPs as
  ``torch.autograd.Function``s (``fwd_j1_op`` ... ``inv_j2plus_op``): the
  backward of a forward level is the inverse level with the same taps
  (for q-shift levels the a/b trees swap), that of an inverse level the
  forward level; they save no inputs.  This is the path of the
  bandpass-diagonal scattering filters, of axes above ``MAX_MATMUL_N``,
  of shapes the composed plans reject, and of everything under
  ``ops.banded.set_operator_matmul(False)``.
- The composed path: every level is linear, so level-j operators compose
  through the lowpass chain on the host: the inter-level %4 replicate
  pads and the inverse's [1:-1] crops are selection matrices and fold in
  exactly.  The composed forward computes every output directly from x;
  the composed inverse scatters every level straight to x resolution.
  The numpy plans are cached by their arguments (bounded by bytes); their
  device form (``ops/fused_dtcwt.py:analysis_operators`` /
  ``synthesis_operators``) is cached per (plan key, device), so the
  operators are uploaded once, not on every call.
"""
from __future__ import annotations

import numpy as np
import torch

from pytorch_wavelets_tpu_torch.ops import banded, fused_dtcwt
from pytorch_wavelets_tpu_torch.ops._linear import linear_backward
from pytorch_wavelets_tpu_torch.ops.dtcwt_fb import (
    _dfilt_matrix, _filter_matrix, _ifilt_matrix, coldfilt, colfilter,
    colifilt, rowdfilt, rowfilter, rowifilt,
)
from pytorch_wavelets_tpu_torch.ops.fused_dtcwt import canonical_bands
from pytorch_wavelets_tpu_torch.ops.quad import c2q_unpack, q2c_pack
from pytorch_wavelets_tpu_torch.transforms.plan_cache import (
    budgeted_plan_cache,
)

__all__ = ["get_dimensions5", "get_dimensions6", "dtcwt2d_pyramid",
           "inv_pyramid_operators", "highs_to_orientations",
           "orientations_to_highs", "fwd_j1", "inv_j1", "fwd_j2plus",
           "inv_j2plus", "fwd_j1_op", "fwd_j1_rot_op", "fwd_j2plus_op",
           "fwd_j2plus_rot_op", "inv_j1_op", "inv_j2plus_op"]


def get_dimensions5(o_dim, ri_dim):
    """Orientation/height/width dims once re/im has been popped off a 6-D
    layout (reference: transform_funcs.py:10-29)."""
    o_dim = o_dim % 6
    ri_dim = ri_dim % 6
    if ri_dim < o_dim:
        o_dim -= 1
    if o_dim == 4:
        h_dim, w_dim = 2, 3
    elif o_dim == 3:
        h_dim, w_dim = 2, 4
    else:
        h_dim, w_dim = 3, 4
    return o_dim, ri_dim, h_dim, w_dim


def get_dimensions6(o_dim, ri_dim):
    """Dims in the full 6-D bandpass tensor (reference:
    transform_funcs.py:32-58).

    Derived from the 5-D dims plus the re/im stack insertion: stacking at
    ``ri_dim`` shifts every 5-D axis at or past it up by one.  This agrees
    with the reference's case table on every layout its inverse supports
    and *corrects* it on the layouts where exactly one of o_dim/ri_dim is
    >= 4 — there the reference mislabels the H/W axes and its DTCWTInverse
    crashes (docs/parity.md, Known divergences), while these dims make the
    inverse work for the full 30-pair matrix."""
    od5, rd, h5, w5 = get_dimensions5(o_dim, ri_dim)
    h_dim = h5 + (1 if h5 >= rd else 0)
    w_dim = w5 + (1 if w5 >= rd else 0)
    return od5, rd, h_dim, w_dim


# --------------------------------------------------------------------------
# The per-level path
# --------------------------------------------------------------------------

# the orientation pairs of (lh, hl, hh): 15/165, 75/105, 45/135 degrees
# (reference transform_funcs.py:61-95)
_ORIENTS = ((0, 5), (2, 3), (1, 4))


def highs_to_orientations(y, o_dim, ri_dim):
    """(N, C, 3, 2m, 2k) stack of the (lh, hl, hh) subbands -> the 6-D
    bandpass tensor, the 6 oriented complex bands at ``o_dim`` and re/im
    at ``ri_dim`` (5-D / 6-D dims, ``get_dimensions5``), in the order 15,
    45, 75, 105, 135, 165 degrees (reference: transform_funcs.py:61-72):
    one K2 pass on the card, no stacking copies."""
    N, C, _, H2, W2 = y.shape
    if H2 % 2 or W2 % 2:
        raise ValueError(f"q2c: the corners of {H2}x{W2} subbands are not "
                         f"defined (odd size: even-length level-1 filters "
                         f"give odd outputs)")
    shape = [N, C, H2 // 2, W2 // 2]
    shape.insert(o_dim, 6)
    shape.insert(ri_dim, 2)
    h = torch.empty(shape, dtype=y.dtype, device=y.device)
    q2c_pack(y, canonical_bands(h, o_dim, ri_dim), _ORIENTS,
             interleaved=True)
    return h


def orientations_to_highs(h, o_dim, ri_dim):
    """Inverse of :func:`highs_to_orientations` (reference:
    transform_funcs.py:75-95): the contiguous (N, C, 3, 2h, 2w) stack of
    (lh, hl, hh), one K3 pass on the card."""
    return c2q_unpack(canonical_bands(h, o_dim, ri_dim), _ORIENTS,
                      interleaved=True)


def _stack3(like, rows, cols):
    N, C = like.shape[:2]
    return torch.empty((N, C, 3, rows, cols), dtype=like.dtype,
                       device=like.device)


def fwd_j1(x, h0, h1, h2, skip_hps, o_dim, ri_dim, mode):
    """Level-1 analysis (reference: transform_funcs.py:98-149), with the
    bandpass-diagonal filter h2 on the HH branch when it is given (JAX
    ``fwd_j1_rot``): (ll, bands) with the bands in the (o_dim, ri_dim)
    layout (5-D / 6-D dims), or (ll, None) with ``skip_hps``."""
    if skip_hps:
        return colfilter(rowfilter(x, h0, mode), h0, mode), None
    lo = rowfilter(x, h0, mode)
    hi = rowfilter(x, h1, mode)
    ba = hi if h2 is None else rowfilter(x, h2, mode)
    y = _stack3(lo, lo.shape[2] + 1 - len(h0) % 2, lo.shape[3])
    colfilter(lo, h1, mode, out=y[:, :, 0])                  # lh
    colfilter(hi, h0, mode, out=y[:, :, 1])                  # hl
    colfilter(ba, h1 if h2 is None else h2, mode, out=y[:, :, 2])   # hh
    ll = colfilter(lo, h0, mode)
    return ll, highs_to_orientations(y, o_dim, ri_dim)


def _crop_ll(ll, h, o_dim, ri_dim):
    """The [1:-1] crops of a lowpass one row/column longer than twice the
    bands (a view)."""
    r1, c1 = canonical_bands(h, o_dim, ri_dim).shape[3:5]
    if ll.shape[2] != r1 * 2:
        ll = ll[:, :, 1:-1]
    if ll.shape[3] != c1 * 2:
        ll = ll[:, :, :, 1:-1]
    return ll


def inv_j1(ll, h, g0, g1, g2, o_dim, ri_dim, mode):
    """Level-1 synthesis of the lowpass (or None) and the bands (or None)
    (reference: transform_funcs.py:152-223; with g2, JAX ``inv_j1_rot``);
    the sums accumulate into the first term's output (K8's
    ``accumulate``)."""
    if h is None:
        return rowfilter(colfilter(ll, g0), g0)
    q = orientations_to_highs(h, o_dim, ri_dim)
    lh, hl, hh = q[:, :, 0], q[:, :, 1], q[:, :, 2]
    lo = colfilter(lh, g1, mode)
    if ll is not None:
        colfilter(_crop_ll(ll, h, o_dim, ri_dim), g0, mode, out=lo,
                  accumulate=True)
    if g2 is None:
        hi = colfilter(hh, g1, mode)
        colfilter(hl, g0, mode, out=hi, accumulate=True)
        y = rowfilter(hi, g1, mode)
        return rowfilter(lo, g0, mode, out=y, accumulate=True)
    hi = colfilter(hl, g0, mode)
    ba = colfilter(hh, g2, mode)
    y = rowfilter(hi, g1, mode)
    rowfilter(lo, g0, mode, out=y, accumulate=True)
    return rowfilter(ba, g2, mode, out=y, accumulate=True)


def fwd_j2plus(x, h0a, h1a, h0b, h1b, h2a, h2b, skip_hps, o_dim, ri_dim,
               mode):
    """Level>=2 analysis with q-shift trees (reference:
    transform_funcs.py:226-276; with h2a/h2b, JAX ``fwd_j2plus_rot``):
    (ll, bands) or (ll, None)."""
    if skip_hps:
        return coldfilt(rowdfilt(x, h0b, h0a, False, mode), h0b, h0a, False,
                        mode), None
    lo = rowdfilt(x, h0b, h0a, False, mode)
    hi = rowdfilt(x, h1b, h1a, True, mode)
    y = _stack3(lo, lo.shape[2] // 2, lo.shape[3])
    coldfilt(lo, h1b, h1a, True, mode, out=y[:, :, 0])       # lh
    coldfilt(hi, h0b, h0a, False, mode, out=y[:, :, 1])      # hl
    if h2a is None:
        coldfilt(hi, h1b, h1a, True, mode, out=y[:, :, 2])   # hh
    else:
        ba = rowdfilt(x, h2b, h2a, True, mode)
        coldfilt(ba, h2b, h2a, True, mode, out=y[:, :, 2])
    ll = coldfilt(lo, h0b, h0a, False, mode)
    return ll, highs_to_orientations(y, o_dim, ri_dim)


def inv_j2plus(ll, h, g0a, g1a, g0b, g1b, g2a, g2b, o_dim, ri_dim, mode):
    """Level>=2 synthesis of the lowpass (or None) and the bands (or
    None) (reference: transform_funcs.py:279-340; with g2a/g2b, JAX
    ``inv_j2plus_rot``)."""
    if h is None:
        return rowifilt(colifilt(ll, g0b, g0a, False, mode), g0b, g0a,
                        False, mode)
    q = orientations_to_highs(h, o_dim, ri_dim)
    lh, hl, hh = q[:, :, 0], q[:, :, 1], q[:, :, 2]
    lo = colifilt(lh, g1b, g1a, True, mode)
    if ll is not None:
        colifilt(ll, g0b, g0a, False, mode, out=lo, accumulate=True)
    if g2a is None:
        hi = colifilt(hh, g1b, g1a, True, mode)
        colifilt(hl, g0b, g0a, False, mode, out=hi, accumulate=True)
        y = rowifilt(hi, g1b, g1a, True, mode)
        return rowifilt(lo, g0b, g0a, False, mode, out=y, accumulate=True)
    hi = colifilt(hl, g0b, g0a, False, mode)
    ba = colifilt(hh, g2b, g2a, True, mode)
    y = rowifilt(hi, g1b, g1a, True, mode)
    rowifilt(lo, g0b, g0a, False, mode, out=y, accumulate=True)
    return rowifilt(ba, g2b, g2a, True, mode, out=y, accumulate=True)


# --------------------------------------------------------------------------
# The JAX custom VJPs as autograd Functions (reference FWD_J1 / FWD_J2PLUS
# / INV_J1 / INV_J2PLUS).  ``taps`` is (h0, h1, h2) at level 1 and
# (h0a, h1a, h0b, h1b, h2a, h2b) past it, h2* None without the
# bandpass-diagonal filters.
# --------------------------------------------------------------------------

def _swap_trees(taps):
    """Time reverse of q-shift filters == swap the a/b trees
    (reference transform_funcs.py:398-401)."""
    h0a, h1a, h0b, h1b, h2a, h2b = taps
    return h0b, h1b, h0a, h1a, h2b, h2a


class _FwdLevel(torch.autograd.Function):
    """A forward level; its backward is the inverse level (JAX ``bwd``):
    with the same taps at level 1, with the trees swapped past it.  That
    backward's own backward is this level again (``ops/_linear.py``), the
    transpose of the inverse level where the two are adjoint (the dot-
    product test of ``chip_smoke.py``); the lowpass-only inverse of a
    skipped level runs in 'symmetric', so its transpose is this level in
    'symmetric'."""

    @staticmethod
    def forward(ctx, x, j1, taps, skip_hps, o_dim, ri_dim, mode):
        fwd = fwd_j1 if j1 else fwd_j2plus
        ll, h = fwd(x, *taps, skip_hps, o_dim, ri_dim, mode)
        ctx.set_materialize_grads(False)
        ctx.args = (j1, taps, o_dim, ri_dim, mode)
        ctx.h_meta = None if h is None else (h.shape, h.dtype, h.device)
        return ll if h is None else (ll, h)

    @staticmethod
    def backward(ctx, dl, dh=None):
        j1, taps, o_dim, ri_dim, mode = ctx.args
        if dl is None and dh is None:
            return (None,) * 7
        h_meta = ctx.h_meta

        def adjoint(dl, dh=None):
            if dh is None and h_meta is not None:
                # JAX's cotangent of an unused output is zeros: the bands'
                # branch (in ``mode``) runs, not the lowpass-only one
                shape, dtype, device = h_meta
                dh = torch.zeros(shape, dtype=dtype, device=device)
            if j1:
                return inv_j1(dl, dh, *taps, o_dim, ri_dim, mode)
            return inv_j2plus(dl, dh, *_swap_trees(taps), o_dim, ri_dim,
                              mode)

        skip = h_meta is None
        fmode = "symmetric" if skip else mode

        def primal(u):
            return _FwdLevel.apply(u, j1, taps, skip, o_dim, ri_dim, fmode)
        grads = (dl,) if skip else (dl, dh)
        return (linear_backward(adjoint, primal, *grads),) + (None,) * 6


class _InvLevel(torch.autograd.Function):
    """An inverse level of (lows or None, highs or None); its backward is
    the forward level (JAX ``bwd``), which saves no inputs, and that
    backward's own backward this level again (``ops/_linear.py``).  A
    level-1 inverse without bands in a mode other than 'symmetric' raises
    there: its backward filters in ``mode``, its forward in 'symmetric'
    (the reference's lowpass-only branch), so neither is the other's
    transpose."""

    @staticmethod
    def forward(ctx, lows, highs, j1, taps, o_dim, ri_dim, mode):
        ctx.set_materialize_grads(False)
        ctx.args = (j1, taps, o_dim, ri_dim, mode)
        ctx.has = (lows is not None, highs is not None)
        if j1:
            return inv_j1(lows, highs, *taps, None, o_dim, ri_dim, mode)
        return inv_j2plus(lows, highs, *taps, None, None, o_dim, ri_dim,
                           mode)

    @staticmethod
    def backward(ctx, dy):
        j1, taps, o_dim, ri_dim, mode = ctx.args
        has_lows, has_highs = ctx.has
        if dy is None:
            return (None,) * 7

        def adjoint(g):
            if j1:
                dl, dh = fwd_j1(g, *taps, None, not has_highs, o_dim, ri_dim,
                                mode)
            else:
                g0a, g1a, g0b, g1b = taps
                dl, dh = fwd_j2plus(g, g0b, g1b, g0a, g1a, None, None,
                                    not has_highs, o_dim, ri_dim, mode)
            return dl if has_lows else None, dh

        def primal(ul, uh):
            if j1 and uh is None and mode != "symmetric":
                raise NotImplementedError(
                    f"the second derivative of a level-1 DTCWT inverse "
                    f"without bands in mode {mode!r}: its backward is not "
                    f"the transpose of its forward there")
            return _InvLevel.apply(ul, uh, j1, taps, o_dim, ri_dim, mode)
        dl, dh = linear_backward(adjoint, primal, dy)
        return (dl, dh) + (None,) * 5


def _taps(*ts):
    return tuple(None if t is None else tuple(float(v) for v in
                                              np.asarray(t).ravel())
                 for t in ts)


def _fwd_op(x, j1, taps, skip_hps, o_dim, ri_dim, mode):
    od, rd, _, _ = get_dimensions5(o_dim, ri_dim)
    out = _FwdLevel.apply(x, j1, taps, bool(skip_hps), od, rd, mode)
    return (out, None) if skip_hps else out


def fwd_j1_op(x, h0, h1, skip_hps, o_dim, ri_dim, mode):
    """Differentiable level-1 analysis of ``x`` (6-D ``o_dim``/``ri_dim``
    of the bands, as the modules take them): (ll, bands), or (ll, None)
    with ``skip_hps``."""
    return _fwd_op(x, True, _taps(h0, h1, None), skip_hps, o_dim, ri_dim,
                   mode)


def fwd_j1_rot_op(x, h0, h1, h2, skip_hps, o_dim, ri_dim, mode):
    """:func:`fwd_j1_op` with the bandpass-diagonal filter h2."""
    return _fwd_op(x, True, _taps(h0, h1, h2), skip_hps, o_dim, ri_dim,
                   mode)


def fwd_j2plus_op(x, h0a, h1a, h0b, h1b, skip_hps, o_dim, ri_dim, mode):
    """Differentiable level>=2 analysis (always 'symmetric', as the
    reference forces it)."""
    return _fwd_op(x, False, _taps(h0a, h1a, h0b, h1b, None, None),
                   skip_hps, o_dim, ri_dim, "symmetric")


def fwd_j2plus_rot_op(x, h0a, h1a, h0b, h1b, h2a, h2b, skip_hps, o_dim,
                      ri_dim, mode):
    """:func:`fwd_j2plus_op` with the bandpass-diagonal filters."""
    return _fwd_op(x, False, _taps(h0a, h1a, h0b, h1b, h2a, h2b), skip_hps,
                   o_dim, ri_dim, "symmetric")


def inv_j1_op(lows, highs, g0, g1, o_dim, ri_dim, mode):
    """Differentiable level-1 synthesis of (lows or None, highs or
    None)."""
    od, rd, _, _ = get_dimensions5(o_dim, ri_dim)
    return _InvLevel.apply(lows, highs, True, _taps(g0, g1), od, rd, mode)


def inv_j2plus_op(lows, highs, g0a, g1a, g0b, g1b, o_dim, ri_dim, mode):
    """Differentiable level>=2 synthesis (always 'symmetric')."""
    od, rd, _, _ = get_dimensions5(o_dim, ri_dim)
    return _InvLevel.apply(lows, highs, False, _taps(g0a, g1a, g0b, g1b),
                           od, rd, "symmetric")


# --------------------------------------------------------------------------
# The composed path
# --------------------------------------------------------------------------

def _pad4_matrix(n):
    """Replicate-pad-to-%4 selection matrix (reference
    dtcwt/transform2d.py:131-135), or None when no pad is needed."""
    if n % 4 == 0:
        return None
    P = np.zeros((n + 2, n), dtype=np.float32)
    P[0, 0] = 1.0
    P[np.arange(1, n + 1), np.arange(n)] = 1.0
    P[-1, -1] = 1.0
    return P


def _compose(A, chain):
    return A if chain is None else np.ascontiguousarray(
        banded.compose(A, chain))


@budgeted_plan_cache   # entries hold O(n^2) composed operator matrices
def _fwd_pyramid_plan(h0o, h1o, h0a, h1a, h0b, h1b, J, skips, incs, mode,
                      H, W):
    """Composed forward plan: per-level specs for analysis_pyramid, all
    operators acting directly on the (even-padded) input.  None when the
    filter/size combination doesn't admit the parity-folded form."""
    kl = ((h0b, h0a), False)
    kh = ((h1b, h1a), True)
    chain_h, chain_w = None, None          # None == identity
    levels = []
    for j in range(J):
        nh = H if chain_h is None else chain_h.shape[0]
        nw = W if chain_w is None else chain_w.shape[0]
        if j == 0:
            Cl, Ch = (_filter_matrix(h0o, mode, nh),
                      _filter_matrix(h1o, mode, nh))
            Rl, Rh = (_filter_matrix(h0o, mode, nw),
                      _filter_matrix(h1o, mode, nw))
            if any(m.shape[0] % 2 for m in (Cl, Ch, Rl, Rh)):
                return None
        else:
            Ph, Pw = _pad4_matrix(nh), _pad4_matrix(nw)
            if Ph is not None:
                chain_h = _compose(Ph, chain_h)
                nh += 2
            if Pw is not None:
                chain_w = _compose(Pw, chain_w)
                nw += 2
            Cl, Ch = (_dfilt_matrix(*kl[0], kl[1], nh),
                      _dfilt_matrix(*kh[0], kh[1], nh))
            Rl, Rh = (_dfilt_matrix(*kl[0], kl[1], nw),
                      _dfilt_matrix(*kh[0], kh[1], nw))
            if Cl.shape[0] % 2 or Rl.shape[0] % 2:
                return None
        Rl_c, Rh_c = _compose(Rl, chain_w), _compose(Rh, chain_w)
        Cl_c, Ch_c = _compose(Cl, chain_h), _compose(Ch, chain_h)
        lev = {"bands": None, "ll": None}
        if not skips[j]:
            lev["bands"] = [("lh", (Rl_c, Ch_c)), ("hl", (Rh_c, Cl_c)),
                            ("hh", (Rh_c, Ch_c))]
        chain_h, chain_w = Cl_c, Rl_c
        if incs[j] or j == J - 1:
            lev["ll"] = (chain_w, chain_h)
        levels.append(lev)
    return tuple(levels)




@budgeted_plan_cache   # entries hold the plan's operators on one device
def _fwd_operators(*args):
    *plan_args, device = args
    plan = _fwd_pyramid_plan(*plan_args)
    return None if plan is None else fused_dtcwt.analysis_operators(plan,
                                                                    device)


def dtcwt2d_pyramid(x, filters, J, skip_hps, include_scale, o_dim, ri_dim,
                    mode):
    """Composed whole-transform forward of a contiguous, even-padded
    ``x``.  Returns None when no composed plan exists."""
    H, W = x.shape[2], x.shape[3]
    if not (banded.composed_enabled(H) and banded.composed_enabled(W)):
        return None
    ops = _fwd_operators(
        filters["h0o"], filters["h1o"], filters["h0a"], filters["h1a"],
        filters["h0b"], filters["h1b"], J, tuple(skip_hps),
        tuple(include_scale), mode, H, W, x.device)
    if ops is None:
        return None
    od, rd, _, _ = get_dimensions5(o_dim, ri_dim)
    lls, yh = fused_dtcwt.analysis_pyramid(x, ops, od, rd)
    if True in include_scale:
        return [lls[j] if include_scale[j] else None for j in range(J)], yh
    return lls[-1], yh


@budgeted_plan_cache   # entries hold O(n^2) composed operator matrices
def _inv_pyramid_plan(g0o, g1o, g0a, g1a, g0b, g1b, mode, yl_hw, highs_hw):
    """Composed inverse plan from coefficient shapes.

    yl_hw: (H, W) of the lowpass or None; highs_hw: fine-first tuple of
    (h, w) band-corner sizes or None per level.  Returns (levels, ll_spec,
    out_hw) or None for fallback."""
    J = len(highs_hw)
    kl = ((g0b, g0a), False)
    kh = ((g1b, g1a), True)

    def walk(axis):
        """Per-axis size walk coarse->fine: (n_j list, K_j crops, out_1)."""
        cur = yl_hw[axis] if yl_hw is not None else None
        ns, Ks = [None] * J, [None] * J
        for j in range(J - 1, -1, -1):
            hw = highs_hw[j]
            if hw is not None:
                n = 2 * hw[axis]
                if cur is not None and cur != n:
                    if cur != n + 2:
                        return None
                    K = np.zeros((n, cur), dtype=np.float32)
                    K[np.arange(n), np.arange(1, n + 1)] = 1.0
                else:
                    K = None
            else:
                if cur is None:
                    return None
                n, K = cur, None
            ns[j], Ks[j] = n, K
            if j > 0:
                cur = 2 * n                       # colifilt upsamples x2
            else:
                cur = _filter_matrix(g0o, mode, n).shape[0]
        return ns, Ks, cur

    wh = walk(0)
    ww = walk(1)
    if wh is None or ww is None:
        return None
    ns_h, Ks_h, out_h = wh
    ns_w, Ks_w, out_w = ww

    levels = []
    pre_h, pre_w = None, None        # prefix operator (x-res, level input)
    for j in range(J):
        nh, nw = ns_h[j], ns_w[j]
        if j == 0:
            # reference inv_j1 uses the caller mode when bandpasses exist
            # but colfilter's default (symmetric) in the lowpass-only
            # branch (reference transform_funcs.py:159 vs :166-177)
            m1 = mode if highs_hw[0] is not None else "symmetric"
            C0 = _filter_matrix(g0o, m1, nh)
            C1 = _filter_matrix(g1o, m1, nh)
            R0 = _filter_matrix(g0o, m1, nw)
            R1 = _filter_matrix(g1o, m1, nw)
        else:
            if nh % 2 or nw % 2:
                return None
            C0 = _ifilt_matrix(*kl[0], kl[1], nh)
            C1 = _ifilt_matrix(*kh[0], kh[1], nh)
            R0 = _ifilt_matrix(*kl[0], kl[1], nw)
            R1 = _ifilt_matrix(*kh[0], kh[1], nw)
        R0_c, R1_c = _compose(R0.T, None if pre_w is None else pre_w.T).T, \
            _compose(R1.T, None if pre_w is None else pre_w.T).T
        C0_c = banded.compose(pre_h, C0) if pre_h is not None else C0
        C1_c = banded.compose(pre_h, C1) if pre_h is not None else C1
        lev = None
        if highs_hw[j] is not None:
            lev = {"bands": [("lh", (R0_c, C1_c)), ("hl", (R1_c, C0_c)),
                             ("hh", (R1_c, C1_c))]}
        levels.append(lev)
        # extend prefix through this level's lowpass branch + next crop
        step_h = C0_c if Ks_h[j] is None else banded.compose(C0_c, Ks_h[j])
        step_w = R0_c if Ks_w[j] is None else banded.compose(R0_c, Ks_w[j])
        pre_h, pre_w = step_h, step_w
    ll_spec = (pre_w, pre_h) if yl_hw is not None else None
    return tuple(levels), ll_spec, (out_h, out_w)


@budgeted_plan_cache   # entries hold the plan's operators on one device
def inv_pyramid_operators(*args):
    """Device form of :func:`_inv_pyramid_plan` (same arguments, then the
    device), or None."""
    *plan_args, device = args
    plan = _inv_pyramid_plan(*plan_args)
    if plan is None:
        return None
    levels, ll_spec, _ = plan
    return fused_dtcwt.synthesis_operators(levels, ll_spec, device)
