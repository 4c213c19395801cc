"""DTCWT whole-transform planners: cross-level operator composition.

Port of the composed-plan part of ``pytorch_wavelets_tpu/transforms/
dtcwt.py`` (reference semantics: pytorch_wavelets/dtcwt/transform_funcs.py
and transform2d.py).  Every level is linear, so level-j operators compose
through the lowpass chain on the host: the inter-level %4 replicate pads
and the inverse's [1:-1] crops are selection matrices and fold in exactly.
The composed forward computes every output directly from x; the composed
inverse scatters every level straight to x resolution.

The numpy plans are cached by their arguments (bounded by bytes); their
device form (``ops/fused_dtcwt.py:analysis_operators`` /
``synthesis_operators``) is cached per (plan key, device), so the
operators are uploaded once, not on every call.  The JAX package's
per-level level functions (``fwd_j1`` ... ``inv_j2plus_op``), its
fallback where no composed plan exists, are ROADMAP.md, "Still to
port" 2.
"""
from __future__ import annotations

import numpy as np
import torch

from pytorch_wavelets_tpu_torch.ops import banded, fused_dtcwt
from pytorch_wavelets_tpu_torch.ops.dtcwt_fb import (
    _dfilt_matrix, _filter_matrix, _ifilt_matrix,
)

__all__ = ["get_dimensions5", "get_dimensions6", "dtcwt2d_pyramid",
           "inv_pyramid_operators"]


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


def _plan_bytes(plan):
    """Total bytes held by a (nested) plan structure: numpy arrays, and
    device operators (anything with ``nbytes``)."""
    total = 0
    stack = [plan]
    while stack:
        p = stack.pop()
        if isinstance(p, (np.ndarray, banded.Operator)):
            total += p.nbytes
        elif isinstance(p, dict):
            stack.extend(p.values())
        elif isinstance(p, (list, tuple)):
            stack.extend(p)
    return total


_PLAN_CACHE_BUDGET = 4 << 30   # bytes of composed operator matrices kept


def _budgeted_plan_cache(fn):
    """LRU cache bounded by total held bytes, not entry count: composed
    plans near MAX_MATMUL_N hold hundreds of MB of operator matrices each,
    so a count-bounded cache could pin tens of GB of host RAM."""
    from collections import OrderedDict
    cache: "OrderedDict" = OrderedDict()
    sizes: dict = {}

    def wrapper(*args):
        if args in cache:
            cache.move_to_end(args)
            return cache[args]
        out = fn(*args)
        cache[args] = out
        sizes[args] = _plan_bytes(out) + 1
        while sum(sizes.values()) > _PLAN_CACHE_BUDGET and len(cache) > 1:
            old, _ = cache.popitem(last=False)
            del sizes[old]
        return out

    wrapper.cache_clear = lambda: (cache.clear(), sizes.clear())
    wrapper.__wrapped__ = fn
    return wrapper


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


@_budgeted_plan_cache   # entries hold O(n^2) composed operator matrices
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




@_budgeted_plan_cache   # entries hold the plan's operators on one device
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
    if H > banded.MAX_MATMUL_N or W > banded.MAX_MATMUL_N:
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


@_budgeted_plan_cache   # entries hold O(n^2) composed operator matrices
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


@_budgeted_plan_cache   # entries hold the plan's operators on one device
def inv_pyramid_operators(*args):
    """Device form of :func:`_inv_pyramid_plan` (same arguments, then the
    device), or None."""
    *plan_args, device = args
    plan = _inv_pyramid_plan(*plan_args)
    if plan is None:
        return None
    levels, ll_spec, _ = plan
    return fused_dtcwt.synthesis_operators(levels, ll_spec, device)
