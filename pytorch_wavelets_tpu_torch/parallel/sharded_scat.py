"""Sharded scattering layers on a device mesh (port of ``sharded_scat_j2``
/ ``sharded_scat_j1`` and their fronts in
``pytorch_wavelets_tpu/parallel/sharded.py``; the names of its helpers
are kept).

The batch shards over 'data', W over 'spatial' and, on a 2-D tiling mesh,
H over 'spatial_h'.  The linear segments of a layer, its fronts, are
sharded analysis pyramids (``parallel/sharded.py:_sharded_pyramid``: one
ring exchange, K19, then K1 on the rank's block of the stage-1 row
operator; the stage-2 column operators under their strategies; the bands
written by K2 as (N, 6, C, h, w, 2), the layout the magnitudes read):

- ``ScatLayerj2``: orders 1 and 2 fused on (H, W), then order 2 over the
  first-order magnitudes on (H/2, W/2);
- ``ScatLayer``: one J=1 front.

Every magnitude (K4, backward K5, second order K18) and every channel
reshape runs on the rank's own tiles.  Three routes (``LAST_PATH``):

- the **composed** fronts ('matmul') where both axes are at most
  ``MAX_MATMUL_N`` = 8832, the input tiles the mesh and every front has a
  plan: one pyramid a front, the 2x2 pool of the last lowpass composed
  into its operators (``transforms/scatternet.py:_pool_compose``);
- the **per-level** fronts ('perlevel', to 32768 samples an axis): each
  level its own sharded pyramid on zero-embedded storage
  (``_dtcwt_fwd_perlevel_shard_plans``; any H and W, the reference's
  edge pad of ``ScatLayer`` or %8 pad of ``ScatLayerj2`` folded into
  level 1 for a DTensor input), the last lowpass pooled on the local
  tiles (K11), which is exact because its storage is a multiple of twice
  the shard counts;
- the **stencil halo** fronts ('conv', ``parallel/sharded_conv.py``) for
  the bandpass-diagonal filters (the JAX package always runs those under
  GSPMD), an axis past 32768 and ``set_operator_matmul(False)``.

Inputs are the full tensor on every rank or a DTensor placed as
``parallel.spatial_placements``; the output is a DTensor placed as the
input, with the logical batch and size.  Every step is an autograd
Function, so gradients and higher orders cross the ranks.
"""
from __future__ import annotations

from torch.distributed.tensor import DTensor

from pytorch_wavelets_tpu_torch.parallel.sharded import (
    LAST_PATH, _axis, _ceil_to, _check_mesh,
    _dtcwt_fwd_perlevel_shard_plans, _global, _local, _mesh_sp,
    _mm_enabled, _pad_matrix, _pyramid_shard_op, _pyramid_stage2_strategies,
    _sharded_levels, _sharded_mm_wanted, _sharded_pyramid, _sp4,
)
from pytorch_wavelets_tpu_torch.transforms.plan_cache import (
    budgeted_plan_cache,
)
from pytorch_wavelets_tpu_torch.transforms.scatternet import (
    _O_DIM, _RI_DIM, _pad_even, _pad_mod8, _scat_front_plan,
    _scat_j1_head, _scat_j2_head, avg_pool2,
)

__all__ = ["sharded_scat_j1", "sharded_scat_j2"]


@budgeted_plan_cache
def _scat_shard_plans(h0o, h1o, h0a, h1a, h0b, h1b, J, mode, H, W, n_sp,
                      n_h):
    """(stage-1 ShardedOp, stage-2 strategies) of a scattering front (the
    pyramid with its pooled lowpass), or None."""
    plan = _scat_front_plan(h0o, h1o, h0a, h1a, h0b, h1b, J, mode, H, W)
    if plan is None:
        return None
    op = _pyramid_shard_op(plan, W, n_sp)
    s2 = _pyramid_stage2_strategies(plan, n_h)
    if op is None or s2 is None:
        return None
    return op, s2


def _front_plans(taps, fronts, mode, n_sp, n_h, pad):
    """The route and plans of a layer's fronts, ``fronts`` [(J, H, W)]
    with the layer's input first (its logical size; the later fronts'
    inputs are padded already): the composed fronts where both axes allow
    it, the input tiles the mesh and every front has a plan; else, on the
    operator route, the per-level ones on zero-embedded storage (the
    input's ``pad`` folded into level 1, ``_pad_matrix``); else None (the
    stencil halo route)."""
    _, H, W = fronts[0]
    if (_mm_enabled(H) and _mm_enabled(W) and _pad_matrix(H, pad) is None
            and _pad_matrix(W, pad) is None and W % n_sp == 0
            and H % n_h == 0):
        plans = [_scat_shard_plans(*taps, J, mode, h, w, n_sp, n_h)
                 for J, h, w in fronts]
        if None not in plans:
            return "matmul", plans
    if _sharded_mm_wanted(H) and _sharded_mm_wanted(W):
        plans = [_dtcwt_fwd_perlevel_shard_plans(
            *taps, J, (False,) * J, mode, h, w, n_sp, n_h,
            pad if i == 0 else "even", True)
            for i, (J, h, w) in enumerate(fronts)]
        if None not in plans:
            return "perlevel", plans
    return None, None


def _front(route, plans, sp, hh):
    """A front on local tiles: ``front(x)`` -> (the last lowpass pooled
    2x2, [bands per level])."""
    if route == "matmul":
        def front(xl):
            lls, highs = _sharded_pyramid(xl.contiguous(), _O_DIM, _RI_DIM,
                                          *plans, sp, hh)
            return lls[-1], highs
    else:
        def front(xl):
            lls, highs = _sharded_levels(xl.contiguous(), plans, _O_DIM,
                                         _RI_DIM, sp, hh)
            return avg_pool2(lls[-1]), highs
    return front


def _check_input(x, mesh, combine_colour):
    """The checks both layers share; returns the mesh's (n_h, n_sp)."""
    _check_mesh(mesh)
    if combine_colour and x.shape[1] != 3:
        raise ValueError("combine_colour requires 3 input channels")
    return _mesh_sp(mesh)


def _storage(route, plans, H, W, n_h, n_sp):
    """(the input's storage {dim: length} on the per-level route, the
    output's logical {dim: length} from the first front's last level)."""
    if route == "matmul":
        return None, None
    h, w = plans[0][-1][1].bands
    return ({2: _ceil_to(H, n_h), 3: _ceil_to(W, n_sp)}, {2: h, 3: w})


def sharded_scat_j2(x, mesh, filters, mode="symmetric", magbias=1e-2,
                    combine_colour=False, bandpass_diag=False):
    """Second-order scattering (``ScatLayerj2``) with the batch over
    'data', W over 'spatial' (H over 'spatial_h' on a 2-D mesh): the two
    sharded fronts and the local magnitudes.

    x: an (N, C, H, W) DTensor placed as ``parallel.spatial_placements``
    (any H and W: the reference's %8 pad folds into level 1 of the
    per-level fronts) or the full tensor on every rank (padded to a
    multiple of 8 first, as ``ScatLayerj2`` pads); a batch that does not
    divide over 'data' is zero-padded and cut again.  The fronts run
    composed ('matmul'), per level on zero-embedded storage ('perlevel')
    or, for the bandpass-diagonal filters, past 32768 samples or with the
    operator route off, on the stencil halo route ('conv',
    ``parallel/sharded_conv.py``).  filters: the taps 'h0o', 'h1o',
    'h0a', 'h0b', 'h1a', 'h1b' (and 'h2o', 'h2a', 'h2b' with
    ``bandpass_diag``).  Returns the (N, 49C, H'/4, W'/4) (or (N, 51,
    ...) with ``combine_colour``) output, H' and W' padded to multiples
    of 8, as a DTensor placed as x."""
    what = "sharded_scat_j2"
    n_h, n_sp = _check_input(x, mesh, combine_colour)
    if not isinstance(x, DTensor):
        x = _pad_mod8(x)
    N, _, H, W = x.shape
    f = filters
    route = plans = None
    if not bandpass_diag:
        taps = (f["h0o"], f["h1o"], f.get("h0a", f["h0o"]),
                f.get("h1a", f["h1o"]), f.get("h0b", f["h0o"]),
                f.get("h1b", f["h1o"]))
        Hp, Wp = H + (-H) % 8, W + (-W) % 8
        route, plans = _front_plans(taps, [(2, H, W), (1, Hp // 2, Wp // 2)],
                                    mode, n_sp, n_h, "mod8")
    if route is None:
        from pytorch_wavelets_tpu_torch.parallel.sharded_conv import (
            conv_scat,
        )
        return conv_scat(x, mesh, filters, 2, mode, magbias, combine_colour,
                         bandpass_diag)
    p2, p1 = plans
    sp, hh = _axis(mesh, "spatial"), _axis(mesh, "spatial_h")
    front2, front1 = _front(route, p2, sp, hh), _front(route, p1, sp, hh)
    sp4 = _sp4(mesh)
    storage, logical = _storage(route, plans, H, W, n_h, n_sp)
    s0, (h1, h2) = front2(_local(x, mesh, sp4, what, 0, storage))

    def order2(u):
        ll, (h3,) = front1(u)
        return ll, h3
    out = _scat_j2_head(s0, h1, h2, order2, magbias, combine_colour)
    LAST_PATH["scat_j2"] = route
    return _global(out, mesh, sp4, N, 0, logical)


def sharded_scat_j1(x, mesh, filters, mode="symmetric", magbias=1e-2,
                    combine_colour=False, bandpass_diag=False):
    """First-order scattering (``ScatLayer``) with the batch over 'data',
    W over 'spatial' (H over 'spatial_h' on a 2-D mesh): one sharded J=1
    front and the local magnitudes.

    x: an (N, C, H, W) DTensor placed as ``parallel.spatial_placements``
    (any H and W: the edge pad of an odd size folds into the per-level
    front) or the full tensor on every rank (an odd H or W is edge-padded
    even first, as ``ScatLayer`` pads); a batch that does not divide over
    'data' is zero-padded and cut again.  The routes are
    :func:`sharded_scat_j2`'s.  filters: the taps 'h0o', 'h1o' (and
    'h2o' with ``bandpass_diag``).  Returns the (N, 7C, H'/2, W'/2) (or
    (N, 9, ...) with ``combine_colour``) output, H' and W' padded even,
    as a DTensor placed as x."""
    what = "sharded_scat_j1"
    n_h, n_sp = _check_input(x, mesh, combine_colour)
    if not isinstance(x, DTensor):
        x = _pad_even(x)
    N, _, H, W = x.shape
    route = plans = None
    if not bandpass_diag:
        taps = (filters["h0o"], filters["h1o"]) * 3  # q-shift unused at J=1
        route, plans = _front_plans(taps, [(1, H, W)], mode, n_sp, n_h,
                                    "even")
    if route is None:
        from pytorch_wavelets_tpu_torch.parallel.sharded_conv import (
            conv_scat,
        )
        return conv_scat(x, mesh, filters, 1, mode, magbias, combine_colour,
                         bandpass_diag)
    front = _front(route, plans[0], _axis(mesh, "spatial"),
                   _axis(mesh, "spatial_h"))
    sp4 = _sp4(mesh)
    storage, logical = _storage(route, plans, H, W, n_h, n_sp)
    ll, (h,) = front(_local(x, mesh, sp4, what, 0, storage))
    out = _scat_j1_head(ll, h, magbias, combine_colour)
    LAST_PATH["scat_j1"] = route
    return _global(out, mesh, sp4, N, 0, logical)
