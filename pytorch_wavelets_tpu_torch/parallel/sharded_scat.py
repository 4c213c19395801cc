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
reshape runs on the rank's own tiles.  Two routes, as in the JAX package:

- the **composed** fronts (``LAST_PATH`` 'matmul') where both axes are at
  most ``MAX_MATMUL_N`` = 8832 and every front has a plan: one pyramid a
  front, the 2x2 pool of the last lowpass composed into its operators
  (``transforms/scatternet.py:_pool_compose``);
- the **per-level** fronts ('perlevel', the giant images past it, to
  32768 samples an axis): each level its own sharded pyramid
  (``_dtcwt_fwd_perlevel_shard_plans``), the last lowpass pooled on the
  local tiles (K11), which is exact because the tiles stay even (a tile
  a multiple of 8 for ``ScatLayerj2``, of 2 for ``ScatLayer``).

Inputs are the full tensor on every rank or a DTensor placed as
``parallel.spatial_placements``; the output is a DTensor placed as the
input, with the logical batch.  Every step is an autograd Function, so
gradients and higher orders cross the ranks.  Where the JAX package runs
the layer under GSPMD instead (the bandpass-diagonal filters, H or W not
a multiple of 8 for ``ScatLayerj2``, tiles that do not divide, no plan,
past 32768) the port raises ``NotImplementedError`` (``ROADMAP.md`` A5e);
it never gathers the image.
"""
from __future__ import annotations

from torch.distributed.tensor import DTensor

from pytorch_wavelets_tpu_torch.parallel.sharded import (
    A5E, LAST_PATH, _axis, _check_mesh, _dtcwt_fwd_perlevel_shard_plans,
    _global, _local, _mesh_sp, _mm_enabled, _pyramid_shard_op,
    _pyramid_stage2_strategies, _sharded_levels, _sharded_mm_wanted,
    _sharded_pyramid, _sp4,
)
from pytorch_wavelets_tpu_torch.transforms.plan_cache import (
    budgeted_plan_cache,
)
from pytorch_wavelets_tpu_torch.transforms.scatternet import (
    _O_DIM, _RI_DIM, _pad_even, _scat_front_plan, _scat_j1_head,
    _scat_j2_head, avg_pool2,
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


def _front_plans(what, taps, fronts, mode, n_sp, n_h, even):
    """The route and plans of a layer's fronts, ``fronts`` [(J, H, W)]
    with the layer's input first: the composed fronts where both axes
    allow it and every front has a plan, else the per-level ones (the
    input's tiles a multiple of ``even``).  Raises NotImplementedError
    where neither route applies."""
    _, H, W = fronts[0]
    if _mm_enabled(H) and _mm_enabled(W):
        plans = [_scat_shard_plans(*taps, J, mode, h, w, n_sp, n_h)
                 for J, h, w in fronts]
        if None not in plans:
            return "matmul", plans
    if not (_sharded_mm_wanted(H) and _sharded_mm_wanted(W)):
        why = (f"an axis of {H}x{W} is past 32768 samples"
               if max(H, W) > 32768 else "the operator route is off")
    elif W % (even * n_sp) or H % (even * n_h):
        why = (f"the {H}x{W} tiles of the per-level fronts on a "
               f"{n_h}x{n_sp} spatial mesh are not multiples of {even}")
    else:
        plans = [_dtcwt_fwd_perlevel_shard_plans(
            *taps, J, (False,) * J, mode, h, w, n_sp, n_h)
            for J, h, w in fronts]
        if None not in plans:
            return "perlevel", plans
        why = f"no sharded plan for {H}x{W} on a {n_h}x{n_sp} spatial mesh"
    raise NotImplementedError(f"{what}: {why}; {A5E}")


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


def _check_input(what, x, mesh, combine_colour, bandpass_diag, even):
    """The checks both layers share; returns the mesh's (n_h, n_sp)."""
    _check_mesh(mesh)
    if bandpass_diag:
        raise NotImplementedError(
            f"{what}: the bandpass-diagonal filters (near_sym_b_bp); "
            f"{A5E}")
    if combine_colour and x.shape[1] != 3:
        raise ValueError("combine_colour requires 3 input channels")
    H, W = x.shape[2], x.shape[3]
    if H % even or W % even:
        raise NotImplementedError(
            f"{what}: H and W must be multiples of {even} on a mesh, got "
            f"{H}x{W}; {A5E}")
    n_h, n_sp = _mesh_sp(mesh)
    if W % n_sp or H % n_h:
        raise NotImplementedError(
            f"{what}: a {H}x{W} input does not tile a {n_h}x{n_sp} "
            f"spatial mesh; {A5E}")
    return n_h, n_sp


def sharded_scat_j2(x, mesh, filters, mode="symmetric", magbias=1e-2,
                    combine_colour=False, bandpass_diag=False):
    """Second-order scattering (``ScatLayerj2``) with the batch over
    'data', W over 'spatial' (H over 'spatial_h' on a 2-D mesh): the two
    sharded fronts and the local magnitudes.

    x: an (N, C, H, W) DTensor placed as ``parallel.spatial_placements``
    or the full tensor on every rank, H and W multiples of 8; a batch
    that does not divide over 'data' is zero-padded and cut again.
    filters: the taps 'h0o', 'h1o', 'h0a', 'h0b', 'h1a', 'h1b'.  Returns
    the (N, 49C, H/4, W/4) (or (N, 51, ...) with ``combine_colour``)
    output as a DTensor placed as x."""
    what = "sharded_scat_j2"
    n_h, n_sp = _check_input(what, x, mesh, combine_colour, bandpass_diag,
                             8)
    N, _, H, W = x.shape
    f = filters
    taps = (f["h0o"], f["h1o"], f.get("h0a", f["h0o"]),
            f.get("h1a", f["h1o"]), f.get("h0b", f["h0o"]),
            f.get("h1b", f["h1o"]))
    route, (p2, p1) = _front_plans(what, taps, [(2, H, W),
                                                (1, H // 2, W // 2)],
                                   mode, n_sp, n_h, 8)
    sp, hh = _axis(mesh, "spatial"), _axis(mesh, "spatial_h")
    front2, front1 = _front(route, p2, sp, hh), _front(route, p1, sp, hh)
    sp4 = _sp4(mesh)
    s0, (h1, h2) = front2(_local(x, mesh, sp4, what, 0))

    def order2(u):
        ll, (h3,) = front1(u)
        return ll, h3
    out = _scat_j2_head(s0, h1, h2, order2, magbias, combine_colour)
    LAST_PATH["scat_j2"] = route
    return _global(out, mesh, sp4, N, 0)


def sharded_scat_j1(x, mesh, filters, mode="symmetric", magbias=1e-2,
                    combine_colour=False, bandpass_diag=False):
    """First-order scattering (``ScatLayer``) with the batch over 'data',
    W over 'spatial' (H over 'spatial_h' on a 2-D mesh): one sharded J=1
    front and the local magnitudes.

    x: an (N, C, H, W) DTensor placed as ``parallel.spatial_placements``
    (H and W even) or the full tensor on every rank (an odd H or W is
    edge-padded even first, as ``ScatLayer`` pads); a batch that does not
    divide over 'data' is zero-padded and cut again.  filters: the taps
    'h0o', 'h1o'.  Returns the (N, 7C, H/2, W/2) (or (N, 9, ...) with
    ``combine_colour``) output as a DTensor placed as x."""
    what = "sharded_scat_j1"
    if not isinstance(x, DTensor):
        x = _pad_even(x)
    n_h, n_sp = _check_input(what, x, mesh, combine_colour, bandpass_diag,
                             2)
    N, _, H, W = x.shape
    taps = (filters["h0o"], filters["h1o"]) * 3    # q-shift unused at J=1
    route, (plans,) = _front_plans(what, taps, [(1, H, W)], mode, n_sp,
                                   n_h, 2)
    front = _front(route, plans, _axis(mesh, "spatial"),
                   _axis(mesh, "spatial_h"))
    sp4 = _sp4(mesh)
    ll, (h,) = front(_local(x, mesh, sp4, what, 0))
    out = _scat_j1_head(ll, h, magbias, combine_colour)
    LAST_PATH["scat_j1"] = route
    return _global(out, mesh, sp4, N, 0)
