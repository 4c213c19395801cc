"""The stencil halo route of the sharded DTCWT and scattering layers: the
port's counterpart of the JAX package's GSPMD fallbacks
(``pytorch_wavelets_tpu/parallel/sharded.py:_cached_gspmd_jit``), where
XLA's partitioner runs the single-device conv path with halos it inserts
itself.  Here the halos are explicit.

Level by level, along each tiled axis, the rank's tile takes the level's
filter halo from its neighbours (one K19 ring exchange,
``parallel/halo.py:halo_window``; a tile at the image's edge takes no
halo on that side, so the window starts or ends there and the level's
own boundary applies, 'symmetric' or 'zero', exactly as on one device:
the band windows are exchanged with re/im merged into W, where a
flipped halo would not be the bands' extension), the single-device level
runs on the window
(``transforms/dtcwt.py``: K8 at level 1, K9 past it, K10 in the
inverse, the bands by K2 / K3; the bandpass-diagonal taps h2 where the
filters carry them), and the rank keeps the outputs of its own tile.  The
scattering layers then pool (K11) and take the magnitudes (K4) on the
tiles.

A level's halo is the reach of its operators into their input
(:func:`level_halos`, measured on the host operators), rounded up to the
group the level works in: 2 samples at level 1 (the bands' 2x2 corners),
4 for a forward q-shift level (K9's quarter-phase groups, then the
bands' corners), 2 for an inverse q-shift level (K10's input pairs).  A
window's start, the tile's offset less the halo, then falls on a group
boundary at every level when the tiles are multiples of the alignment
:func:`axis_plan` requires (2^J for a J-level forward, 4 for
``ScatLayerj2``, 2 for ``ScatLayer``; for an inverse, band sizes that
divide and no [1:-1] crop).  A level whose tile is smaller than its halo
gathers that axis over its ranks for the level (``all_gather``) and
keeps its own outputs.

An axis that does not meet the rule (ragged, odd, a tile that is not a
multiple of the alignment, a pad the reference takes) is replicated over
its mesh dim, as the JAX package's ``_fit_spec`` replicates it: its
tiles are gathered once, the transform runs along the whole axis on every
rank of that dim (the other axis and the batch stay sharded), and each
rank keeps its ``torch.chunk`` of the outputs.  That moves more than a
halo, and warns once.

Every step is an autograd Function whose backward is its adjoint (the
halo's fold, the level's backward, ``reduce_scatter`` for a gather),
differentiable again.  ``LAST_PATH`` reads 'conv'.
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from pytorch_wavelets_tpu_torch.ops.dtcwt_fb import (
    _dfilt_matrix, _filter_matrix, _ifilt_matrix,
)
from pytorch_wavelets_tpu_torch.ops.fused_dtcwt import canonical_bands
from pytorch_wavelets_tpu_torch.parallel.halo import halo_window
from pytorch_wavelets_tpu_torch.parallel.sharded import (
    LAST_PATH, _AllGather, _axis, _ceil_to, _dtcwt_yh_spec, _global, _local,
    _pad_axis_to, _sp4, _yh_batch_axis6, pad_widths, warn_once,
)
from pytorch_wavelets_tpu_torch.transforms.dtcwt import (
    fwd_j1_rot_op, fwd_j2plus_rot_op, get_dimensions5, get_dimensions6,
    inv_j1_op, inv_j2plus_op,
)
from pytorch_wavelets_tpu_torch.transforms.dtcwt_xfm import (
    _replicate_pad_even, _replicate_pad_mod4,
)
from pytorch_wavelets_tpu_torch.transforms.scatternet import (
    _O_DIM, _RI_DIM, _scat_j1_head, _scat_j2_head, avg_pool2,
)

__all__ = ["conv_dtcwt2d", "conv_idtcwt2d", "conv_scat", "level_halos",
           "axis_plan"]


# --------------------------------------------------------------------------
# Host plans: halos and the per-axis rule
# --------------------------------------------------------------------------

def operator_reach(T):
    """How far the rows of a level operator T (M x n) reach into its
    input beyond the input samples each row stands for (row r stands for
    input samples [r n / M, (r + 1) n / M)): (left, right)."""
    T = np.asarray(T)
    M, n = T.shape
    r, c = np.nonzero(np.abs(T) > 0)
    first = (r * n) // M
    last = -(-(r + 1) * n // M) - 1
    return int(max(0, (first - c).max())), int(max(0, (c - last).max()))


_PROBE_N = 256     # probe length: longer than every bank's reach


@lru_cache(maxsize=None)
def level_halos(taps, kind, mode="symmetric"):
    """The halo of one level, in samples of its input, rounded up to the
    level's group: ``kind`` 'fwd1' (level-1 analysis, taps the filters of
    its branches), 'fwdq' (q-shift analysis, taps the (a, b) pairs),
    'inv1' or 'invq' (the syntheses)."""
    if kind in ("fwd1", "inv1"):
        mats = [_filter_matrix(t, mode, _PROBE_N) for t in taps]
        group = 2
    elif kind == "fwdq":
        mats = [_dfilt_matrix(hb, ha, hp, _PROBE_N)
                for ha, hb, hp in taps]
        group = 4
    else:
        mats = [_ifilt_matrix(gb, ga, hp, _PROBE_N)
                for ga, gb, hp in taps]
        group = 2
    reach = max(max(operator_reach(T)) for T in mats)
    return _ceil_to(reach, group)


def fwd_halos(filters, J, mode):
    """Each forward level's halo (level 1 first) for a filter dict with
    'h0o', 'h1o' (and 'h2o'), 'h0a' ... 'h1b' (and 'h2a', 'h2b')."""
    f = filters
    out = [level_halos(tuple(f[k] for k in ("h0o", "h1o", "h2o") if k in f),
                       "fwd1", "zero" if mode == "zero" else "symmetric")]
    if J > 1:
        pairs = [(f["h0a"], f["h0b"], False), (f["h1a"], f["h1b"], True)]
        if "h2a" in f:
            pairs.append((f["h2a"], f["h2b"], True))
        out += [level_halos(tuple(pairs), "fwdq")] * (J - 1)
    return out


def inv_halos(filters, J, mode):
    """Each inverse level's halo (level 1 first), in samples of its
    lowpass input."""
    f = filters
    out = [level_halos((f["g0o"], f["g1o"]), "inv1",
                       "zero" if mode == "zero" else "symmetric")]
    if J > 1:
        out += [level_halos(((f["g0a"], f["g0b"], False),
                             (f["g1a"], f["g1b"], True)), "invq")] * (J - 1)
    return out


class AxisPlan(NamedTuple):
    """One image axis on the route: its mesh dim (group, size, rank),
    whether it stays tiled (halo windows) or runs whole on every rank of
    its dim, and whether its tiles are gathered first (replicated)."""
    ax: object
    tiled: bool
    gather: bool


def axis_plan(n, ax, align):
    """The plan of an axis of ``n`` samples over the mesh dim ``ax``:
    tiled where it divides into tiles that are multiples of ``align``,
    whole where the dim has one rank, else replicated."""
    if ax.n == 1:
        return AxisPlan(ax, False, False)
    if n % ax.n == 0 and (n // ax.n) % align == 0:
        return AxisPlan(ax, True, False)
    return AxisPlan(ax, False, True)


def fwd_align(J):
    """The tile alignment of a J-level forward: every q-shift level's
    input tile a multiple of 4, level 1's even."""
    return 2 ** J if J > 1 else 2


def inv_tiles(yl_n, band_ns, n):
    """Whether an inverse axis tiles over ``n`` ranks: every present
    level's bands divide, and the lowpass chain takes no [1:-1] crop (a
    missing level's lowpass tile even)."""
    cur = yl_n if yl_n is not None else 2 * band_ns[-1]
    for j in range(len(band_ns) - 1, -1, -1):
        b = band_ns[j]
        if b is not None:
            if cur != 2 * b or b % n:
                return False
        elif cur % (2 * n):
            return False
        if j > 0:
            cur *= 2
    return True


# --------------------------------------------------------------------------
# Windows and cuts on local tiles
# --------------------------------------------------------------------------

def _warn_replicated(what, plans):
    names = [nm for nm, p in plans if p.gather]
    if names:
        axes = (f"{names[0]} axis does" if len(names) == 1
                else "H and W axes do")
        warn_once((what, tuple(names)), (
            f"{what}: the {axes} not tile the mesh for the stencil halo "
            f"route (ragged, odd, or tiles off the route's alignment): "
            f"gathered over its mesh dim, the transform runs along the "
            f"whole axis there, which moves more than a halo (the JAX "
            f"package replicates it likewise, _fit_spec)"))


def _gather_axes(t, dims, plans, logical):
    """``t`` (this rank's storage chunk) whole along every replicated
    axis: its tiles gathered over the dim, cut to the logical length."""
    for d, p, n in zip(dims, plans, logical):
        if p.gather:
            t = _AllGather.apply(t.contiguous(), d, p.ax.group).narrow(d, 0,
                                                                       n)
    return t


def _own_chunk(t, dims, plans):
    """This rank's ``torch.chunk`` of ``t`` along every replicated axis
    (zero-padded to ceil(length, n) first): its storage chunk."""
    for d, p in zip(dims, plans):
        if p.gather:
            n = p.ax.n
            t = _pad_axis_to(t, _ceil_to(t.shape[d], n), d)
            s = t.shape[d] // n
            t = t.narrow(d, p.ax.rank * s, s)
    return t


def _window(t, axis, p, halo):
    """The window of the local tile ``t`` along ``axis`` and the offset of
    the tile in it: the halo'd window (one K19 exchange) where the halo
    fits the tile, the whole axis (``all_gather``) where it does not; ``t``
    itself on an axis that is not tiled.  At the global edges the window
    takes no halo: it starts or ends at the image's edge, where the
    level's own boundary (its 'symmetric' or 'zero' pad) applies, as on
    one device."""
    if not p.tiled or halo == 0:
        return t, 0
    tile = t.shape[axis]
    if halo > tile:
        return (_AllGather.apply(t.contiguous(), axis, p.ax.group),
                p.ax.rank * tile)
    w = halo_window([t.contiguous()], axis, p.ax.group, halo, halo, "zero")
    left = 0 if p.ax.rank == 0 else halo
    right = 0 if p.ax.rank == p.ax.n - 1 else halo
    if left + right < 2 * halo:
        w = w.narrow(axis, halo - left, tile + left + right)
    return w, left


def _cut(t, dim, p, off, tile, num, den):
    """The own outputs of a window's output ``t`` along ``dim``: the
    window's input offset ``off`` and tile ``tile`` scaled by num / den."""
    if not p.tiled:
        return t
    return t.narrow(dim, off * num // den, tile * num // den)


def _view4(h):
    """Bands (N, C, 6, h, w, 2), contiguous, as (N, 6C, h, 2w): the halo
    exchange's NCHW, re/im merged into W."""
    N, C, _, hh, ww, _ = h.shape
    return h.reshape(N, 6 * C, hh, 2 * ww)


def _view6(v, C):
    N, _, hh, w2 = v.shape
    return v.reshape(N, C, 6, hh, w2 // 2, 2)


# --------------------------------------------------------------------------
# The forward levels
# --------------------------------------------------------------------------

def _fwd_levels(xl, f, J, skips, mode, o_dim, ri_dim, ph, pw, halos):
    """The J forward levels on local tiles (replicated axes whole).
    Returns (each level's lowpass, each level's bands or None), the rank's
    own outputs, the bands in the (o_dim, ri_dim) layout."""
    _, _, h6, w6 = get_dimensions6(o_dim, ri_dim)
    ll, lls, highs = xl, [], []
    for j in range(J):
        th, tw = ll.shape[2], ll.shape[3]
        win, ow = _window(ll, 3, pw, halos[j])
        win, oh = _window(win, 2, ph, halos[j])
        if j == 0:
            lo, hi = fwd_j1_rot_op(win, f["h0o"], f["h1o"], f.get("h2o"),
                                   skips[j], o_dim, ri_dim, mode)
            sl, sb = (1, 1), (1, 2)
        else:
            lo, hi = fwd_j2plus_rot_op(
                _replicate_pad_mod4(win), f["h0a"], f["h1a"], f["h0b"],
                f["h1b"], f.get("h2a"), f.get("h2b"), skips[j], o_dim,
                ri_dim, mode)
            sl, sb = (1, 2), (1, 4)
        ll = _cut(_cut(lo, 3, pw, ow, tw, *sl), 2, ph, oh, th, *sl)
        lls.append(ll)
        highs.append(None if hi is None else
                     _cut(_cut(hi, w6, pw, ow, tw, *sb), h6, ph, oh, th,
                          *sb))
    return lls, highs


def _input_tiles(x, mesh, what, ph, pw):
    """This rank's tile of ``x``, whole along the replicated axes."""
    H, W = x.shape[2], x.shape[3]
    storage = {d: _ceil_to(n, p.ax.n) for d, n, p in ((2, H, ph), (3, W, pw))
               if p.gather}
    xl = _local(x, mesh, _sp4(mesh), what, 0, storage)
    return _gather_axes(xl, (2, 3), (ph, pw), (H, W))


def conv_dtcwt2d(x, mesh, filters, J, mode, skip_hps, include_scale, o_dim,
                 ri_dim):
    """:func:`parallel.sharded_dtcwt2d` on the stencil halo route (the
    arguments as there, ``skip_hps`` / ``include_scale`` lists)."""
    what = "sharded_dtcwt2d"
    N, _, H, W = x.shape
    sp, hh = _axis(mesh, "spatial"), _axis(mesh, "spatial_h")
    al = fwd_align(J)
    ph = axis_plan(H, hh, al) if H % 2 == 0 else AxisPlan(hh, False,
                                                          hh.n > 1)
    pw = axis_plan(W, sp, al) if W % 2 == 0 else AxisPlan(sp, False,
                                                          sp.n > 1)
    _warn_replicated(what, [("H", ph), ("W", pw)])
    xl = _input_tiles(x, mesh, what, ph, pw)
    if H % 2 or W % 2:
        xl = _replicate_pad_even(xl)
    lls, highs = _fwd_levels(xl.contiguous(), filters, J, list(skip_hps),
                             mode, o_dim, ri_dim, ph, pw,
                             fwd_halos(filters, J, mode))
    LAST_PATH["dtcwt2d"] = "conv"
    sp4 = _sp4(mesh)
    _, _, h6, w6 = get_dimensions6(o_dim, ri_dim)
    b6 = _yh_batch_axis6(o_dim, ri_dim)
    yh_spec = _dtcwt_yh_spec(o_dim, ri_dim, sp4[2])

    def out(t, spec, dims, batch_axis):
        logical = {d: t.shape[d] for d, p in zip(dims, (ph, pw)) if p.gather}
        return _global(_own_chunk(t, dims, (ph, pw)), mesh, spec, N,
                       batch_axis, logical)
    yh = [None if h is None else out(h, yh_spec, (h6, w6), b6)
          for h in highs]
    lls = [out(ll, sp4, (2, 3), 0) for ll in lls]
    if True in include_scale:
        return [lls[j] if include_scale[j] else None for j in range(J)], yh
    return lls[-1], yh


# --------------------------------------------------------------------------
# The inverse levels
# --------------------------------------------------------------------------

def conv_idtcwt2d(low, highs, mesh, filters, mode, o_dim, ri_dim):
    """:func:`parallel.sharded_idtcwt2d` on the stencil halo route: the
    lowpass (or None) and the bands (None for a missing level; the
    levels past the coarsest present one dropped where the lowpass is
    missing)."""
    what = "sharded_idtcwt2d"
    od5, rd5, _, _ = get_dimensions5(o_dim, ri_dim)
    _, _, h6, w6 = get_dimensions6(o_dim, ri_dim)
    b6 = _yh_batch_axis6(o_dim, ri_dim)
    sp4 = _sp4(mesh)
    yh_spec = _dtcwt_yh_spec(o_dim, ri_dim, sp4[2])
    sp, hh = _axis(mesh, "spatial"), _axis(mesh, "spatial_h")
    sizes = [None if h is None else (h.shape[h6], h.shape[w6])
             for h in highs]
    yl_hw = None if low is None else (low.shape[2], low.shape[3])
    plans = []
    for a, ax in ((0, hh), (1, sp)):
        bands = [None if s is None else s[a] for s in sizes]
        if ax.n == 1:
            plans.append(AxisPlan(ax, False, False))
        elif inv_tiles(None if yl_hw is None else yl_hw[a], bands, ax.n):
            plans.append(AxisPlan(ax, True, False))
        else:
            plans.append(AxisPlan(ax, False, True))
    ph, pw = plans
    _warn_replicated(what, [("H", ph), ("W", pw)])
    N = low.shape[0] if low is not None else highs[-1].shape[b6]

    def tiles(t, spec, dims, batch_axis, hw):
        storage = {d: _ceil_to(n, p.ax.n)
                   for d, n, p in zip(dims, hw, plans) if p.gather}
        tl = _local(t, mesh, spec, what, batch_axis, storage)
        return _gather_axes(tl, dims, plans, hw)
    hs = [None if h is None else canonical_bands(
        tiles(h, yh_spec, (h6, w6), b6, s), od5, rd5).contiguous()
        for h, s in zip(highs, sizes)]
    ll = None if low is None else tiles(low, sp4, (2, 3), 0,
                                        yl_hw).contiguous()
    halos = inv_halos(filters, len(highs), mode)
    f = filters
    for j in range(len(highs) - 1, -1, -1):
        h = hs[j]
        if h is not None and ll is not None:
            # the reference's [1:-1] crops (whole axes only: a tiled axis
            # takes none)
            if ll.shape[2] != 2 * h.shape[3]:
                ll = ll[:, :, 1:-1]
            if ll.shape[3] != 2 * h.shape[4]:
                ll = ll[:, :, :, 1:-1]
        th = ll.shape[2] if ll is not None else 2 * h.shape[3]
        tw = ll.shape[3] if ll is not None else 2 * h.shape[4]
        lw = hw_ = None
        if ll is not None:
            lw, ow = _window(ll.contiguous(), 3, pw, halos[j])
            lw, oh = _window(lw, 2, ph, halos[j])
        if h is not None:
            # the bands at half the lowpass's rate: along W re/im merged
            # into the axis (2 values a band sample), so the halo and the
            # offset count lowpass samples; along H half of them
            C = h.shape[1]
            v, ow = _window(_view4(h), 3, pw, halos[j])
            v, oh = _window(v, 2, ph, halos[j] // 2)
            hw_ = _view6(v, C)
            oh *= 2
        if j == 0:
            y = inv_j1_op(lw, hw_, f["g0o"], f["g1o"], 2, -1, mode)
            s = (1, 1)
        else:
            y = inv_j2plus_op(lw, hw_, f["g0a"], f["g1a"], f["g0b"],
                              f["g1b"], 2, -1, mode)
            s = (2, 1)
        ll = _cut(_cut(y, 3, pw, ow, tw, *s), 2, ph, oh, th, *s)
    LAST_PATH["idtcwt2d"] = "conv"
    logical = {d: ll.shape[d] for d, p in ((2, ph), (3, pw)) if p.gather}
    return _global(_own_chunk(ll, (2, 3), (ph, pw)), mesh, sp4, N, 0,
                   logical)


# --------------------------------------------------------------------------
# The scattering layers
# --------------------------------------------------------------------------

def _pad_axis(t, axis, pad):
    """``t`` padded along ``axis`` as ``ScatLayer`` ('even') or
    ``ScatLayerj2`` ('mod8') pads (``sharded.pad_widths``)."""
    n = t.shape[axis]
    before, after = pad_widths(n, pad)
    before, after = min(before, n), min(after, n)   # as slices take them
    parts = [t.narrow(axis, 0, before)] if before else []
    parts.append(t)
    if after:
        parts.append(t.narrow(axis, n - after, after))
    return torch.cat(parts, dim=axis) if len(parts) > 1 else t


def conv_scat(x, mesh, filters, J, mode, magbias, combine_colour,
              bandpass_diag):
    """``ScatLayer`` (J=1) / ``ScatLayerj2`` (J=2) on the stencil halo
    route: the fronts level by level on K19 windows, the last lowpass
    pooled on the tiles (K11), the magnitudes on the tiles."""
    what = "sharded_scat_j2" if J == 2 else "sharded_scat_j1"
    N, _, H, W = x.shape
    sp, hh = _axis(mesh, "spatial"), _axis(mesh, "spatial_h")
    pad, q = ("mod8", 8) if J == 2 else ("even", 2)
    al = 4 if J == 2 else 2
    ph = axis_plan(H, hh, al) if H % q == 0 else AxisPlan(hh, False,
                                                          hh.n > 1)
    pw = axis_plan(W, sp, al) if W % q == 0 else AxisPlan(sp, False,
                                                          sp.n > 1)
    _warn_replicated(what, [("H", ph), ("W", pw)])
    xl = _input_tiles(x, mesh, what, ph, pw)
    for axis, p in ((2, ph), (3, pw)):
        if not p.tiled:
            xl = _pad_axis(xl, axis, pad)
    f = dict(filters)
    if not bandpass_diag:
        for k in ("h2o", "h2a", "h2b"):
            f.pop(k, None)
    for k in ("h0a", "h1a", "h0b", "h1b"):
        f.setdefault(k, f["h0o" if k[1] == "0" else "h1o"])

    def front(u, Jf):
        lls, highs = _fwd_levels(u.contiguous(), f, Jf, [False] * Jf, mode,
                                 _O_DIM, _RI_DIM, ph, pw,
                                 fwd_halos(f, Jf, mode))
        return avg_pool2(lls[-1]), highs
    if J == 2:
        s0, (h1, h2) = front(xl, 2)

        def order2(u):
            ll, (h3,) = front(u, 1)
            return ll, h3
        out = _scat_j2_head(s0, h1, h2, order2, magbias, combine_colour)
    else:
        ll, (h,) = front(xl, 1)
        out = _scat_j1_head(ll, h, magbias, combine_colour)
    LAST_PATH["scat_j2" if J == 2 else "scat_j1"] = "conv"
    logical = {d: out.shape[d] for d, p in ((2, ph), (3, pw)) if p.gather}
    return _global(_own_chunk(out, (2, 3), (ph, pw)), mesh, _sp4(mesh), N,
                   0, logical)
