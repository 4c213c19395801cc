"""Sharded DWT, 1-D DWT and SWT on a device mesh (port of the
``sharded_dwt2d`` / ``sharded_idwt2d`` / ``sharded_dwt1d`` /
``sharded_idwt1d`` / ``sharded_swt2d`` / ``sharded_iswt2d`` part of
``pytorch_wavelets_tpu/parallel/sharded.py``; the names of its helpers
are kept).

The batch shards over 'data', W over 'spatial' and, on a 2-D tiling mesh,
H over 'spatial_h' (the 1-D DWT's length over 'spatial').  Two routes, as
in the JAX package (``_sharded_mm_wanted``: the operator route wherever
``banded.set_operator_matmul`` is None or True and the axes are at most
32768 samples):

- the **operator route** applies each level's split or merge as a banded
  operator along each axis under a strategy of ``parallel/sharded.py``:
  'local' (the axis is not sharded: K1), 'shard' (this rank's row chunk
  of the operator on its halo'd tile: one K19 exchange, then K1) or
  'gather' (a deep level whose halo exceeds the tile: the small axis
  gathered, the full operator applied, the rank's chunk kept).  The
  circular modes use the circular operators (the halos wrap round the
  ring); 'zero' / 'symmetric' / 'reflect' use **zero-embedded** operators
  (``parallel/sharded.py:embed_blocks``): any H / W, odd and ragged too, run at
  shard-divisible storage sizes (the inputs zero-padded, each level's
  outputs evenly sharded) and the outputs are cut to the logical pyramid,
  the halos zero at the image edges (K19's 'zero' side);
- the **conv halo route** (``set_operator_matmul(False)``, or an axis
  past 32768; circular modes, W tiled only) exchanges each level's
  filter-support halo along W (K19 'wrap' windows) and filters the window
  with a valid correlation (K6 / K7 through the window plans of
  ``ops/afb_sfb.py``, K12 / K16 for the SWT), and H locally (K6 / K7,
  K12 / K16).

``sharded_iswt2d`` in the non-circular modes, or with a raw tuple that
is not orthonormal, runs the least-squares merges of the inverse without
a mesh (``transforms/dwt.py:iswt2d``) on dense operators, each axis
gathered over its mesh dim (the JAX package runs the single-device
inverse under GSPMD there): the one sharded DWT / SWT entry that moves
more than a halo, and it warns once.

Every step is an autograd Function whose backward is its exact adjoint
(the JAX package's autodiff of its sharded entries), differentiable
again.  Inputs and outputs are DTensors placed as the JAX ``in_specs`` /
``out_specs`` (logical sizes, ``torch.chunk``'s layout where a dim does
not divide), or full tensors present on every rank.

Where this port leaves the JAX entries (``ROADMAP.md`` C):

- the sharded DWT takes no 'periodic' mode (ValueError): the JAX sharded
  entries build 'periodization' operators for every circular mode
  (``sharded_dwt2d`` l.723, ``sharded_idwt2d`` l.797, ``sharded_dwt1d``
  l.861), whose results differ from the JAX ``dwt2d`` in 'periodic';
- the 2-D DWT filters W with the first pair of a 4-tuple ``wave``, as the
  transform without a mesh does (``transforms/dwt.py:dwt2d``, the
  reference's argument-order quirk); the JAX sharded entries filter W
  with the second pair (the same for names, Wavelets and 2-tuples);
"""
from __future__ import annotations

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from pytorch_wavelets_tpu_torch.ops.afb_sfb import (
    _AFB1D, _AFB1DAtrous, _SFB1D, _SFB1DAtrous, _afb_atrous_matrix,
    _afb_matrix, _sfb_atrous_matrix, _sfb_matrix, atrous_merge_window,
    atrous_split_window, merge_window, split_window,
)
from pytorch_wavelets_tpu_torch.parallel.halo import halo_window
from pytorch_wavelets_tpu_torch.parallel.sharded import (
    _SHARDED_MM_CAP, LAST_PATH, _apply_merge2, _apply_strategy, _axis,
    _Strategy, _ceil_to, _check_mesh, _embedded_strategy, _global, _local,
    _mesh_sp, _n_data, _sharded_mm_wanted, _sp4, _strategy, embed_blocks,
    warn_once,
)
from pytorch_wavelets_tpu_torch.transforms.dwt import (
    _ISWT_PINV_MAX_N, _iswt_banded_ls, _iswt_fft_filters, _iswt_pinv,
    dec_filters, rec_filters,
)
from pytorch_wavelets_tpu_torch.transforms.plan_cache import (
    budgeted_plan_cache,
)

__all__ = ["sharded_dwt2d", "sharded_idwt2d", "sharded_dwt1d",
           "sharded_idwt1d", "sharded_swt2d", "sharded_iswt2d"]

# boundary modes whose operators have no wrap-around mass (zero-embedded
# operators); the circular modes keep the wrap halos
_EMBED_MODES = ("zero", "symmetric", "reflect")
_CIRCULAR_MODES = ("per", "periodization", "periodic")

_NO_PERIODIC = (
    "the sharded DWT has no 'periodic' route: the JAX package's sharded "
    "entries compute 'periodization' there, which differs from the "
    "transform without a mesh (ROADMAP.md C); use 'periodization' or a "
    "non-circular mode")


def _need_mm(what, mode):
    return ValueError(
        f"{what} mode='{mode}' requires the operator-matmul path "
        f"(banded.set_operator_matmul(None) or (True), axes of at most "
        f"{_SHARDED_MM_CAP} samples)")


def _need_mm_2d(what):
    return ValueError(f"{what}: 2-D (HxW) tiling requires the "
                      f"operator-matmul path (banded.set_operator_matmul("
                      f"None) or (True))")


def _dwt_mode(mode, what):
    """Raise for a mode the sharded DWT does not take."""
    if mode == "periodic":
        raise ValueError(f"{what}: {_NO_PERIODIC}")
    if mode not in _EMBED_MODES + _CIRCULAR_MODES:
        raise ValueError(f"{what}: unsupported sharded DWT mode: {mode}")


def _rev(h):
    return tuple(np.asarray(h, dtype=np.float64)[::-1].tolist())


def _fwd(h):
    return tuple(np.asarray(h, dtype=np.float64).ravel().tolist())


def _sp5(mesh):
    """Spec of an (N, C, bands, H, W) stack."""
    return ("data", None, None, _sp4(mesh)[2], "spatial")


_SP3 = ("data", None, "spatial")


# --------------------------------------------------------------------------
# Host plans: zero-embedded and circular per-level strategies (cached)
# --------------------------------------------------------------------------

@budgeted_plan_cache
def _dwt_mode_split_strategies(taps, mode, n0, n_shards, J):
    """Per-level strategies for one axis of a non-circular analysis
    pyramid over zero-embedded operators: (strategies, logical level
    sizes, storage level sizes); the level-0 input storage is
    ``ceil(n0 / q) * q``."""
    n = n0
    strats, logical, storage = [], [], []
    for _ in range(J):
        T = _afb_matrix(taps[0], taps[1], mode, n)
        M = T.shape[0] // 2
        st, (Mp, _) = _embedded_strategy(T, n_shards, [M, M], [n])
        strats.append(st)
        logical.append(M)
        storage.append(Mp)
        n = M
    return tuple(strats), tuple(logical), tuple(storage)


@budgeted_plan_cache
def _dwt_mode_merge_strategies(taps, mode, sizes, n_shards):
    """Per-level strategies (finest first, as ``sizes``) for one axis of
    a non-circular synthesis pyramid: level j's embedded operator crops
    the merged axis to the next finer level's band length (the
    reference's trailing lowpass crop) and pads rows and columns to
    shard-divisible storage.  Returns (strategies, (final logical length,
    final storage length))."""
    out, final = [], None
    for j, n in enumerate(sizes):
        T = _sfb_matrix(taps[0], taps[1], mode, n)
        tgt = T.shape[0] if j == 0 else min(T.shape[0], sizes[j - 1])
        st, (rows_p,) = _embedded_strategy(T[:tgt], n_shards, [tgt],
                                           [n, n])
        out.append(st)
        if j == 0:
            final = (tgt, rows_p)
    return tuple(out), final


@budgeted_plan_cache
def _swt_mode_split_strategies(taps, mode, n, n_shards, J):
    """Undecimated analysis strategies for a non-circular mode (sizes
    stay ``n``; storage pads a ragged axis): (strategies, storage)."""
    out = []
    for j in range(J):
        T = _afb_atrous_matrix(taps[0], taps[1], mode, 2 ** j, n)
        out.append(_embedded_strategy(T, n_shards, [n, n], [n])[0])
    return tuple(out), _ceil_to(n, n_shards)


@budgeted_plan_cache
def _dwt_split_strategies(taps, mode, n0, n_shards, J):
    """Per-level strategies for one axis of the circular analysis pyramid
    (an odd level size takes the periodization evening, which the local
    step matches by repeating the last row)."""
    strats = []
    n = n0
    for _ in range(J):
        n += n % 2
        T = _afb_matrix(taps[0], taps[1], mode, n)
        M = T.shape[0] // 2
        strats.append(_strategy(T, n_shards, [M, M], [n]))
        n = M
    return tuple(strats)


@budgeted_plan_cache
def _dwt_merge_strategies(taps, sizes, n_shards):
    """Per-level strategies for one axis of the circular synthesis
    pyramid; ``sizes``: per-level (finest first) lo / hi lengths."""
    out = []
    for n in sizes:
        T = _sfb_matrix(taps[0], taps[1], "periodization", n)
        out.append(_strategy(T, n_shards, [T.shape[0]], [n, n]))
    return tuple(out)


@budgeted_plan_cache
def _swt_split_strategies(taps, n, n_shards, J):
    return tuple(_strategy(_afb_atrous_matrix(taps[0], taps[1], "periodic",
                                              2 ** j, n), n_shards, [n, n],
                           [n]) for j in range(J))


@budgeted_plan_cache
def _swt_merge_strategies(taps, n, n_shards, J):
    return tuple(_strategy(_sfb_atrous_matrix(taps[0], taps[1], "periodic",
                                              2 ** j, n), n_shards, [n],
                           [n, n]) for j in range(J))


# --------------------------------------------------------------------------
# Local steps
# --------------------------------------------------------------------------

def _apply_split(x, strat, axis, ax):
    """Analysis split (a [lo; hi] operator) along ``axis`` under a
    strategy, stacked on a new dim 2: axis 2 -> (N, C, 2, M', W), axis 3
    -> (N, C, 2, H, M')."""
    y = _apply_strategy(x, strat, axis, ax)
    if axis == 2:
        return y.unflatten(2, (2, -1))
    return y.unflatten(3, (2, -1)).movedim(3, 2)


def _afb1d_per_sharded(x, taps, sp):
    """The periodization split along W of the local tile ``x``: its
    (L - 1 - L//2, L//2 - 1) 'wrap' halo from the ring (K19), then the
    valid stride-2 correlation of the window (K6)."""
    L = len(taps[0])
    L2 = L // 2
    left, right = L - 1 - L2, max(L2 - 1, 0)
    win = (halo_window([x], 3, sp.group, left, right, "wrap")
           if left or right else x)
    return split_window(win, *taps, 3, 0, (win.shape[3] - L) // 2 + 1)


def _sfb1d_per_sharded(lo, hi, taps, sp):
    """The periodization merge along W of the local tiles ``lo`` / ``hi``:
    their (ceil(L/4), L//4) 'wrap' halos (one K19 exchange for both),
    then the full transposed convolution's outputs [s, s + 2 w) of the
    windows (K7, ``ops/afb_sfb.py:sfb_window_plan``)."""
    L = len(taps[0])
    L2 = L // 2
    hl, hr = (L2 + 1) // 2, L2 // 2
    w = lo.shape[3]
    if hl or hr:
        win = halo_window([lo, hi], 3, sp.group, hl, hr, "wrap")
        nw = w + hl + hr
        lo, hi = win.narrow(3, 0, nw), win.narrow(3, nw, nw)
    return merge_window(lo, hi, *taps, 3, 2 * hl - L2 + L - 1, 2 * w)


def _afb1d_atrous_sharded(x, taps, sp, d):
    """The circular à trous split along W of the local tile: its
    (L d/2 - d, L d/2) 'wrap' halo (K19), then the valid dilated
    correlation of the window (K12)."""
    L2 = (len(taps[0]) * d) // 2
    win = halo_window([x], 3, sp.group, L2 - d, L2, "wrap")
    return atrous_split_window(win, *taps, 3, d)


def _sfb1d_atrous_sharded(lo, hi, taps, sp, d):
    """The circular à trous merge along W of the local tiles: their
    (L d/2, L d - d - L d/2) 'wrap' halos (one K19 exchange for both),
    then the valid merge of the windows (K16)."""
    Ld = len(taps[0]) * d
    front, back = Ld // 2, Ld - d - Ld // 2
    win = halo_window([lo, hi], 3, sp.group, front, back, "wrap")
    nw = lo.shape[3] + front + back
    return atrous_merge_window(win.narrow(3, 0, nw), win.narrow(3, nw, nw),
                               *taps, 3, d)


def _synth_out_len(n, L, mode):
    """Output length of one synthesis merge from ``n`` coefficients: 2 n
    for periodization, 2 n - L + 2 otherwise."""
    return 2 * n if mode in ("per", "periodization") else 2 * n - L + 2


def _none_highs_2d(yl_hw, yh, L, mode):
    """The None-as-zeros contract of the inverse without a mesh
    (``transforms/dwt.py:idwt2d``): a None level takes the running lowpass
    size, a concrete level's bands crop it.  Returns each level's band
    size (H, W), finest first (the JAX helper materialises the zeros;
    here each rank makes its own chunk of them)."""
    H, W = yl_hw
    out = [None] * len(yh)
    for j in range(len(yh) - 1, -1, -1):
        if yh[j] is not None:
            H, W = yh[j].shape[-2], yh[j].shape[-1]
        out[j] = (H, W)
        H, W = _synth_out_len(H, L, mode), _synth_out_len(W, L, mode)
    return out


def _none_highs_1d(n0, highs, L, mode):
    """1-D twin of :func:`_none_highs_2d`: each level's length."""
    n = n0
    out = [None] * len(highs)
    for j in range(len(highs) - 1, -1, -1):
        if highs[j] is not None:
            n = highs[j].shape[-1]
        out[j] = n
        n = _synth_out_len(n, L, mode)
    return out


def _device_of(t):
    return t.to_local().device if isinstance(t, DTensor) else t.device


def _local_or_zeros(h, mesh, spec, what, shape, like, storage=None):
    """:func:`_local` of ``h``, or this rank's chunk of the zeros a None
    entry stands for: ``shape`` its logical shape (the batch on dim 0),
    ``like`` the (dtype, device) of the lowpass, ``storage`` as
    :func:`_local`'s."""
    if h is not None:
        return _local(h, mesh, spec, what, 0, storage)
    full = dict(enumerate(shape))
    full.update(storage or {})
    full[0] = _ceil_to(shape[0], _n_data(mesh))
    local = [-(-full[d] // _axis(mesh, name).n) for d, name in
             enumerate(spec)]
    return torch.zeros(local, dtype=like[0], device=like[1])


def _cut(t, length, dim):
    """``t`` cut to ``length`` along ``dim`` (a full tensor; a DTensor must
    have it already)."""
    if t.shape[dim] == length:
        return t
    if isinstance(t, DTensor):
        raise ValueError(f"a DTensor of {tuple(t.shape)} where dim {dim} "
                         f"must be {length}")
    return t.narrow(dim, 0, length)


def _dwt_taps(wave):
    """(row (W) taps, column (H) taps), correlation order: the first pair
    of a 4-tuple filters W, as ``transforms/dwt.py:dwt2d``."""
    h0c, h1c, h0r, h1r = dec_filters(wave)
    return (_rev(h0c), _rev(h1c)), (_rev(h0r), _rev(h1r))


def _idwt_taps(wave):
    """(row (W) taps, column (H) taps), convolution order, paired as
    ``transforms/dwt.py:idwt2d``."""
    g0c, g1c, g0r, g1r = rec_filters(wave)
    return (_fwd(g0c), _fwd(g1c)), (_fwd(g0r), _fwd(g1r))


# --------------------------------------------------------------------------
# The 2-D DWT
# --------------------------------------------------------------------------

def sharded_dwt2d(x, mesh, wave="db4", J=3, mode="periodization"):
    """J-level 2-D DWT with N over 'data', W over 'spatial' and, on a
    ('data', 'spatial_h', 'spatial') mesh, H over 'spatial_h'.

    ``mode``: 'periodization' (wrap halos; a sharded axis must divide by
    its shards times 2**J) or 'zero' / 'symmetric' / 'reflect'
    (zero-embedded operators, any size); 'periodic' raises ValueError.
    The operator route by default (``banded.set_operator_matmul``); off it
    the conv halo route, periodization and W tiling only.  x: an (N, C,
    H, W) DTensor placed as ``parallel.spatial_placements`` or the full
    tensor on every rank.  Returns (yl, yh) DTensors, the pyramid of
    ``transforms.dwt.dwt2d``: yl placed as x, each yh (N, C, 3, H', W')
    with H' / W' on 'spatial_h' / 'spatial'."""
    what = "sharded_dwt2d"
    _check_mesh(mesh)
    _dwt_mode(mode, what)
    N, _, H, W = x.shape
    n_h, n_sp = _mesh_sp(mesh)
    rt, ct = _dwt_taps(wave)
    sp, hh = _axis(mesh, "spatial"), _axis(mesh, "spatial_h")
    sp4, sp5 = _sp4(mesh), _sp5(mesh)
    if mode in _EMBED_MODES:
        if not _sharded_mm_wanted(max(H, W)):
            raise _need_mm(what, mode)
        row_s, log_w, _ = _dwt_mode_split_strategies(rt, mode, W, n_sp, J)
        col_s, log_h, _ = _dwt_mode_split_strategies(ct, mode, H, n_h, J)
        ll = _local(x, mesh, sp4, what, 0,
                    {2: _ceil_to(H, n_h), 3: _ceil_to(W, n_sp)})
        mm, conv = True, False
    else:
        if W % (n_sp * 2 ** J):
            raise ValueError(f"{what}: W must divide evenly across spatial "
                             f"shards for J={J}")
        if n_h > 1 and H % (n_h * 2 ** J):
            raise ValueError(f"{what}: H must divide evenly across "
                             f"spatial_h shards for J={J}")
        mm = _sharded_mm_wanted(max(H, W))
        if n_h > 1 and not mm:
            raise _need_mm_2d(what)
        conv = not mm
        if mm:
            row_s = _dwt_split_strategies(rt, "periodization", W, n_sp, J)
            col_s = _dwt_split_strategies(ct, "periodization", H, n_h, J)
        ll = _local(x, mesh, sp4, what, 0)
    yh = []
    for j in range(J):
        Nl, C = ll.shape[:2]
        lohi = (_afb1d_per_sharded(ll, rt, sp) if conv
                else _apply_split(ll, row_s[j], 3, sp))
        lohi = lohi.reshape(Nl, 2 * C, *lohi.shape[3:])
        if conv:
            y = _AFB1D.apply(lohi, *ct, "periodization", 2)
        else:
            if mode not in _EMBED_MODES and n_h == 1 and lohi.shape[2] % 2:
                lohi = torch.cat([lohi, lohi[:, :, -1:]], dim=2)
            y = _apply_split(lohi, col_s[j], 2, hh)
        y = y.reshape(Nl, C, 4, *y.shape[3:])
        ll = y[:, :, 0]
        yh.append(y[:, :, 1:])
    LAST_PATH["dwt2d"] = "conv" if conv else "matmul"
    if mode in _EMBED_MODES:
        return (_global(ll, mesh, sp4, N, 0, {2: log_h[-1], 3: log_w[-1]}),
                [_global(h, mesh, sp5, N, 0, {3: log_h[j], 4: log_w[j]})
                 for j, h in enumerate(yh)])
    return (_global(ll, mesh, sp4, N, 0),
            [_global(h, mesh, sp5, N, 0) for h in yh])


def sharded_idwt2d(coeffs, mesh, wave="db4", mode="periodization"):
    """Inverse of :func:`sharded_dwt2d` on the same mesh: (yl, yh) as it
    returns them (DTensors) or full tensors; None bands are zeros (as
    ``transforms.dwt.idwt2d``).  Returns an (N, C, H, W) DTensor placed as
    yl."""
    what = "sharded_idwt2d"
    _check_mesh(mesh)
    _dwt_mode(mode, what)
    yl, yh = coeffs
    J = len(yh)
    n_h, n_sp = _mesh_sp(mesh)
    rg, cg = _idwt_taps(wave)
    L = len(rg[0])
    sp, hh = _axis(mesh, "spatial"), _axis(mesh, "spatial_h")
    sp4, sp5 = _sp4(mesh), _sp5(mesh)
    N, C = yl.shape[:2]
    sizes = _none_highs_2d(yl.shape[-2:], yh, L, mode)
    like = (yl.dtype, _device_of(yl))
    sizes_h = tuple(s[0] for s in sizes)
    sizes_w = tuple(s[1] for s in sizes)
    logical = None
    if mode in _EMBED_MODES:
        if not _sharded_mm_wanted(2 * max(sizes_w[0], sizes_h[0])):
            raise _need_mm(what, mode)
        row_s, (out_w, _) = _dwt_mode_merge_strategies(rg, mode, sizes_w,
                                                       n_sp)
        col_s, (out_h, _) = _dwt_mode_merge_strategies(cg, mode, sizes_h,
                                                       n_h)
        q_h = max(n_h, 1)
        yl = _cut(_cut(yl, sizes_h[-1], 2), sizes_w[-1], 3)
        ll = _local(yl, mesh, sp4, what, 0,
                    {2: _ceil_to(sizes_h[-1], q_h),
                     3: _ceil_to(sizes_w[-1], n_sp)})
        hs = [_local_or_zeros(h, mesh, sp5, what, (N, C, 3, *sizes[j]),
                              like, {3: _ceil_to(sizes_h[j], q_h),
                               4: _ceil_to(sizes_w[j], n_sp)})
              for j, h in enumerate(yh)]
        logical = {2: out_h, 3: out_w}
        mm = True
    else:
        W_out = yl.shape[-1] * 2 ** J
        mm = _sharded_mm_wanted(max(W_out, 2 * sizes_h[0]))
        if n_h > 1 and not mm:
            raise _need_mm_2d(what)
        if mm:
            row_s = _dwt_merge_strategies(
                rg, tuple(W_out // 2 ** (j + 1) for j in range(J)), n_sp)
            col_s = _dwt_merge_strategies(cg, sizes_h, n_h)
        ll = _local(yl, mesh, sp4, what, 0)
        hs = [_local_or_zeros(h, mesh, sp5, what, (N, C, 3, *sizes[j]),
                              like)
              for j, h in enumerate(yh)]
    for j in range(J - 1, -1, -1):
        h = hs[j]
        if mode not in _EMBED_MODES:
            # odd-H pyramids: the merged lowpass is one row longer than
            # the next level's bands
            ll = ll.narrow(2, 0, h.shape[-2])
        if mm:
            lo = _apply_merge2(ll, h[:, :, 0], col_s[j], 2, hh)
            hi = _apply_merge2(h[:, :, 1], h[:, :, 2], col_s[j], 2, hh)
            ll = _apply_merge2(lo, hi, row_s[j], 3, sp)
        else:
            lo = _SFB1D.apply(ll, h[:, :, 0], *cg, "periodization", 2)
            hi = _SFB1D.apply(h[:, :, 1], h[:, :, 2], *cg, "periodization",
                              2)
            ll = _sfb1d_per_sharded(lo, hi, rg, sp)
    LAST_PATH["idwt2d"] = "matmul" if mm else "conv"
    return _global(ll, mesh, sp4, N, 0, logical)


# --------------------------------------------------------------------------
# The 1-D DWT
# --------------------------------------------------------------------------

def sharded_dwt1d(x, mesh, wave="db4", J=3, mode="periodization"):
    """J-level 1-D DWT of an (N, C, L) tensor, N over 'data' and L over
    'spatial', on the operator route only (ValueError off it, or past
    32768 samples).  'periodization' needs L to divide by the shards
    times 2**J; 'zero' / 'symmetric' / 'reflect' take any L.  Returns
    (x0, [highs]) finest first, as ``transforms.dwt.dwt1d``, DTensors
    placed (N over 'data', L over 'spatial')."""
    what = "sharded_dwt1d"
    _check_mesh(mesh)
    _dwt_mode(mode, what)
    h0, h1 = dec_filters(wave)[:2]
    rt = (_rev(h0), _rev(h1))
    N, n = x.shape[0], x.shape[-1]
    n_sp = _axis(mesh, "spatial").n
    if not _sharded_mm_wanted(n):
        raise _need_mm(what, mode)
    logical = None
    if mode in _EMBED_MODES:
        strats, logical, _ = _dwt_mode_split_strategies(rt, mode, n, n_sp, J)
        xl = _local(x, mesh, _SP3, what, 0, {2: _ceil_to(n, n_sp)})
    else:
        if n % (n_sp * 2 ** J):
            raise ValueError(f"{what}: L must divide evenly across spatial "
                             f"shards for J={J}")
        strats = _dwt_split_strategies(rt, "periodization", n, n_sp, J)
        xl = _local(x, mesh, _SP3, what, 0)
    sp = _axis(mesh, "spatial")
    lo = xl[:, :, None]
    hs = []
    for j in range(J):
        y = _apply_split(lo, strats[j], 3, sp)
        lo = y[:, :, 0]
        hs.append(y[:, :, 1, 0])
    LAST_PATH["dwt1d"] = "matmul"

    def out(t, j):
        return _global(t, mesh, _SP3, N, 0,
                       None if logical is None else {2: logical[j]})
    return out(lo[:, :, 0], J - 1), [out(h, j) for j, h in enumerate(hs)]


def sharded_idwt1d(coeffs, mesh, wave="db4", mode="periodization"):
    """Inverse of :func:`sharded_dwt1d` (None highs are zeros)."""
    what = "sharded_idwt1d"
    _check_mesh(mesh)
    _dwt_mode(mode, what)
    x0, highs = coeffs
    J = len(highs)
    g0, g1 = rec_filters(wave)[:2]
    gt = (_fwd(g0), _fwd(g1))
    n_sp = _axis(mesh, "spatial").n
    N, C = x0.shape[:2]
    sizes = tuple(_none_highs_1d(x0.shape[-1], highs, len(gt[0]), mode))
    like = (x0.dtype, _device_of(x0))
    logical = None
    if mode in _EMBED_MODES:
        if not _sharded_mm_wanted(2 * sizes[0]):
            raise _need_mm(what, mode)
        strats, (out_n, _) = _dwt_mode_merge_strategies(gt, mode, sizes,
                                                        n_sp)
        lo = _local(_cut(x0, sizes[-1], 2), mesh, _SP3, what, 0,
                    {2: _ceil_to(sizes[-1], n_sp)})
        hs = [_local_or_zeros(h, mesh, _SP3, what, (N, C, sizes[j]), like,
                              {2: _ceil_to(sizes[j], n_sp)})
              for j, h in enumerate(highs)]
        logical = {2: out_n}
    else:
        n_out = x0.shape[-1] * 2 ** J
        if not _sharded_mm_wanted(n_out):
            raise _need_mm(what, mode)
        strats = _dwt_merge_strategies(
            gt, tuple(n_out // 2 ** (j + 1) for j in range(J)), n_sp)
        lo = _local(x0, mesh, _SP3, what, 0)
        hs = [_local_or_zeros(h, mesh, _SP3, what, (N, C, sizes[j]), like)
              for j, h in enumerate(highs)]
    sp = _axis(mesh, "spatial")
    for j in range(J - 1, -1, -1):
        lo = _apply_merge2(lo[:, :, None], hs[j][:, :, None], strats[j], 3,
                           sp)[:, :, 0]
    LAST_PATH["idwt1d"] = "matmul"
    return _global(lo, mesh, _SP3, N, 0, logical)


# --------------------------------------------------------------------------
# The SWT
# --------------------------------------------------------------------------

def sharded_swt2d(x, mesh, wave="db2", J=2, mode="periodic"):
    """J-level undecimated 2-D transform with N over 'data', W over
    'spatial' (and H over 'spatial_h'): the list of (N, C, 4, H, W)
    stacks of ``transforms.dwt.swt2d`` as DTensors.  Circular modes wrap
    their halos round the ring (a sharded axis must divide by its shards;
    the conv halo route off the operator route, W tiling only); 'zero' /
    'symmetric' / 'reflect' take zero-embedded operators (any size)."""
    what = "sharded_swt2d"
    _check_mesh(mesh)
    if mode not in _EMBED_MODES + _CIRCULAR_MODES:
        raise ValueError(f"{what}: unsupported sharded SWT mode: {mode}")
    h0c, h1c, h0r, h1r = dec_filters(wave)
    rt, ct = (_rev(h0r), _rev(h1r)), (_rev(h0c), _rev(h1c))
    N, _, H, W = x.shape
    n_h, n_sp = _mesh_sp(mesh)
    sp, hh = _axis(mesh, "spatial"), _axis(mesh, "spatial_h")
    sp4, sp5 = _sp4(mesh), _sp5(mesh)
    logical = None
    if mode in _EMBED_MODES:
        if not _sharded_mm_wanted(max(H, W)):
            raise _need_mm(what, mode)
        row_s, sw = _swt_mode_split_strategies(rt, mode, W, n_sp, J)
        col_s, sh = _swt_mode_split_strategies(ct, mode, H, n_h, J)
        ll = _local(x, mesh, sp4, what, 0, {2: sh, 3: sw})
        logical, mm = {3: H, 4: W}, True
    else:
        mm = _sharded_mm_wanted(max(H, W))
        if n_h > 1 and not mm:
            raise _need_mm_2d(what)
        if mm:
            row_s = _swt_split_strategies(rt, W, n_sp, J)
            col_s = _swt_split_strategies(ct, H, n_h, J)
        ll = _local(x, mesh, sp4, what, 0)
    out = []
    for j in range(J):
        d = 2 ** j
        Nl, C = ll.shape[:2]
        lohi = (_apply_split(ll, row_s[j], 3, sp) if mm
                else _afb1d_atrous_sharded(ll, rt, sp, d))
        lohi = lohi.reshape(Nl, 2 * C, *lohi.shape[3:])
        y = (_apply_split(lohi, col_s[j], 2, hh) if mm
             else _AFB1DAtrous.apply(lohi, *ct, "periodic", 2, d))
        y = y.reshape(Nl, C, 4, *y.shape[3:])
        ll = y[:, :, 0]
        out.append(y)
    LAST_PATH["swt2d"] = "matmul" if mm else "conv"
    return [_global(y, mesh, sp5, N, 0, logical) for y in out]


def _iswt_synth_filters(wave):
    """Synthesis bank for the circular sharded ISWT's averaging merge.

    ``wave`` resolves to the *analysis* filters of the forward.  Names
    and Wavelets carry their own synthesis bank, trusted only if it is
    perfect-reconstruction; a raw tap tuple is taken when the pair is
    orthonormal (|H0|^2 + |H1|^2 == 2 at every frequency: the synthesis
    is the time-reversed analysis).  None otherwise."""
    if isinstance(wave, str) or (
            hasattr(wave, "rec_lo") and hasattr(wave, "rec_hi")):
        rec = rec_filters(wave)
        dec = dec_filters(wave)
        for h0, h1, g0, g1 in ((dec[0], dec[1], rec[0], rec[1]),
                               (dec[2], dec[3], rec[2], rec[3])):
            if len(h0) != len(g0) or len(h1) != len(g1):
                return None
            p = np.convolve(g0, h0) + np.convolve(g1, h1)
            expect = np.zeros(len(p))
            expect[len(h0) - 1] = 2.0
            if not np.allclose(p, expect, atol=1e-8):
                return None
        return rec
    dec = dec_filters(wave)
    for h0, h1 in ((dec[0], dec[1]), (dec[2], dec[3])):
        spec = (np.abs(np.fft.fft(np.asarray(h0), 256)) ** 2 +
                np.abs(np.fft.fft(np.asarray(h1), 256)) ** 2)
        if not np.allclose(spec, 2.0, atol=1e-8):
            return None
    return tuple(_rev(f) for f in dec)


@budgeted_plan_cache
def _iswt_ls_strategies(taps, mode, d, n, q):
    """The least-squares merge of one axis of ``n`` samples at dilation
    ``d`` (``transforms/dwt.py:_merge_plan``'s branches) as strategies on
    zero-embedded storage over ``q`` ranks, applied in order: the dense
    pinv (n x 2n) up to ``_ISWT_PINV_MAX_N``, 'gather' (a dense operator
    couples every sample to every other: no halo reaches); past it the
    banded T^T as 'shard' (K19, then K1) and the dense G^-1 as 'gather' in
    the non-circular modes, the dense circulant of the FFT merge as
    'gather' in the circular ones."""
    if n <= _ISWT_PINV_MAX_N:
        mats = [(_iswt_pinv(*taps, mode, d, n, False), 2)]
    elif mode in _CIRCULAR_MODES:
        k = np.arange(n)
        mats = [(np.concatenate(
            [np.fft.ifft(G).real[(k[:, None] - k[None, :]) % n]
             for G in _iswt_fft_filters(*taps, d, n)], axis=1), 2)]
    else:
        Tt, Ginv = _iswt_banded_ls(*taps, mode, d, n, False)
        mats = [(Tt, 2), (Ginv, 1)]
    out = []
    for T, ncb in mats:
        E, rs, cs = embed_blocks(np.asarray(T, dtype=np.float32), q, [n],
                                 [n] * ncb)
        if q == 1:
            out.append(_Strategy("local", E))
        elif ncb == 2 and n > _ISWT_PINV_MAX_N and mode not in \
                _CIRCULAR_MODES:
            out.append(_strategy(E, q, rs, cs, wrap=False))     # T^T
        else:
            out.append(_Strategy("gather", (E, tuple(rs), tuple(cs))))
    return tuple(out)


def _ls_merge_sharded(lo, hi, strats, axis, ax):
    """The least-squares merge of local tiles ``lo`` / ``hi`` along
    ``axis`` under :func:`_iswt_ls_strategies`' strategies."""
    z = _apply_merge2(lo, hi, strats[0], axis, ax)
    for st in strats[1:]:
        z = _apply_strategy(z, st, axis, ax)
    return z


def _sharded_iswt2d_ls(coeffs, mesh, wave, mode):
    """The inverse SWT's least-squares merges on a mesh: the coarsest
    level first, two merges along H (LL with LH, HL with HH) then one
    along W, each on :func:`_iswt_ls_strategies`, the coefficients on
    zero-embedded storage (any H and W)."""
    what = "sharded_iswt2d"
    h0c, h1c, h0r, h1r = dec_filters(wave)
    tc, tr = (_rev(h0c), _rev(h1c)), (_rev(h0r), _rev(h1r))
    N = coeffs[0].shape[0]
    H, W = coeffs[0].shape[-2:]
    n_h, n_sp = _mesh_sp(mesh)
    warn_once((what, mode), f"{what}: mode={mode!r} with this wave takes "
              f"the least-squares merge, whose operators are dense: each "
              f"merge gathers its axis over its mesh dim (all_gather, "
              f"then reduce_scatter in the backward), which moves more "
              f"than a halo (the JAX package runs the transform under "
              f"GSPMD there)")
    sp, hh = _axis(mesh, "spatial"), _axis(mesh, "spatial_h")
    sh, sw = _ceil_to(H, n_h), _ceil_to(W, n_sp)
    cs = [_local(c, mesh, _sp5(mesh), what, 0, {3: sh, 4: sw})
          for c in coeffs]
    ll = cs[-1][:, :, 0]
    for j in range(len(coeffs) - 1, -1, -1):
        d = 2 ** j
        col = _iswt_ls_strategies(tc, mode, d, H, n_h)
        row = _iswt_ls_strategies(tr, mode, d, W, n_sp)
        c = cs[j]
        lo = _ls_merge_sharded(ll, c[:, :, 1], col, 2, hh)
        hi = _ls_merge_sharded(c[:, :, 2], c[:, :, 3], col, 2, hh)
        ll = _ls_merge_sharded(lo, hi, row, 3, sp)
    LAST_PATH["iswt2d"] = "matmul"
    return _global(ll, mesh, _sp4(mesh), N, 0, {2: H, 3: W})


def sharded_iswt2d(coeffs, mesh, wave="db2", mode="periodic"):
    """Inverse of :func:`sharded_swt2d` (``LAST_PATH['iswt2d']``): in the
    circular modes the sharded averaging merge with the true synthesis
    bank (:func:`_iswt_synth_filters`; ``wave`` names the forward's
    *analysis* wavelet, tuples are analysis taps), on the operator route
    ('matmul') or the conv halo route ('conv'); in the non-circular
    modes, and for raw tuples that are not orthonormal, the least-squares
    inverse of the transform without a mesh
    (``transforms/dwt.py:iswt2d``) on dense merge operators, each axis
    gathered over its mesh dim (:func:`_sharded_iswt2d_ls`, 'matmul';
    it warns once, as it moves more than a halo).  Returns an (N, C, H,
    W) DTensor."""
    what = "sharded_iswt2d"
    _check_mesh(mesh)
    if mode not in _EMBED_MODES + _CIRCULAR_MODES:
        raise ValueError(f"{what}: unsupported sharded SWT mode: {mode}")
    sf = _iswt_synth_filters(wave) if mode in _CIRCULAR_MODES else None
    if sf is None:
        return _sharded_iswt2d_ls(coeffs, mesh, wave, mode)
    g0c, g1c, g0r, g1r = sf
    rg, cg = (_fwd(g0r), _fwd(g1r)), (_fwd(g0c), _fwd(g1c))
    J = len(coeffs)
    N = coeffs[0].shape[0]
    H, W = coeffs[0].shape[-2:]
    n_h, n_sp = _mesh_sp(mesh)
    mm = _sharded_mm_wanted(max(H, W))
    if n_h > 1 and not mm:
        raise _need_mm_2d(what)
    if mm:
        row_s = _swt_merge_strategies(rg, W, n_sp, J)
        col_s = _swt_merge_strategies(cg, H, n_h, J)
    sp, hh = _axis(mesh, "spatial"), _axis(mesh, "spatial_h")
    cs = [_local(c, mesh, _sp5(mesh), what, 0) for c in coeffs]
    ll = cs[-1][:, :, 0]
    for j in range(J - 1, -1, -1):
        d = 2 ** j
        lh, hl, hh_ = cs[j][:, :, 1], cs[j][:, :, 2], cs[j][:, :, 3]
        if mm:
            lo = _apply_merge2(ll, lh, col_s[j], 2, hh)
            hi = _apply_merge2(hl, hh_, col_s[j], 2, hh)
            ll = _apply_merge2(lo, hi, row_s[j], 3, sp)
        else:
            lo = _SFB1DAtrous.apply(ll, lh, *cg, "periodic", 2, d)
            hi = _SFB1DAtrous.apply(hl, hh_, *cg, "periodic", 2, d)
            ll = _sfb1d_atrous_sharded(lo, hi, rg, sp, d)
    LAST_PATH["iswt2d"] = "matmul" if mm else "conv"
    return _global(ll, mesh, _sp4(mesh), N, 0)
