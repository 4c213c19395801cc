"""Multilevel DTCWT forward/inverse pyramids (functional).

Port of ``pytorch_wavelets_tpu/transforms/dtcwt_xfm.py`` (reference
semantics: pytorch_wavelets/dtcwt/transform2d.py:20-254): odd-size
replicate padding at level 1, the %4 replicate pads before every q-shift
level, skip_hps / include_scale, and the [1:-1] lowpass crops on the way
back up.  The whole-transform composed path runs where a plan exists and
``ops.banded.composed_enabled`` allows it (both axes at most
``MAX_MATMUL_N``); everywhere else, as in the JAX package, the per-level
path (``transforms/dtcwt.py:fwd_j1_op`` ... ``inv_j2plus_op``).
"""
from __future__ import annotations

import numpy as np
import torch

from pytorch_wavelets_tpu_torch.filters import biort as _biort
from pytorch_wavelets_tpu_torch.filters import qshift as _qshift
from pytorch_wavelets_tpu_torch.ops import banded
from pytorch_wavelets_tpu_torch.ops.dtcwt_fb import prep_taps
from pytorch_wavelets_tpu_torch.ops.fused_dtcwt import (
    canonical_bands, synthesis_pyramid,
)
from pytorch_wavelets_tpu_torch.transforms.dtcwt import (
    dtcwt2d_pyramid, fwd_j1_op, fwd_j2plus_op, get_dimensions5,
    get_dimensions6, inv_j1_op, inv_j2plus_op, inv_pyramid_operators,
)

__all__ = ["dtcwt_fwd_filters", "dtcwt_inv_filters", "dtcwt2d", "idtcwt2d"]


def _tup(taps) -> tuple:
    return tuple(float(v) for v in np.asarray(taps).ravel())


def dtcwt_fwd_filters(biort="near_sym_a", qshift="qshift_a"):
    """Resolve analysis filters -> dict of correlation-order tap tuples
    (h0o, h1o, h0a, h0b, h1a, h1b)."""
    if isinstance(biort, str):
        h0o, _, h1o, _ = _biort(biort)
    else:
        h0o, h1o = biort[0], biort[1]
    if isinstance(qshift, str):
        h0a, h0b, _, _, h1a, h1b, _, _ = _qshift(qshift)
    else:
        h0a, h0b, h1a, h1b = qshift[0], qshift[1], qshift[2], qshift[3]
    return {
        "h0o": _tup(prep_taps(h0o)), "h1o": _tup(prep_taps(h1o)),
        "h0a": _tup(prep_taps(h0a)), "h0b": _tup(prep_taps(h0b)),
        "h1a": _tup(prep_taps(h1a)), "h1b": _tup(prep_taps(h1b)),
    }


def dtcwt_inv_filters(biort="near_sym_a", qshift="qshift_a"):
    """Resolve synthesis filters -> dict of correlation-order tap tuples."""
    if isinstance(biort, str):
        _, g0o, _, g1o = _biort(biort)
    else:
        g0o, g1o = biort[0], biort[1]
    if isinstance(qshift, str):
        _, _, g0a, g0b, _, _, g1a, g1b = _qshift(qshift)
    else:
        g0a, g0b, g1a, g1b = qshift[0], qshift[1], qshift[2], qshift[3]
    return {
        "g0o": _tup(prep_taps(g0o)), "g1o": _tup(prep_taps(g1o)),
        "g0a": _tup(prep_taps(g0a)), "g0b": _tup(prep_taps(g0b)),
        "g1a": _tup(prep_taps(g1a)), "g1b": _tup(prep_taps(g1b)),
    }


def _replicate_pad_even(x):
    r, c = x.shape[2:]
    if r % 2 != 0:
        x = torch.cat([x, x[:, :, -1:]], dim=2)
    if c % 2 != 0:
        x = torch.cat([x, x[:, :, :, -1:]], dim=3)
    return x


def _replicate_pad_mod4(low):
    r, c = low.shape[2:]
    if r % 4 != 0:
        low = torch.cat([low[:, :, 0:1], low, low[:, :, -1:]], dim=2)
    if c % 4 != 0:
        low = torch.cat([low[:, :, :, 0:1], low, low[:, :, :, -1:]], dim=3)
    return low


def dtcwt2d(x, filters, J=3, skip_hps=False, include_scale=False,
            o_dim=2, ri_dim=-1, mode="symmetric"):
    """J-level forward DTCWT of an NCHW tensor.

    filters: dict from :func:`dtcwt_fwd_filters`.
    Returns (yl, yh) — or (scales, yh) when include_scale — with yh a list of
    6-orientation complex bandpass tensors, shape (N, C, 6, H', W', 2) for
    the default o_dim/ri_dim (reference: dtcwt/transform2d.py:87-147).
    """
    if o_dim % 6 == ri_dim % 6:
        raise ValueError("Orientations and real/imaginary parts must be "
                         "in different dimensions.")
    if not isinstance(skip_hps, (list, tuple)):
        skip_hps = [skip_hps] * J
    if not isinstance(include_scale, (list, tuple)):
        include_scale = [include_scale] * J
    if J == 0:
        return x, None

    x = _replicate_pad_even(x).contiguous()
    out = dtcwt2d_pyramid(x, filters, J, list(skip_hps),
                          list(include_scale), o_dim, ri_dim, mode)
    if out is not None:
        return out

    scales = [None] * J
    highs = [None] * J
    low, highs[0] = fwd_j1_op(x, filters["h0o"], filters["h1o"],
                              skip_hps[0], o_dim, ri_dim, mode)
    if include_scale[0]:
        scales[0] = low
    for j in range(1, J):
        low, highs[j] = fwd_j2plus_op(
            _replicate_pad_mod4(low), filters["h0a"], filters["h1a"],
            filters["h0b"], filters["h1b"], skip_hps[j], o_dim, ri_dim, mode)
        if include_scale[j]:
            scales[j] = low
    if True in include_scale:
        return scales, highs
    return low, highs


def _is_empty(h):
    return h is None or h.numel() == 0


def idtcwt2d(coeffs, filters, o_dim=2, ri_dim=-1, mode="symmetric"):
    """Inverse DTCWT (reference: dtcwt/transform2d.py:193-254).

    coeffs: (yl, yh); either may contain None entries (treated as zero).
    filters: dict from :func:`dtcwt_inv_filters`.
    """
    low, highs = coeffs
    od5, rd5, _, _ = get_dimensions5(o_dim, ri_dim)
    _, _, h_dim, w_dim = get_dimensions6(o_dim, ri_dim)
    sizes = []
    for s in highs:
        if _is_empty(s):
            sizes.append(None)
            continue
        # the reference's checks, in its order (transform2d.py:222-229)
        if s.ndim > o_dim % 6 and s.shape[o_dim % 6] != 6:
            raise ValueError("Inverse transform must have input with 6 "
                             "orientations")
        if s.ndim != 6:
            raise ValueError("Bandpass inputs must have 6 dimensions")
        if s.shape[ri_dim % 6] != 2:
            raise ValueError("Inputs must be complex with real and "
                             "imaginary parts in the ri dimension")
        sizes.append((s.shape[h_dim], s.shape[w_dim]))
    yl_hw = None if low is None else (low.shape[2], low.shape[3])
    dims = [d for hw in sizes if hw for d in hw] + list(yl_hw or ())
    if not dims:
        raise ValueError("idtcwt2d: no lowpass and no bandpass to invert")
    ops = None
    if all(banded.composed_enabled(2 * d) for d in dims):
        device = (low if low is not None
                  else next(s for s in highs if not _is_empty(s))).device
        ops = inv_pyramid_operators(
            filters["g0o"], filters["g1o"], filters["g0a"], filters["g1a"],
            filters["g0b"], filters["g1b"], mode, yl_hw, tuple(sizes),
            device)
    if ops is not None:
        bands = [None if _is_empty(s) else canonical_bands(s, od5, rd5)
                 for s in highs]
        y = synthesis_pyramid(None if low is None else low.contiguous(),
                              bands, ops)
        if y is not None:
            return y

    # the per-level path (JAX idtcwt2d's fallback)
    highs = [None if _is_empty(s) else s for s in highs]

    def _crop_low(low, s):
        r, c = low.shape[2:]
        if r != s.shape[h_dim] * 2:
            low = low[:, :, 1:-1]
        if c != s.shape[w_dim] * 2:
            low = low[:, :, :, 1:-1]
        return low

    for s in highs[1:][::-1]:
        if s is not None and low is not None:
            low = _crop_low(low, s)
        if s is not None or low is not None:
            low = inv_j2plus_op(low, s, filters["g0a"], filters["g1a"],
                                filters["g0b"], filters["g1b"], o_dim,
                                ri_dim, mode)
    if highs[0] is not None and low is not None:
        low = _crop_low(low, highs[0])
    return inv_j1_op(low, highs[0], filters["g0o"], filters["g1o"], o_dim,
                     ri_dim, mode)
