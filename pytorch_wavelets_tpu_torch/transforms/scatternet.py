"""DTCWT scattering layers (functional).

Port of ``pytorch_wavelets_tpu/transforms/scatternet.py`` (reference
semantics: pytorch_wavelets/scatternet/lowlevel.py and layers.py).  The
linear segments of the scattering chain (the DTCWT levels and the 2x2
average pool of the last lowpass) run one of two ways, chosen as the JAX
package chooses on a device:

- composed: one analysis pyramid each (``ops/fused_dtcwt.py``), the pool
  folded into the final lowpass operators, where a plan exists and
  ``ops.banded.composed_enabled`` allows it;
- per level: the level Functions of ``transforms/dtcwt.py`` (K8/K9 and
  K2, their backwards K8/K10 and K3), the pool :func:`avg_pool2` (K11):
  the bandpass-diagonal ``near_sym_b_bp`` filters, axes above
  ``MAX_MATMUL_N``, shapes the plans reject, and
  ``set_operator_matmul(False)``.

Both write the bands as (N, 6, C, h, w, 2), re/im adjacent, which the
magnitude kernels (``ops/scat_mag.py``) read.  Gradients are the
pyramids', the levels', the pool's and the magnitudes' own backwards,
composed by autograd, and so are second-order gradients: each backward is
differentiable again (the magnitude's through K18).
"""
from __future__ import annotations

import numpy as np
import torch

from pytorch_wavelets_tpu_torch.ops import banded
from pytorch_wavelets_tpu_torch.ops._linear import linear_backward
from pytorch_wavelets_tpu_torch.ops.fused_dtcwt import (
    analysis_operators, analysis_pyramid,
)
from pytorch_wavelets_tpu_torch.ops.pool import avg_pool2_bwd, avg_pool2_fwd
from pytorch_wavelets_tpu_torch.ops.scat_mag import (
    scat_mag_bwd, scat_mag_bwd2, scat_mag_fwd,
)
from pytorch_wavelets_tpu_torch.transforms.dtcwt import (
    _fwd_pyramid_plan, fwd_j1_rot_op, fwd_j2plus_rot_op,
)
from pytorch_wavelets_tpu_torch.transforms.plan_cache import (
    budgeted_plan_cache,
)

__all__ = ["smooth_mag", "avg_pool2", "scat_layer_j1", "scat_layer_j2"]

# the bands' layout: orientations on dim 1 of the 5-D view, re/im last
_O_DIM, _RI_DIM = 1, 5


class _SmoothMag(torch.autograd.Function):
    """K4 forward; backward :class:`_SmoothMagBackward` (K5)."""

    @staticmethod
    def forward(ctx, h, bias, combine):
        ctx.save_for_backward(h)
        ctx.bias, ctx.combine = bias, combine
        return scat_mag_fwd(h, bias, combine)

    @staticmethod
    def backward(ctx, g):
        h, = ctx.saved_tensors
        return _SmoothMagBackward.apply(h, g.to(h.dtype), ctx.bias,
                                        ctx.combine), None, None


class _SmoothMagBackward(torch.autograd.Function):
    """The magnitude's backward as a function of (bands h, output
    cotangent g): K5 forward, :class:`_SmoothMagBwd2` (K18) backward (the
    cotangents of h and g)."""

    @staticmethod
    def forward(ctx, h, g, bias, combine):
        ctx.save_for_backward(h, g)
        ctx.bias, ctx.combine = bias, combine
        return scat_mag_bwd(h, g, bias, combine)

    @staticmethod
    def backward(ctx, u):
        h, g = ctx.saved_tensors
        dg, dh = _SmoothMagBwd2.apply(h, g, u.to(h.dtype), ctx.bias,
                                      ctx.combine)
        return dh, dg, None, None


def _dot(x, y, combine):
    """The sum of x * y over (re, im), and over C with ``combine``."""
    t = x[..., 0] * y[..., 0] + x[..., 1] * y[..., 1]
    return t.sum(dim=2, keepdim=True) if combine else t


class _SmoothMagBwd2(torch.autograd.Function):
    """K18 as a function of (h, g, u): (dg, dh) = (t / s,
    g (u - h t / s^2) / s) with s = sqrt(|h|^2 + bias^2) and t = <u, h>
    (sums over re/im, and C with ``combine``).  Its backward, for the
    cotangents (a, b) of (dg, dh), is differentiable again, to any order:

    - the cotangent of u is K5 of (h, a) plus K18's dh term of (h, g, b)
      (:class:`_SmoothMagBackward` and this Function again, so they run
      on the card as kernels);
    - the cotangents of g and h, the magnitude's third derivative, are
      PyTorch elementwise expressions, as JAX's autodiff computes them
      outside any kernel:
      dg' = <b, u> / s - t <b, h> / s^3 and
      dh' = a (u / s - t h / s^3)
      - g ((<b, u> h + t b + <b, h> u) / s^3 - 3 t <b, h> h / s^5).
    """

    @staticmethod
    def forward(ctx, h, g, u, bias, combine):
        ctx.save_for_backward(h, g, u)
        ctx.bias, ctx.combine = bias, combine
        return scat_mag_bwd2(h, g, u, bias, combine)

    @staticmethod
    def backward(ctx, a, b):
        h, g, u = ctx.saved_tensors
        bias, combine = ctx.bias, ctx.combine
        a, b = a.to(h.dtype), b.to(h.dtype)
        du = (_SmoothMagBackward.apply(h, a, bias, combine)
              + _SmoothMagBwd2.apply(h, g, b, bias, combine)[1])
        s = torch.sqrt(_dot(h, h, combine) + bias * bias)
        t, tb, tbu = (_dot(u, h, combine), _dot(b, h, combine),
                      _dot(b, u, combine))
        s3 = s * s * s
        dg = tbu / s - t * tb / s3
        # the per-coefficient factors broadcast over (re, im)
        a, g, s, s3, t, tb, tbu = (v.unsqueeze(-1)
                                   for v in (a, g, s, s3, t, tb, tbu))
        dh = (a * (u / s - t * h / s3)
              - g * ((tbu * h + t * b + tb * u) / s3
                     - 3 * t * tb * h / (s3 * s * s)))
        return dh, dg, du, None, None


def smooth_mag(h, bias, combine=False):
    """Differentiable smooth magnitude sqrt(re^2 + im^2 + bias^2) - bias of
    (N, 6, C, h, w, 2) bands (re^2 + im^2 summed over C with ``combine``):
    K4 forward, K5 backward (the ratios are recomputed, not saved), K18
    the backward's backward."""
    return _SmoothMag.apply(h, float(bias), bool(combine))


class _AvgPool2(torch.autograd.Function):
    """K11 forward, its adjoint backward, and the pool again as that
    backward's backward."""

    @staticmethod
    def forward(ctx, x):
        return avg_pool2_fwd(x)

    @staticmethod
    def backward(ctx, g):
        return linear_backward(avg_pool2_bwd, _AvgPool2.apply, g)


def avg_pool2(x):
    """Differentiable 2x2 average pool of an (N, C, H, W) tensor (H, W
    even): K11 forward, its adjoint backward."""
    return _AvgPool2.apply(x)


def _pool_matrix(n):
    P = np.zeros((n // 2, n), dtype=np.float64)
    P[np.arange(n // 2), 2 * np.arange(n // 2)] = 0.5
    P[np.arange(n // 2), 2 * np.arange(n // 2) + 1] = 0.5
    return P


def _pad_even(x):
    if x.shape[2] % 2 != 0:
        x = torch.cat([x, x[:, :, -1:]], dim=2)
    if x.shape[3] % 2 != 0:
        x = torch.cat([x, x[:, :, :, -1:]], dim=3)
    return x


def _pad_mod8(x):
    """Pad H and W up to a multiple of 8 by edge replication, split
    before/after like reference ScatLayerj2 (scatternet/layers.py:137-149)."""
    r, c = x.shape[2:]
    rem = r % 8
    if rem != 0:
        before, after = (8 - rem) // 2, (9 - rem) // 2
        x = torch.cat([x[:, :, :before], x, x[:, :, -after:]], dim=2)
    rem = c % 8
    if rem != 0:
        before, after = (8 - rem) // 2, (9 - rem) // 2
        x = torch.cat([x[:, :, :, :before], x, x[:, :, :, -after:]], dim=3)
    return x


def _pool_compose(spec):
    R, C = spec
    if R.shape[0] % 2 or C.shape[0] % 2:
        return None
    Rp = np.ascontiguousarray(banded.compose(_pool_matrix(R.shape[0]), R))
    Cp = np.ascontiguousarray(banded.compose(_pool_matrix(C.shape[0]), C))
    return (Rp, Cp)


@budgeted_plan_cache   # entries hold O(n^2) composed operator matrices
def _scat_front_plan(h0o, h1o, h0a, h1a, h0b, h1b, J, mode, H, W):
    """J-level analysis plan with the final lowpass pooled 2x2."""
    skips = (False,) * J
    incs = (False,) * J
    plan = _fwd_pyramid_plan(h0o, h1o, h0a, h1a, h0b, h1b, J, skips, incs,
                             mode, H, W)
    if plan is None:
        return None
    last = dict(plan[-1])
    pooled = _pool_compose(last["ll"])
    if pooled is None:
        return None
    last["ll"] = pooled
    return plan[:-1] + (last,)


@budgeted_plan_cache   # entries hold the plan's operators on one device
def _scat_front_operators(*args):
    *plan_args, device = args
    plan = _scat_front_plan(*plan_args)
    return None if plan is None else analysis_operators(plan, device)


def _scat_levels(x, filters, mode, J, bandpass_diag):
    """J DTCWT analysis levels of x, the final lowpass average-pooled.
    Returns (pooled_ll, [bands per level]), bands as (N, 6, C, h, w, 2):
    through the composed pyramid where it may run, else level by level
    (JAX ``_scat_levels`` and the per-level branches of its
    ``scat_layer_j1`` / ``scat_layer_j2``)."""
    H, W = x.shape[2], x.shape[3]
    ops = None
    if (not bandpass_diag and banded.composed_enabled(H)
            and banded.composed_enabled(W)):
        ops = _scat_front_operators(
            filters["h0o"], filters["h1o"],
            filters.get("h0a", filters["h0o"]),
            filters.get("h1a", filters["h1o"]),
            filters.get("h0b", filters["h0o"]),
            filters.get("h1b", filters["h1o"]), J, mode, H, W, x.device)
    if ops is not None:
        lls, yh = analysis_pyramid(x.contiguous(), ops, _O_DIM, _RI_DIM)
        return lls[-1], yh
    # the _rot ops without h2 (filters of no bandpass-diagonal bank) are
    # the plain ones
    f = filters
    ll, h = fwd_j1_rot_op(x, f["h0o"], f["h1o"], f.get("h2o"), False,
                          _O_DIM, _RI_DIM, mode)
    yh = [h]
    if J == 2:
        ll, h = fwd_j2plus_rot_op(ll, f["h0a"], f["h1a"], f["h0b"], f["h1b"],
                                  f.get("h2a"), f.get("h2b"), False, _O_DIM,
                                  _RI_DIM, mode)
        yh.append(h)
    return avg_pool2(ll), yh


def scat_layer_j1(x, filters, mode="symmetric", magbias=1e-2,
                  combine_colour=False, bandpass_diag=False):
    """One order of scattering at one scale (reference ScatLayer,
    scatternet/layers.py:11-79 + ScatLayerj1_f/_rot_f).

    filters: dict with correlation-order tap tuples 'h0o', 'h1o' (+ 'h2o'
    when bandpass_diag).  Returns (N, 7C, H/2, W/2), or (N, 9, H/2, W/2)
    when combine_colour.
    """
    x = _pad_even(x)
    if combine_colour and x.shape[1] != 3:
        raise ValueError("combine_colour requires 3 input channels")
    ll, (h,) = _scat_levels(x, filters, mode, 1, bandpass_diag)
    if combine_colour:
        r = smooth_mag(h, magbias, combine=True)   # (N, 6, 1, H/2, W/2)
        return torch.cat([ll, r[:, :, 0]], dim=1)
    r = smooth_mag(h, magbias)                      # (N, 6, C, H/2, W/2)
    Z = torch.cat([ll[:, None], r], dim=1)          # (N, 7, C, H/2, W/2)
    b, _, c, hh, ww = Z.shape
    return Z.reshape(b, 7 * c, hh, ww)


def scat_layer_j2(x, filters, mode="symmetric", magbias=1e-2,
                  combine_colour=False, bandpass_diag=False):
    """Second-order two-scale scattering (reference ScatLayerj2,
    scatternet/layers.py:82-172 + ScatLayerj2_f/_rot_f): the two-level
    front, then one level on the first order's magnitudes.

    filters: dict with tap tuples 'h0o','h1o','h0a','h0b','h1a','h1b'
    (+ 'h2o','h2a','h2b' when bandpass_diag).
    Returns (N, 49C, H/4, W/4) (or (N, 51, H/4, W/4) combined-colour).
    """
    x = _pad_mod8(x)
    if combine_colour and x.shape[1] != 3:
        raise ValueError("combine_colour requires 3 input channels")
    s0, (h1, h2) = _scat_levels(x, filters, mode, 2, bandpass_diag)

    if combine_colour:
        s1_j1 = smooth_mag(h1, magbias, combine=True)   # (N,6,1,H/2,W/2)
        s1_j2 = smooth_mag(h2, magbias, combine=True)   # (N,6,1,H/4,W/4)
        u1_ll, (h3,) = _scat_levels(s1_j1[:, :, 0], filters, mode, 1,
                                    bandpass_diag)
        s2_j1 = smooth_mag(h3, magbias)                 # (N,6,6,H/4,W/4)
        q = s2_j1.shape
        s2_j1 = s2_j1.reshape(q[0], 36, q[3], q[4])
        return torch.cat([s0, u1_ll, s1_j2[:, :, 0], s2_j1], dim=1)

    s1_j1 = smooth_mag(h1, magbias)                     # (N,6,C,H/2,W/2)
    s1_j2 = smooth_mag(h2, magbias)                     # (N,6,C,H/4,W/4)
    p = s1_j1.shape
    u1 = s1_j1.reshape(p[0], 6 * p[2], p[3], p[4])
    u1_ll, (h3,) = _scat_levels(u1, filters, mode, 1,   # pooled
                                bandpass_diag)
    s2_j1 = smooth_mag(h3, magbias)                     # (N,6,6C,H/4,W/4)
    q = s2_j1.shape
    s2_j1 = s2_j1.reshape(q[0], 36, q[2] // 6, q[3], q[4])
    s1_j1 = u1_ll.reshape(p[0], 6, p[2], p[3] // 2, p[4] // 2)
    Z = torch.cat([s0[:, None], s1_j1, s1_j2, s2_j1], dim=1)
    b, _, c, hh, ww = Z.shape
    return Z.reshape(b, 49 * c, hh, ww)
