"""The shared pieces of ``pytorch_wavelets_tpu/ops/afb_sfb.py`` that the
DTCWT slice needs: tap flattening, the per-plane 1-D correlation, and the
small-probe length for operator extension.  The DWT filterbanks
themselves are a later slice (ROADMAP.md, "Still to port" 4).

Filter-tap convention: taps are in application (correlation) order.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["as_taps"]


def as_taps(h) -> np.ndarray:
    """Flatten any array-like filter (numpy, list or tensor) to a 1-D
    float64 numpy tap vector."""
    if isinstance(h, torch.Tensor):
        h = h.detach().cpu().numpy()
    return np.asarray(h, dtype=np.float64).ravel()


def _conv_axis(x, kernels, axis):
    """Correlate each (N,C) plane of ``x`` (N,C,H,W) along ``axis`` with a
    stack of 1-D kernels (unit stride, no padding: the callers pad).

    kernels: (n_out, L) array of taps in correlation order.
    Returns (N, C, n_out, H', W').  The JAX version's stride, dilation and
    padding arguments serve the DWT filterbanks, a later slice.
    """
    N, C, H, W = x.shape
    n_out, L = np.shape(kernels)
    if axis in (2, -2):
        w = np.reshape(kernels, (n_out, 1, L, 1))
    elif axis in (3, -1):
        w = np.reshape(kernels, (n_out, 1, 1, L))
    else:
        raise ValueError(f"axis must be 2 or 3, got {axis}")
    y = F.conv2d(x.reshape(N * C, 1, H, W),
                 torch.as_tensor(w, dtype=x.dtype, device=x.device))
    return y.reshape(N, C, n_out, *y.shape[2:])


def _ext_ns(L, dilation=1):
    """Small-probe length for operator extension: large enough that the
    boundary regions separate cleanly."""
    ns = max(256, 16 * L * dilation)
    return ns + (-ns) % 8
