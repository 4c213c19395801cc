"""Boundary extension for NCHW tensors (port of
``pytorch_wavelets_tpu/ops/pad.py``).

Every non-constant mode is an exact index map computed by ``numpy.pad``
and applied with ``index_select``, so any pad size works (the conv probe
path pads tiny inputs by long filters).  Used on the host only, to probe
operator matrices; on the device the modes are folded into the operators.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["pad1d", "PAD_MODES"]

_NP_MODE = {
    "zero": "constant",
    "constant": "constant",  # torch F.pad 'constant' with value 0
    "symmetric": "symmetric",  # half-sample symmetric (pywt/MATLAB 'sym')
    "reflect": "reflect",      # whole-sample reflect (torch 'reflect')
    "replicate": "edge",
    "periodic": "wrap",
    "periodization": "wrap",   # periodization pads circularly once evened
}

PAD_MODES = tuple(_NP_MODE)


def pad1d(x: torch.Tensor, front: int, back: int, axis: int,
          mode: str) -> torch.Tensor:
    """Pad one axis of ``x`` by (front, back) using a pywt-style mode."""
    if front == 0 and back == 0:
        return x
    if front < 0 or back < 0:
        raise ValueError(f"negative pad ({front}, {back})")
    try:
        npmode = _NP_MODE[mode]
    except KeyError:
        raise ValueError(f"Unknown pad type: {mode}") from None
    axis = axis % x.ndim
    n = x.shape[axis]
    if npmode == "constant":
        shape = list(x.shape)
        parts = []
        for k in (front, None, back):
            if k is None:
                parts.append(x)
            elif k:
                shape[axis] = k
                parts.append(x.new_zeros(shape))
        return torch.cat(parts, dim=axis)
    idx = np.pad(np.arange(n), (front, back), mode=npmode)
    return torch.index_select(x, axis, torch.as_tensor(idx, device=x.device))
