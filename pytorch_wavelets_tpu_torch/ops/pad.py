"""Boundary extension for NCHW tensors (port of
``pytorch_wavelets_tpu/ops/pad.py``, B9).

Every mode is one closed-form index map, :func:`pad_index`, that gives
for each padded position the source sample it copies (or -1 for a zero)
and equals ``numpy.pad`` of ``arange(n)`` at any pad size: reflections
repeat with period 2n ('symmetric') or 2n - 2 ('reflect').  On the host
:func:`pad1d` applies it with ``index_select`` (the plain versions and the
operator probes); the CUDA kernels K6/K7 (``csrc/dwt_afb.cu``,
``csrc/dwt_sfb.cu``) evaluate the same formula per tap in their
``pad_src`` device function and never materialise a padded copy.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["pad1d", "pad_index", "PAD_MODES", "PAD_CODES"]

# mode -> the code the CUDA kernels' pad_src switches on
PAD_CODES = {
    "zero": 0,
    "constant": 0,       # torch F.pad 'constant' with value 0
    "symmetric": 1,      # half-sample symmetric (pywt/MATLAB 'sym')
    "reflect": 2,        # whole-sample reflect (torch 'reflect')
    "periodic": 3,
    "periodization": 3,  # periodization pads circularly once evened
    "replicate": 4,
}

PAD_MODES = tuple(PAD_CODES)


def pad_index(n: int, front: int, back: int, mode: str) -> np.ndarray:
    """Source index of each of the n + front + back padded positions of a
    length-``n`` axis (int64; -1 where the mode pads with a zero).  The
    formula of the kernels' ``pad_src``; equal to
    ``numpy.pad(numpy.arange(n), (front, back), mode)`` for every mode
    and pad size."""
    try:
        code = PAD_CODES[mode]
    except KeyError:
        raise ValueError(f"Unknown pad type: {mode}") from None
    i = np.arange(-front, n + back, dtype=np.int64)
    if code == 0:
        return np.where((i >= 0) & (i < n), i, -1)
    if code == 1:
        r = i % (2 * n)
        return np.where(r < n, r, 2 * n - 1 - r)
    if code == 2:
        if n == 1:
            return np.zeros_like(i)
        r = i % (2 * n - 2)
        return np.where(r < n, r, 2 * n - 2 - r)
    if code == 3:
        return i % n
    return np.clip(i, 0, n - 1)


def pad1d(x: torch.Tensor, front: int, back: int, axis: int,
          mode: str) -> torch.Tensor:
    """Pad one axis of ``x`` by (front, back) using a pywt-style mode."""
    if front == 0 and back == 0:
        return x
    if front < 0 or back < 0:
        raise ValueError(f"negative pad ({front}, {back})")
    axis = axis % x.ndim
    if PAD_CODES.get(mode) == 0:
        shape = list(x.shape)
        parts = []
        for k in (front, None, back):
            if k is None:
                parts.append(x)
            elif k:
                shape[axis] = k
                parts.append(x.new_zeros(shape))
        return torch.cat(parts, dim=axis)
    idx = pad_index(x.shape[axis], front, back, mode)
    return torch.index_select(x, axis, torch.as_tensor(idx, device=x.device))
