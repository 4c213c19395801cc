"""The modules' common base, and the dtype helpers of the ``coeff_dtype``
dial (port of the matching functions of
``pytorch_wavelets_tpu/models/_base.py``)."""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

__all__ = ["canon_dtype", "cast_bands", "upcast_bands"]


def canon_dtype(coeff_dtype):
    """Canonicalize a user-supplied ``coeff_dtype`` (a torch dtype, its
    name such as ``"bfloat16"``, or a numpy dtype) to a torch dtype."""
    if coeff_dtype is None or isinstance(coeff_dtype, torch.dtype):
        return coeff_dtype
    name = (coeff_dtype if isinstance(coeff_dtype, str)
            else np.dtype(coeff_dtype).name)
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown coeff_dtype {coeff_dtype!r}")
    return dtype


def cast_bands(yh, dtype):
    """Cast concrete bandpass entries of a finest-first coefficient list
    to the storage dtype (the ``coeff_dtype`` dial narrows only the
    bandpass storage; the lowpass keeps the compute dtype)."""
    return [h if h is None or h.numel() == 0 else h.to(dtype) for h in yh]


def upcast_bands(yh, yl=None):
    """Upcast dial-narrowed bandpass storage at the start of an inverse.

    A *wider* lowpass is the signal that sub-f32 bandpasses are storage,
    not pipeline, dtype: those entries are upcast to ``yl.dtype``.  A
    natively narrow pipeline (bf16 lowpass *and* bandpasses) is left
    untouched.  A missing lowpass falls back to the dial interpretation:
    upcast to f32."""
    ref = yl
    if isinstance(ref, (list, tuple)):  # include_scale lowpass list
        ref = ref[-1] if len(ref) else None
    target = ref.dtype if isinstance(ref, torch.Tensor) else torch.float32
    if target.itemsize < 4:
        return yh  # natively narrow pipeline — nothing to upcast
    return [h.to(target) if (h is not None and h.numel()
                             and h.dtype.itemsize < 4) else h
            for h in yh]


class _TapsModule(nn.Module):
    """Holds the filter taps as float64 buffers on ``device``.

    The plans are keyed by the taps' host values, kept beside the buffers
    (reading CUDA buffers on every call would synchronise); loading a
    state dict refreshes them from the loaded buffers."""

    def __init__(self, filters, device, mesh, batch_chunk):
        super().__init__()
        # batch_chunk None, False or 0 is "off", as in the JAX package
        # (None is its auto dial, which the port leaves off)
        if mesh is not None or batch_chunk:
            raise NotImplementedError(
                "mesh= and batch_chunk are not ported yet (ROADMAP.md, "
                "queue A: A3 batch_chunk, A5 mesh=)")
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"{type(self).__name__}: CUDA is not available; pass "
                f"device='cpu' for the plain PyTorch path")
        self._filters = dict(filters)
        for name, taps in self._filters.items():
            self.register_buffer(name, torch.tensor(taps, dtype=torch.float64,
                                                    device=device))

    def _load_from_state_dict(self, *args, **kwargs):
        super()._load_from_state_dict(*args, **kwargs)
        self._filters = {name: tuple(getattr(self, name).double().cpu()
                                     .tolist()) for name in self._filters}

    def _check_device(self, *tensors):
        device = next(iter(self.buffers())).device
        for t in tensors:
            if t is not None and t.device != device:
                raise ValueError(f"{type(self).__name__} is on {device}, "
                                 f"its input on {t.device}")
