"""The modules' common base, the dtype helpers of the ``coeff_dtype``
dial and the ``batch_chunk`` dial (port of the matching functions of
``pytorch_wavelets_tpu/models/_base.py``)."""
from __future__ import annotations

import warnings

import numpy as np
import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

__all__ = ["canon_dtype", "cast_bands", "upcast_bands", "batch_chunked",
           "resolve_chunk", "resolve_scat_chunk", "warn_chunk_dropped"]


def _leaves(tree):
    """The tensors of a nested tuple/list, in order, None entries
    skipped."""
    if isinstance(tree, (list, tuple)):
        return [a for t in tree for a in _leaves(t)]
    return [] if tree is None else [tree]


def _tree_map(fn, *trees):
    """``fn`` over the tensors of same-structured nested tuples/lists,
    None kept where the first tree has None."""
    t0 = trees[0]
    if isinstance(t0, (list, tuple)):
        return type(t0)(_tree_map(fn, *parts) for parts in zip(*trees))
    return None if t0 is None else fn(*trees)


def batch_chunked(fn, args, chunk):
    """Apply ``fn`` over leading-axis chunks of ``args`` (a tensor or a
    nested tuple/list of tensors and None, every tensor with the batch on
    axis 0) and concatenate the chunks' outputs along axis 0.

    A plain loop: each chunk's pyramids are live one at a time, so the
    working set is a chunk's, not the batch's; autograd differentiates
    through it (the slices and the concatenation) to any order.  Runs
    ``fn(args)`` unchunked when ``chunk`` is 0/None/False, when the batch
    does not exceed ``chunk``, and, with a warning, when the batch does
    not divide into whole chunks or the tensors disagree on the batch
    axis (the JAX package's rules and texts, its ``lax.map`` here a
    loop)."""
    if chunk and (not isinstance(chunk, int) or chunk < 0):
        raise ValueError(f"batch_chunk must be a positive int, got {chunk!r}")
    leaves = _leaves(args)
    if not leaves or not chunk:
        return fn(args)
    n = leaves[0].shape[0] if leaves[0].ndim else 0
    if n <= chunk or n % chunk or any(
            (not a.ndim) or a.shape[0] != n for a in leaves):
        if n > chunk:
            warnings.warn(
                f"batch_chunk={chunk} ignored: leading axis {n} does not "
                f"divide into whole chunks (or coefficient leaves disagree "
                f"on the batch axis); running unchunked. Pick a divisor of "
                f"the batch.", stacklevel=3)
        return fn(args)
    outs = [fn(_tree_map(lambda a: a[k:k + chunk], args))
            for k in range(0, n, chunk)]
    return _tree_map(lambda *parts: torch.cat(parts, dim=0), *outs)


# The JAX package's auto default (None) chunks inside regions it measured
# on a TPU v5e (its models/_base.py:_DROOP_* and _SCAT_*: the large-batch
# bandwidth droop of XLA's fusions).  Those are TPU measurements, not
# facts about the H100, so here None is "off" until an H100 measurement
# sets a threshold.


def resolve_chunk(batch_chunk, n, hw, elems):
    """Resolve the batch_chunk dial value to a concrete chunk (0 = off).
    None ("auto") is off on the card: the JAX package's thresholds are TPU
    v5e measurements.  ``n``, ``hw`` and ``elems`` (the batch, the pixels
    an image, the elements of the input) are what an H100 threshold would
    read; no threshold reads them yet."""
    del n, hw, elems
    return int(batch_chunk) if batch_chunk else 0


def resolve_scat_chunk(batch_chunk, n, chw):
    """ScatLayerj2's :func:`resolve_chunk`: None is off (the JAX
    package's ``_SCAT_*`` thresholds are TPU v5e measurements)."""
    del n, chw
    return int(batch_chunk) if batch_chunk else 0


def warn_chunk_dropped(cls_name, reason):
    """One-line warning when a model-level guard drops the batch_chunk
    dial entirely (a non-batch-leading layout): the same no-silent-ignore
    rule :func:`batch_chunked` applies to non-dividing batches."""
    warnings.warn(
        f"{cls_name}: batch_chunk ignored ({reason}); running unchunked.",
        stacklevel=3)


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
    state dict refreshes them from the loaded buffers.  ``mesh`` (a
    ``DeviceMesh``, ``parallel.make_mesh``) is kept for the module's
    sharded path."""

    def __init__(self, filters, device, mesh, batch_chunk):
        super().__init__()
        if mesh is not None and not isinstance(mesh, DeviceMesh):
            raise TypeError(f"{type(self).__name__}: mesh must be a "
                            f"torch.distributed DeviceMesh "
                            f"(parallel.make_mesh), got {type(mesh)}")
        self.mesh = mesh
        self.batch_chunk = batch_chunk
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
            if isinstance(t, DTensor):
                t = t.to_local()
            if t is not None and t.device != device:
                raise ValueError(f"{type(self).__name__} is on {device}, "
                                 f"its input on {t.device}")
