"""Matmul precision policy for the operator-matmul kernels.

Same API as ``pytorch_wavelets_tpu/ops/precision.py``; the levels map to
Hopper arithmetic:

- ``"highest"`` (default): IEEE fp32 on the CUDA cores.  The hand-written
  kernels implement this level only.
- ``"high"``: 3xTF32 and ``"default"``: TF32.  No kernel implements them
  yet (ROADMAP.md, "Still to port" 7), so a CUDA tensor under
  either level raises ``NotImplementedError`` rather than silently
  running fp32.

The plain PyTorch versions of the kernels run under :func:`plain_flags`,
which turns TF32 off for ``"highest"`` — for cuBLAS *and* cuDNN, whose
``allow_tf32`` defaults to True.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch

__all__ = ["set_matmul_precision", "get_matmul_precision",
           "matmul_precision", "require_kernel_precision", "plain_flags"]

_LEVELS = ("highest", "high", "default")

_current = "highest"


def set_matmul_precision(level: str) -> None:
    """Set the global matmul precision: 'highest' | 'high' | 'default'."""
    global _current
    if level not in _LEVELS:
        raise ValueError(f"unknown precision {level!r}; "
                         f"expected one of {sorted(_LEVELS)}")
    _current = level


def get_matmul_precision() -> str:
    """The precision level used by the operator-matmul paths."""
    return _current


@contextmanager
def matmul_precision(level: str):
    """Context manager form of :func:`set_matmul_precision`."""
    global _current
    prev = _current
    set_matmul_precision(level)
    try:
        yield
    finally:
        _current = prev


def require_kernel_precision(kernel: str) -> None:
    """Raise unless the current level is one the CUDA kernels implement."""
    if _current != "highest":
        raise NotImplementedError(
            f"{kernel}: matmul precision {_current!r} has no CUDA kernel "
            f"yet (only 'highest', IEEE fp32); see ROADMAP.md, 'Still to "
            f"port' 7, precision kernels ('high' = 3xTF32, 'default' = "
            f"TF32)")


@contextmanager
def plain_flags():
    """TF32 flags for the plain PyTorch versions: off under 'highest'."""
    allow = _current != "highest"
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
