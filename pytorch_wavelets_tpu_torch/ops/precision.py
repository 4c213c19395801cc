"""Matmul precision policy for the operator-matmul kernels.

Same API as ``pytorch_wavelets_tpu/ops/precision.py``; on a CUDA tensor
the levels are arithmetic modes of the operator products (``ops/banded.py``):

==========  ===========================  =====================
level       fp32 data                    bf16 data
==========  ===========================  =====================
"highest"   K1, IEEE fp32 (CUDA cores)   K17 bf16 mode
"high"      K17 3xTF32 mode              K17 bf16 mode
"default"   K17 TF32 mode                K17 bf16 mode
==========  ===========================  =====================

The CUDA-core stencils (K2-K16) compute in fp32 at every level: fp32 is
at least as exact as either level asks.  The CPU path is the plain
PyTorch versions, exact fp32 at every level (as JAX's CPU backend is).
A backward runs its transposes at the level of its forward: the autograd
Functions that apply operators keep the level on their context, as JAX's
transposes run at the precision of the traced forward.

The plain PyTorch versions of the kernels run under :func:`plain_flags`,
which turns TF32 off for cuBLAS *and* cuDNN (whose ``allow_tf32``
defaults to True) at every level: K17's modes have plain versions of
their own that round their operands explicitly (``ops/banded.py``).
"""
from __future__ import annotations

from contextlib import contextmanager

import torch

__all__ = ["set_matmul_precision", "get_matmul_precision",
           "matmul_precision", "plain_flags"]

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


@contextmanager
def plain_flags():
    """TF32 off (cuBLAS and cuDNN) for the plain PyTorch versions."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
