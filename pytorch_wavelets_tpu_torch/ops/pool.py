"""Kernel K11: the scattering layers' 2x2 average pool and its adjoint
(``csrc/avg_pool2.cu``).  The autograd entry point over them is
``transforms/scatternet.py:avg_pool2``.

K11 replaces the JAX package's ``transforms/scatternet.py:avg_pool2``
(part of B6), which the per-level scattering path runs on each level's
lowpass; the composed path folds the pool into its operators instead.
:func:`avg_pool2_fwd` is the 2x2 mean of the trailing two dims,
:func:`avg_pool2_bwd` its adjoint (1/4 of the cotangent broadcast over
each 2x2 block).  Both are bound by bytes.  Their plain PyTorch versions
fix the order of the sums, so the kernel is bit-equal to them; CPU
tensors take them.
"""
from __future__ import annotations

import torch

from pytorch_wavelets_tpu_torch.ops import _cuda

__all__ = ["avg_pool2_fwd", "avg_pool2_bwd", "avg_pool2_fwd_plain",
           "avg_pool2_bwd_plain"]


def avg_pool2_fwd_plain(x):
    """Plain PyTorch version of :func:`avg_pool2_fwd`."""
    top = x[:, :, 0::2, 0::2] + x[:, :, 0::2, 1::2]
    bot = x[:, :, 1::2, 0::2] + x[:, :, 1::2, 1::2]
    return (top + bot) * 0.25


def avg_pool2_bwd_plain(g):
    """Plain PyTorch version of :func:`avg_pool2_bwd`."""
    N, C, h, w = g.shape
    return (g * 0.25)[:, :, :, None, :, None].expand(
        N, C, h, 2, w, 2).reshape(N, C, 2 * h, 2 * w)


def _check(kernel, t):
    if t.ndim != 4:
        raise ValueError(f"{kernel}: expected an (N, C, H, W) tensor, got "
                         f"{tuple(t.shape)}")


def avg_pool2_fwd(x):
    """2x2 average pool of the (N, C, H, W) ``x`` (H, W even), read through
    its strides: a contiguous (N, C, H/2, W/2) tensor.  CPU tensors take
    :func:`avg_pool2_fwd_plain`; CUDA tensors launch K11."""
    _check("avg_pool2_fwd", x)
    N, C, H, W = x.shape
    if H % 2 or W % 2:
        raise ValueError(f"avg_pool2: {H}x{W} is not even")
    if x.device.type == "cpu":
        return avg_pool2_fwd_plain(x)
    _cuda.check_inputs("avg_pool2_fwd", x)
    y = torch.empty((N, C, H // 2, W // 2), device=x.device,
                    dtype=torch.float32)
    lib = _cuda.library("avg_pool2")
    _cuda.check(lib, "avg_pool2_fwd", lib.avg_pool2_fwd(
        x.data_ptr(), y.data_ptr(), N, C, H // 2, W // 2, *x.stride(),
        _cuda.stream_of(x)))
    _K11F.launches += 1
    return y


def avg_pool2_bwd(g):
    """The adjoint of :func:`avg_pool2_fwd` for the (N, C, h, w)
    cotangent ``g`` (any strides): a contiguous (N, C, 2h, 2w) tensor.
    CPU tensors take :func:`avg_pool2_bwd_plain`; CUDA tensors launch
    K11's adjoint."""
    _check("avg_pool2_bwd", g)
    if g.device.type == "cpu":
        return avg_pool2_bwd_plain(g)
    _cuda.check_inputs("avg_pool2_bwd", g)
    N, C, h, w = g.shape
    dx = torch.empty((N, C, 2 * h, 2 * w), device=g.device,
                     dtype=torch.float32)
    lib = _cuda.library("avg_pool2")
    _cuda.check(lib, "avg_pool2_bwd", lib.avg_pool2_bwd(
        g.data_ptr(), dx.data_ptr(), N, C, h, w, *g.stride(),
        _cuda.stream_of(g)))
    _K11B.launches += 1
    return dx


# counted through these names, as in ops/afb_sfb.py
_K11F, _K11B = avg_pool2_fwd, avg_pool2_bwd
_K11F.launches = _K11B.launches = 0
