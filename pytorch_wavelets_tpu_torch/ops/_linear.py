"""Backwards of the port's linear autograd Functions, differentiable again.

A linear Function's backward applies a fixed linear map B to its
cotangents.  :func:`linear_backward` runs B as a Function of its own,
whose backward is B's transpose: the original Function again, called
through its ``.apply`` (``primal``), which is B's transpose wherever B is
that Function's exact adjoint (every pair this is used for).  So autograd
differentiates each backward again, to any order (Hessian-vector
products, gradient penalties), with no kernel beyond the pair's.  Without
``create_graph`` a backward runs under no_grad, and this Function costs
its Python call only: the first-order kernels and results do not change.
"""
from __future__ import annotations

import torch

__all__ = ["linear_backward"]


class _LinearBackward(torch.autograd.Function):
    """``adjoint(*grads)`` forward; ``primal(*cotangents)`` backward."""

    @staticmethod
    def forward(ctx, adjoint, primal, *grads):
        ctx.primal = primal
        ctx.given = tuple(g is not None for g in grads)
        return adjoint(*grads)

    @staticmethod
    def backward(ctx, *us):
        n = len(ctx.given)
        if all(u is None for u in us):
            return (None,) * (2 + n)
        ds = ctx.primal(*us)
        if isinstance(ds, torch.Tensor):
            ds = (ds,)
        return (None, None, *(d if given else None
                              for d, given in zip(ds, ctx.given)))


def linear_backward(adjoint, primal, *grads):
    """``adjoint(*grads)`` (a tensor, or a tuple of tensors and None), as
    a differentiable function of ``grads`` whose transpose is
    ``primal``: given the cotangents of ``adjoint``'s outputs (zeros for
    an unused tensor output, None for a None output), ``primal`` returns
    the cotangents of ``grads`` in their order (a tensor or a tuple)."""
    return _LinearBackward.apply(adjoint, primal, *grads)
