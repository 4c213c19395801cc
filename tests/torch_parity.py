"""Shared helpers of the port's module parity tests
(tests/test_torch_*.py): one input through the JAX package and the
port, compared at the JAX suite's own tolerances (tests/test_dtcwt.py)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pytorch_wavelets_tpu as tw
from pytorch_wavelets_tpu.ops import banded as jbanded

import pytorch_wavelets_tpu_torch as tt

FWD_ATOL = 1e-5
INV_ATOL = 2e-5


@pytest.fixture(autouse=True)
def force_jax_matmul():
    """The JAX package's operator path: the path the port carries."""
    jbanded.set_operator_matmul(True)
    yield
    jbanded.set_operator_matmul(None)


@pytest.fixture(params=["matmul", "conv"])
def jax_path(request):
    """The JAX package's operator path (the port's counterpart), then its
    conv path (its CPU default)."""
    jbanded.set_operator_matmul(True if request.param == "matmul" else None)
    yield request.param
    jbanded.set_operator_matmul(None)


def rand(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _np(a):
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, dtype=np.float32)


def cmp(mine, ref, atol):
    """Same structure (None where None), same shapes, values within atol."""
    if ref is None:
        assert mine is None
        return
    if isinstance(ref, (list, tuple)):
        assert len(mine) == len(ref)
        for a, b in zip(mine, ref):
            cmp(a, b, atol)
        return
    assert tuple(mine.shape) == tuple(ref.shape)
    np.testing.assert_allclose(_np(mine), _np(ref), atol=atol)


def both(shape, seed=0, inv_kw=None, **kw):
    """Forward (and, with ``inv_kw``, inverse) of one input through both
    packages, compared; returns (x, JAX coefficients, port coefficients)."""
    x = rand(shape, seed)
    jf, pf = tw.DTCWTForward(**kw), tt.DTCWTForward(device="cpu", **kw)
    jy, py = jf(jnp.asarray(x)), pf(torch.from_numpy(x))
    cmp(py, jy, FWD_ATOL)
    if inv_kw is not None:
        ji = tw.DTCWTInverse(**inv_kw)
        pi = tt.DTCWTInverse(device="cpu", **inv_kw)
        cmp(pi(py), ji(jy), INV_ATOL)
    return x, jy, py
