"""The port's DTCWT modules (CPU, plain path) == the JAX package's modules
with its operator path forced (the path the port carries), at the JAX
suite's own tolerances (tests/test_dtcwt.py)."""
import pytest
import torch

from tests.torch_parity import (  # noqa: F401
    both, force_jax_matmul,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("J", [1, 2, 3])
def test_fwd_inv(J):
    both((1, 2, 32, 32), J=J, inv_kw={})


@pytest.mark.parametrize("o_dim,ri_dim", [(1, 3), (0, 5), (4, 1), (5, 0)])
def test_layouts(o_dim, ri_dim):
    both((2, 1, 32, 32), J=2, o_dim=o_dim, ri_dim=ri_dim,
         inv_kw=dict(o_dim=o_dim, ri_dim=ri_dim))


def test_odd_shape():
    both((2, 3, 63, 70), seed=1, J=2, inv_kw={})
