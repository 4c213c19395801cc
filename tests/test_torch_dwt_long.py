"""The port's DWT on the CPU == the JAX package for db38 (76 taps, longer
than every level's axis: 'periodization' takes the reference's single
fold), and the 1-D modules, forward, inverse and both gradients, in
every mode, against both JAX paths, at the JAX suite's DWT tolerance."""
import pytest
import torch

from tests.torch_parity import (  # noqa: F401
    DWT_MODES, dwt_grid, dwt_parity, jax_path,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("jax_path,wave,mode,shape",
                         dwt_grid(["db38"]), indirect=["jax_path"])
def test_dwt2d_db38(jax_path, wave, mode, shape):
    dwt_parity(shape, wave, mode, 3, jax_path)


# the 1-D modules run the 2-D path's ops: every mode on the conv path, and
# the operator path on a few, for its time
@pytest.mark.parametrize("jax_path,mode", [
    *(("conv", m) for m in DWT_MODES),
    *(("matmul", m) for m in ("zero", "symmetric", "periodization"))],
    indirect=["jax_path"])
def test_dwt1d(jax_path, mode):
    dwt_parity((2, 3, 37), "db4", mode, 3, jax_path, one_d=True)


@pytest.mark.parametrize("jax_path,mode", [
    ("conv", "periodization"), ("conv", "symmetric"),
    ("matmul", "periodization")], indirect=["jax_path"])
def test_dwt1d_db38(jax_path, mode):
    dwt_parity((1, 2, 20), "db38", mode, 2, jax_path, one_d=True)
