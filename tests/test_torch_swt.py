"""The port's SWT on the CPU (plain path) == the JAX package: the forward
stacks and ``afb1d_atrous`` within the JAX suite's DWT tolerance, the
exact inverse within 2e-5 and the round trip within 2e-4, in every mode,
for db1 db2 db4 sym4 bior2.4, J = 1-3, odd sizes, pads longer than the
axis (dilated db4 on a 7x7 image), against the JAX conv path and (at the
even shape) its operator path."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pytorch_wavelets_tpu.ops import afb_sfb as jafb

from pytorch_wavelets_tpu_torch.ops import afb_sfb as pafb
from tests.torch_parity import DWT_ATOL, SWT_MODES, cmp, rand, swt_parity

torch.set_num_threads(1)

WAVES = ("db1", "db2", "db4", "sym4", "bior2.4")


@pytest.mark.parametrize("wave", WAVES)
@pytest.mark.parametrize("mode", SWT_MODES)
def test_swt_odd_size(mode, wave):
    swt_parity((1, 2, 13, 11), wave, mode, 2)


@pytest.mark.parametrize("mode", SWT_MODES)
@pytest.mark.parametrize("J,path", [(1, "conv"), (3, "conv"),
                                    (3, "matmul")])
def test_swt_levels(mode, J, path):
    swt_parity((2, 3, 16, 16), "db4", mode, J, path)


@pytest.mark.parametrize("mode", ["periodic", "symmetric", "reflect"])
def test_swt_tiny_image_long_filter(mode):
    """Dilated db4 on a 7x7 image: pads of several axis lengths."""
    swt_parity((1, 1, 7, 7), "db4", mode, 2)


@pytest.mark.parametrize("wave", WAVES)
@pytest.mark.parametrize("mode", SWT_MODES)
def test_afb1d_atrous(mode, wave):
    """Along W at dilation 1 and along H at dilation 3, a strided
    input."""
    from pytorch_wavelets_tpu.filters import wavelet
    w = wavelet(wave)
    x = rand((2, 3, 4, 9, 13), 3)[:, :, 1]
    for axis, d in ((-1, 1), (2, 3)):
        want = jafb.afb1d_atrous(jnp.asarray(x), w.dec_lo, w.dec_hi, mode,
                                 axis, d)
        got = pafb.afb1d_atrous(torch.from_numpy(x), w.dec_lo, w.dec_hi,
                                mode, axis, d)
        cmp(got, np.asarray(want), DWT_ATOL)


def test_atrous_plan_refuses_negative_pad():
    """One tap at any dilation pads by (-d, 0): refused, as JAX's pad1d
    refuses it."""
    with pytest.raises(ValueError, match="negative pad"):
        pafb.atrous_plan(8, 1, 2, "symmetric")
    with pytest.raises(ValueError, match="negative pad"):
        pafb.afb1d_atrous_corr_plain(torch.zeros(1, 1, 4, 4), np.ones(1),
                                     np.ones(1), "zero", 3, 1)
    with pytest.raises(ValueError, match="Unknown pad type"):
        pafb.atrous_plan(8, 2, 1, "per")
