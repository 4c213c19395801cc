"""The port's 2-D DWT on the CPU (plain path, through the autograd
Functions) == the JAX package, for db1 and db4: forward, inverse and the
reference-semantics gradients of both (``jax.vjp`` of the JAX custom
VJPs), in every mode, at even and odd sizes, against both JAX paths, at
the JAX suite's DWT tolerance; and the options: a 4-tuple wave with
distinct column and row pairs, a Wavelet object, None highs,
``coeff_dtype`` and J=0."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pytorch_wavelets_tpu as tw

import pytorch_wavelets_tpu_torch as tt
from tests.torch_parity import (  # noqa: F401
    DWT_ATOL, cmp, dwt_grid, dwt_parity, jax_path, rand,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("jax_path,wave,mode,shape",
                         dwt_grid(["db1", "db4"]), indirect=["jax_path"])
def test_dwt2d(jax_path, wave, mode, shape):
    dwt_parity(shape, wave, mode, 3, jax_path)


def test_four_tuple_wave_swaps_pairs(jax_path):
    """Distinct column and row pairs: the reference's pair swap (the first
    pair filters along W), forward, inverse and both gradients."""
    w1, w2 = tw.filters.wavelet("db2"), tw.filters.wavelet("bior2.2")
    dec = tuple(tuple(float(v) for v in f) for f in
                (w1.dec_lo, w1.dec_hi, w2.dec_lo, w2.dec_hi))
    dwt_parity((1, 2, 30, 30), dec, "symmetric", 2, jax_path)


def test_wavelet_object():
    x = rand((1, 3, 24, 20), 6)
    w = tt.DWTForward(J=2, wave=tt.filters.wavelet("sym3"), device="cpu")
    jf = tw.DWTForward(J=2, wave=tw.filters.wavelet("sym3"))
    cmp(w(torch.from_numpy(x)), jax.jit(jf)(jnp.asarray(x)), DWT_ATOL)
    assert w.filters == tt.DWTForward(J=2, wave="sym3",
                                      device="cpu").filters


def test_none_highs():
    """A None level is zeros: the finest, then the coarsest."""
    x = rand((2, 2, 28, 31), 7)
    jf = tw.DWTForward(J=2, wave="db3", mode="reflect")
    ji = tw.DWTInverse(wave="db3", mode="reflect")
    py = tt.DWTForward(J=2, wave="db3", mode="reflect",
                       device="cpu")(torch.from_numpy(x))
    pi = tt.DWTInverse(wave="db3", mode="reflect", device="cpu")

    @jax.jit
    def ref(x):
        yl, yh = jf(x)
        return ji((yl, [None, yh[1]])), ji((yl, [yh[0], None]))
    r0, r1 = ref(jnp.asarray(x))
    cmp(pi((py[0], [None, py[1][1]])), r0, DWT_ATOL)
    cmp(pi((py[0], [py[1][0], None])), r1, DWT_ATOL)


def test_coeff_dtype_bfloat16():
    """bf16 detail storage, upcast by the inverse: the bands equal JAX's
    rounding of the same fp32 values."""
    x = rand((1, 2, 32, 32), 8)
    py = tt.DWTForward(J=2, wave="db2", coeff_dtype="bfloat16",
                       device="cpu")(torch.from_numpy(x))
    jf = tw.DWTForward(J=2, wave="db2", coeff_dtype="bfloat16")
    ji = tw.DWTInverse(wave="db2")
    jy, jrec = jax.jit(lambda x: (jf(x), ji(jf(x))))(jnp.asarray(x))
    assert py[0].dtype == torch.float32
    assert all(h.dtype == torch.bfloat16 for h in py[1])
    cmp(py[1], [np.asarray(h, dtype=np.float32) for h in jy[1]], DWT_ATOL)
    rec = tt.DWTInverse(wave="db2", device="cpu")(py)
    assert rec.dtype == torch.float32
    cmp(rec, jrec, DWT_ATOL)


def test_j0_is_identity():
    x = torch.from_numpy(rand((1, 1, 8, 8), 9))
    yl, yh = tt.DWTForward(J=0, device="cpu")(x)
    assert yh == [] and torch.equal(yl, x)
    assert torch.equal(tt.DWTInverse(device="cpu")((yl, yh)), x)
