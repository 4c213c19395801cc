"""The port's filter tables and tap preparation == the JAX package's, bit
for bit."""
import numpy as np
import pytest
import torch

import pytorch_wavelets_tpu as tw
from pytorch_wavelets_tpu.filters import dtcwt_coeffs as jcoeffs
from pytorch_wavelets_tpu.ops.dtcwt_fb import prep_taps as jprep_taps
from pytorch_wavelets_tpu.transforms import dtcwt_xfm as jxfm

import pytorch_wavelets_tpu_torch as tt
from pytorch_wavelets_tpu_torch.convert import filters_from_jax
from pytorch_wavelets_tpu_torch.filters import dtcwt_coeffs as pcoeffs
from pytorch_wavelets_tpu_torch.ops.dtcwt_fb import prep_taps
from pytorch_wavelets_tpu_torch.transforms import dtcwt_xfm as pxfm

torch.set_num_threads(1)

BIORTS = ["antonini", "legall", "near_sym_a", "near_sym_b", "near_sym_b_bp"]
QSHIFTS = ["qshift_06", "qshift_a", "qshift_b", "qshift_c", "qshift_d",
           "qshift_b_bp"]


def _bit_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_coefficient_bank_bit_equal():
    jb, pb = jcoeffs._bank(), pcoeffs._bank()
    assert sorted(jb) == sorted(pb)
    for k in jb:
        _bit_equal(jb[k], pb[k])


@pytest.mark.parametrize("name", BIORTS)
def test_biort_bit_equal(name):
    for a, b in zip(jcoeffs.biort(name), pcoeffs.biort(name), strict=True):
        _bit_equal(a, b)
        _bit_equal(jprep_taps(a), prep_taps(b))


@pytest.mark.parametrize("name", QSHIFTS)
def test_qshift_bit_equal(name):
    for a, b in zip(jcoeffs.qshift(name), pcoeffs.qshift(name), strict=True):
        _bit_equal(a, b)
        _bit_equal(jprep_taps(a), prep_taps(b))


def test_prep_taps_takes_tensors():
    h = np.random.RandomState(0).randn(7, 1)
    _bit_equal(prep_taps(torch.from_numpy(h)), jprep_taps(h))
    _bit_equal(prep_taps(h), h.ravel()[::-1])


def test_unknown_bank_raises():
    with pytest.raises(ValueError, match="Available banks"):
        pcoeffs.biort("nope")


@pytest.mark.parametrize("biort,qshift", [("near_sym_a", "qshift_a"),
                                          ("near_sym_b", "qshift_b"),
                                          ("antonini", "qshift_06"),
                                          ("legall", "qshift_c")])
def test_tap_dicts_equal(biort, qshift):
    assert pxfm.dtcwt_fwd_filters(biort, qshift) == \
        jxfm.dtcwt_fwd_filters(biort, qshift)
    assert pxfm.dtcwt_inv_filters(biort, qshift) == \
        jxfm.dtcwt_inv_filters(biort, qshift)


def test_filters_from_jax_are_the_module_buffers():
    jf = jxfm.dtcwt_fwd_filters("near_sym_b", "qshift_b")
    ji = jxfm.dtcwt_inv_filters("near_sym_b", "qshift_b")
    f = tt.DTCWTForward(biort="near_sym_b", qshift="qshift_b", device="cpu")
    i = tt.DTCWTInverse(biort="near_sym_b", qshift="qshift_b", device="cpu")
    for mod, d in ((f, jf), (i, ji)):
        sd = mod.state_dict()
        conv = filters_from_jax(d)
        assert sorted(sd) == sorted(conv)
        for k in conv:
            _bit_equal(sd[k].numpy(), conv[k].numpy())
    with pytest.raises(ValueError):
        filters_from_jax({"h0o": (1.0,)})
    assert tw.DTCWTForward(biort="near_sym_b").biort == f.biort
