"""The port's composed pyramids (plain path, CPU) == the JAX package's
fused pyramids with its operator path forced."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pytorch_wavelets_tpu.ops import banded as jbanded
from pytorch_wavelets_tpu.ops import fused_dtcwt as jfused
from pytorch_wavelets_tpu.transforms import dtcwt as jdt
from pytorch_wavelets_tpu.transforms.dtcwt_xfm import (
    dtcwt_fwd_filters, dtcwt_inv_filters,
)

from pytorch_wavelets_tpu_torch.ops import fused_dtcwt, quad
from pytorch_wavelets_tpu_torch.transforms import dtcwt as pdt

torch.set_num_threads(1)

ATOL = 1e-5
CPU = torch.device("cpu")
SHAPE = (2, 3, 64, 64)
J = 3


@pytest.fixture
def force_matmul():
    jbanded.set_operator_matmul(True)
    yield
    jbanded.set_operator_matmul(None)


def _rand(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _fwd_plan(biort, qshift, incs):
    f = dtcwt_fwd_filters(biort, qshift)
    args = (f["h0o"], f["h1o"], f["h0a"], f["h1a"], f["h0b"], f["h1b"], J,
            (False,) * J, incs, "symmetric", *SHAPE[2:])
    return jdt._fwd_pyramid_plan(*args), pdt._fwd_pyramid_plan(*args)


BANKS = [("near_sym_a", "qshift_a"), ("near_sym_b", "qshift_b")]
LAYOUTS = [(2, -1), (1, 3)]


@pytest.mark.parametrize("biort,qshift", BANKS)
@pytest.mark.parametrize("o_dim,ri_dim", LAYOUTS)
def test_analysis_pyramid(force_matmul, biort, qshift, o_dim, ri_dim):
    incs = (True, False, True)
    jplan, pplan = _fwd_plan(biort, qshift, incs)
    od, rd, _, _ = jdt.get_dimensions5(o_dim, ri_dim)
    x = _rand(SHAPE, 1)
    jl, jh = jfused.analysis_pyramid(jnp.asarray(x), jplan, od)
    pl, ph = fused_dtcwt.analysis_pyramid(
        torch.from_numpy(x), fused_dtcwt.analysis_operators(pplan, CPU),
        od, rd)
    for a, b, inc in zip(jl, pl, incs):
        assert (a is None) == (b is None) == (not inc)
        if a is not None:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL)
    for (hr, hi), b in zip(jh, ph):
        np.testing.assert_allclose(
            b.numpy(), np.asarray(jnp.stack((hr, hi), axis=rd)), atol=ATOL)


@pytest.mark.parametrize("biort,qshift", BANKS)
@pytest.mark.parametrize("o_dim,ri_dim", LAYOUTS)
@pytest.mark.parametrize("with_ll,drop", [(True, None), (False, 1)])
def test_synthesis_pyramid(force_matmul, biort, qshift, o_dim, ri_dim,
                           with_ll, drop):
    g = dtcwt_inv_filters(biort, qshift)
    od, rd, _, _ = jdt.get_dimensions5(o_dim, ri_dim)
    sizes = [(32, 32), (16, 16), (8, 8)]
    shapes = []
    for h, w in sizes:
        s = [2, 3, h, w]
        s.insert(od, 6)
        s.insert(rd, 2)
        shapes.append(s)
    highs = [None if j == drop else _rand(s, 10 + j)
             for j, s in enumerate(shapes)]
    ll = _rand((2, 3, 16, 16), 9) if with_ll else None
    args = (g["g0o"], g["g1o"], g["g0a"], g["g1a"], g["g0b"], g["g1b"],
            "symmetric", (16, 16) if with_ll else None,
            tuple(None if h is None else hw for h, hw in zip(highs, sizes)))
    levels, ll_spec, _ = jdt._inv_pyramid_plan(*args)
    want = jfused.synthesis_pyramid(
        (None if ll is None else jnp.asarray(ll), ll_spec),
        [None if h is None else tuple(jnp.moveaxis(jnp.asarray(h), rd, 0))
         for h in highs], levels, od)
    plevels, pll_spec, _ = pdt._inv_pyramid_plan(*args)
    got = fused_dtcwt.synthesis_pyramid(
        None if ll is None else torch.from_numpy(ll),
        [None if h is None else fused_dtcwt.canonical_bands(
            torch.from_numpy(h), od, rd) for h in highs],
        fused_dtcwt.synthesis_operators(plevels, pll_spec, CPU))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_k2_k3_plain_round_trip():
    """c2q_unpack_plain inverts q2c_pack_plain up to the folded 1/sqrt2
    scale (x2 per quadrant), per member, in any layout."""
    y = torch.from_numpy(_rand((2, 3, 2 * 2 * 4, 2 * 5), 4))
    h = torch.zeros(2, 3, 4, 5, 6, 2)     # o_dim=4 (5-D), ri last
    hc = fused_dtcwt.canonical_bands(h, 4, 5)
    orients = ((2, 3), (1, 4))
    quad.q2c_pack_plain(y, hc, orients)
    torch.testing.assert_close(quad.c2q_unpack_plain(hc, orients),
                               2 * y)
