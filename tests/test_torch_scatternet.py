"""The port's scattering layers and magnitude kernels (CPU, plain path)
== the JAX package, outputs and input gradients through ``jax.vjp``, at
the JAX suite's ScatterNet tolerance (tests/test_scatternet.py), with the
JAX operator path forced (the counterpart) and with its conv path; the
bandpass-diagonal filters and ``set_operator_matmul(False)`` on the
per-level path of both."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pytorch_wavelets_tpu as tw
from pytorch_wavelets_tpu.ops import banded as jbanded
from pytorch_wavelets_tpu.transforms import scatternet as jscat

import pytorch_wavelets_tpu_torch as tt
from pytorch_wavelets_tpu_torch.convert import filters_from_jax
from pytorch_wavelets_tpu_torch.ops import banded as pbanded
from pytorch_wavelets_tpu_torch.ops import pool, scat_mag
from pytorch_wavelets_tpu_torch.transforms import scatternet as pscat
from tests.torch_parity import jax_path, rand  # noqa: F401

torch.set_num_threads(1)

ATOL = 2e-5
# the JAX references compiled without LLVM optimisation (as
# tests/torch_parity.py compiles them): the same arithmetic, compiled in
# a fraction of the time
_FAST = {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True}


def _close(mine, ref):
    assert tuple(mine.shape) == tuple(ref.shape)
    np.testing.assert_allclose(mine.detach().numpy(), np.asarray(ref),
                               atol=ATOL)


def _both(jmod, pmod, shape, seed=0):
    """Output and input gradient of sum(Z * G) through both packages."""
    x = rand(shape, seed)
    G = rand(jax.eval_shape(jmod, jnp.asarray(x)).shape, seed + 1)

    def f(x):
        z, vjp = jax.vjp(jmod, x)
        return z, vjp(jnp.asarray(G))[0]
    jz, jg = jax.jit(f, compiler_options=_FAST)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    pz = pmod(xt)
    (pz * torch.from_numpy(G)).sum().backward()
    _close(pz, jz)
    _close(xt.grad, jg)


CONFIGS = [
    ((2, 3, 32, 32), dict()),
    ((2, 3, 32, 32), dict(biort="near_sym_b")),
    ((2, 3, 32, 32), dict(magbias=1e-1)),
    ((2, 3, 32, 32), dict(mode="zero")),
    ((2, 3, 32, 32), dict(combine_colour=True)),
    ((1, 3, 30, 34), dict()),          # odd: the %2 pad / the %8 pad
]


@pytest.mark.parametrize("shape,kw", CONFIGS)
def test_scatlayerj2(jax_path, shape, kw):
    _both(tw.ScatLayerj2(**kw), tt.ScatLayerj2(device="cpu", **kw), shape)


@pytest.mark.parametrize("shape,kw", CONFIGS)
def test_scatlayer(shape, kw):
    jbanded.set_operator_matmul(True)
    try:
        _both(tw.ScatLayer(**kw), tt.ScatLayer(device="cpu", **kw), shape)
    finally:
        jbanded.set_operator_matmul(None)


def test_scatlayer_conv_path():
    _both(tw.ScatLayer(), tt.ScatLayer(device="cpu"), (2, 3, 32, 32))


def test_taps_loaded_from_jax():
    """The JAX modules' tap sets load into the port's modules (whose own
    taps are zeroed first) and give the JAX modules' outputs."""
    jbanded.set_operator_matmul(True)
    try:
        x = rand((1, 3, 16, 16), 3)
        for name, kw in (("ScatLayer", {}), ("ScatLayerj2", {}),
                         ("ScatLayer", BP),
                         ("ScatLayerj2", dict(qshift="qshift_b_bp", **BP))):
            j = getattr(tw, name)(**kw)
            mine = getattr(tt, name)(device="cpu", **kw)
            for buf in mine.buffers():
                buf.zero_()
            mine.load_state_dict(filters_from_jax(j._filters))
            _close(mine(torch.from_numpy(x)),
                   jax.jit(j, compiler_options=_FAST)(jnp.asarray(x)))
    finally:
        jbanded.set_operator_matmul(None)


BP = dict(biort="near_sym_b_bp")
BP_CONFIGS = [
    ((2, 3, 32, 32), dict()),
    ((2, 3, 32, 32), dict(combine_colour=True)),
    ((1, 2, 30, 34), dict(mode="zero", magbias=1e-1)),   # odd: the pads
]


@pytest.mark.parametrize("shape,kw", BP_CONFIGS)
def test_scatlayerj2_bandpass_diag(shape, kw):
    """near_sym_b_bp / qshift_b_bp: the per-level rotated-filter path of
    both packages, outputs and gradients."""
    _both(tw.ScatLayerj2(qshift="qshift_b_bp", **BP, **kw),
          tt.ScatLayerj2(qshift="qshift_b_bp", device="cpu", **BP, **kw),
          shape)


@pytest.mark.parametrize("shape,kw", BP_CONFIGS)
def test_scatlayer_bandpass_diag(shape, kw):
    _both(tw.ScatLayer(**BP, **kw), tt.ScatLayer(device="cpu", **BP, **kw),
          shape)


@pytest.mark.parametrize("kw", [dict(), dict(combine_colour=True)])
def test_scatlayerj2_per_level(kw):
    """set_operator_matmul(False) in both packages: the per-level path
    with near_sym_a / qshift_a (K8/K9, K2 and the pool K11's plain
    versions; JAX's conv path)."""
    jbanded.set_operator_matmul(False)
    pbanded.set_operator_matmul(False)
    try:
        _both(tw.ScatLayerj2(**kw), tt.ScatLayerj2(device="cpu", **kw),
              (1, 3, 40, 32))
    finally:
        jbanded.set_operator_matmul(None)
        pbanded.set_operator_matmul(None)


def test_avg_pool2_plain_matches_jax():
    """K11's plain versions == JAX avg_pool2 and its jax.vjp."""
    x = rand((2, 3, 6, 10), 6)
    g = rand((2, 3, 3, 5), 7)
    y, vjp = jax.vjp(jscat.avg_pool2, jnp.asarray(x))
    _close(pool.avg_pool2_fwd_plain(torch.from_numpy(x)), y)
    _close(pool.avg_pool2_bwd_plain(torch.from_numpy(g)),
           vjp(jnp.asarray(g))[0])


def test_not_ported_yet():
    with pytest.raises(ValueError, match="qshift_b_bp"):
        tt.ScatLayerj2(biort="near_sym_b_bp", device="cpu")
    with pytest.raises(NotImplementedError, match="A3 batch_chunk"):
        tt.ScatLayerj2(batch_chunk=8, device="cpu")
    with pytest.raises(NotImplementedError):
        tt.ScatLayer(mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="3 input channels"):
        tt.ScatLayerj2(combine_colour=True, device="cpu")(torch.zeros(
            1, 2, 16, 16))


@pytest.mark.parametrize("bias", [1e-1, 1e-2, 1e-3])
@pytest.mark.parametrize("combine", [False, True])
def test_mag_plain_matches_jax(bias, combine):
    """K4/K5's plain versions == JAX smooth_mag / _combined_mag and their
    jax.vjp, on bands laid out as the scattering pyramids write them."""
    h = rand((2, 6, 3, 5, 7, 2), 4)
    h[0, 0, 0, 0, :3] = 0          # zero coefficients, where b matters
    g = rand((2, 6, 1 if combine else 3, 5, 7), 5)
    fn = jscat._combined_mag if combine else jscat.smooth_mag
    r, vjp = jax.vjp(lambda re, im: fn(re, im, bias),
                     jnp.asarray(h[..., 0]), jnp.asarray(h[..., 1]))
    dre, dim = vjp(jnp.asarray(g))
    ht = torch.from_numpy(h)
    _close(scat_mag.scat_mag_fwd_plain(ht, bias, combine), r)
    dh = scat_mag.scat_mag_bwd_plain(ht, torch.from_numpy(g), bias,
                                     combine)
    _close(dh[..., 0], dre)
    _close(dh[..., 1], dim)


def test_mag_function_at_zero_bias():
    """At magbias 0 a zero coefficient has magnitude 0 and a NaN gradient,
    as JAX's autodiff gives; the Function runs the plain versions here."""
    h = torch.zeros(1, 6, 1, 2, 2, 2, requires_grad=True)
    r = pscat.smooth_mag(h, 0.0)
    assert float(r.detach().abs().max()) == 0.0
    r.sum().backward()
    assert bool(torch.isnan(h.grad).all())
    _, vjp = jax.vjp(lambda re, im: jscat.smooth_mag(re, im, 0.0),
                     jnp.zeros((1, 6, 1, 2, 2)), jnp.zeros((1, 6, 1, 2, 2)))
    assert bool(jnp.isnan(vjp(jnp.ones((1, 6, 1, 2, 2)))[0]).all())
