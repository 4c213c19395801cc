"""The ``batch_chunk`` dial of the port's DTCWT and scattering modules on
the CPU: chunked == unchunked, == the JAX package's chunked output (at
the JAX suite's tolerances), its warnings' texts, the ``batch_chunked``
export, and gradients (first and second order) through a chunked
layer."""
import warnings

import pytest
import torch

import jax
import jax.numpy as jnp

import pytorch_wavelets_tpu as tw

import pytorch_wavelets_tpu_torch as tt
from pytorch_wavelets_tpu_torch.models import _base
from tests.torch_parity import (  # noqa: F401 (an autouse fixture)
    FAST, INV_ATOL, cmp, force_jax_matmul, rand,
)

torch.set_num_threads(1)


def _same(a, b):
    """Same structure, values within 1e-6."""
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _same(u, v)
        return
    assert (a is None) == (b is None)
    if a is not None:
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["DTCWTForward", "DTCWTInverse",
                                  "ScatLayer", "ScatLayerj2"])
def test_chunked_matches_unchunked_and_jax(name):
    x = rand((4, 3, 16, 16), 1)
    kw = dict(J=2) if name == "DTCWTForward" else {}
    arg, jarg = torch.from_numpy(x), jnp.asarray(x)
    if name == "DTCWTInverse":
        arg = tt.DTCWTForward(J=2, device="cpu")(arg)
        jarg = tw.DTCWTForward(J=2)(jarg)
    cls = getattr(tt, name)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = cls(batch_chunk=2, device="cpu", **kw)(arg)
    _same(got, cls(device="cpu", **kw)(arg))
    jcls = getattr(tw, name)
    ref = jax.jit(lambda a: jcls(batch_chunk=2, **kw)(a),
                  compiler_options=FAST)(jarg)
    cmp(got, ref, INV_ATOL)


def test_chunked_skipped_levels_and_scales():
    """None coefficients (skipped levels) stay None; include_scale lists
    are concatenated leaf by leaf."""
    x = torch.from_numpy(rand((4, 2, 16, 16), 2))
    kw = dict(J=3, skip_hps=[False, True, False],
              include_scale=[True, False, True])
    _same(tt.DTCWTForward(batch_chunk=2, device="cpu", **kw)(x),
          tt.DTCWTForward(device="cpu", **kw)(x))


def test_warnings():
    x = torch.from_numpy(rand((4, 3, 16, 16), 3))
    with pytest.warns(UserWarning, match=r"batch_chunk=3 ignored: leading "
                      r"axis 4 does not divide into whole chunks"):
        y = tt.ScatLayerj2(batch_chunk=3, device="cpu")(x)
    _same(y, tt.ScatLayerj2(device="cpu")(x))
    with pytest.warns(UserWarning, match=r"DTCWTForward: batch_chunk ignored "
                      r"\(o_dim/ri_dim layout is not batch-leading\); "
                      r"running unchunked\."):
        tt.DTCWTForward(J=1, o_dim=0, ri_dim=1, batch_chunk=2,
                        device="cpu")(x)
    coeffs = tt.DTCWTForward(J=1, o_dim=0, ri_dim=1, device="cpu")(x)
    with pytest.warns(UserWarning, match=r"DTCWTInverse: batch_chunk "
                      r"ignored"):
        tt.DTCWTInverse(o_dim=0, ri_dim=1, batch_chunk=2,
                        device="cpu")(coeffs)
    with warnings.catch_warnings():     # a batch within one chunk: silent
        warnings.simplefilter("error")
        tt.ScatLayer(batch_chunk=8, device="cpu")(x)


def test_batch_chunked_export_and_errors():
    assert tt.batch_chunked is _base.batch_chunked
    assert "batch_chunked" in tt.__all__
    x = torch.arange(12.0).reshape(6, 2)
    out = tt.batch_chunked(lambda a: (a[0] * 2, [a[1], None]), (x, x), 2)
    _same(out, (x * 2, [x, None]))
    for bad in (-1, 2.5):
        with pytest.raises(ValueError, match="positive int"):
            tt.batch_chunked(lambda a: a, x, bad)
    assert _base.resolve_chunk(None, 64, 256 * 256, 10 ** 8) == 0
    assert _base.resolve_scat_chunk(None, 128, 3 * 256 * 256) == 0
    assert _base.resolve_chunk(4, 0, 0, 0) == 4


def test_gradients_through_a_chunked_layer():
    """x.grad and a Hessian-vector product through ScatLayerj2 with
    batch_chunk=2 == the unchunked layer's."""
    x = torch.from_numpy(rand((4, 3, 16, 16), 4))
    v = torch.from_numpy(rand((4, 3, 16, 16), 5))

    def grads(chunk):
        xt = x.clone().requires_grad_()
        out = tt.ScatLayerj2(batch_chunk=chunk, device="cpu")(xt)
        g, = torch.autograd.grad((out ** 2).sum(), xt, create_graph=True)
        hv, = torch.autograd.grad((g * v).sum(), xt)
        return g.detach(), hv

    for a, b in zip(grads(2), grads(None)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
