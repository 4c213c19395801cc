"""The port's matmul precision dial and its native bf16 pipelines on the
CPU, against the JAX package (mirrors tests/test_precision.py):

- the level API and its errors, in both packages alike;
- the modules exact across levels on the CPU (the plain versions are IEEE
  fp32 at every level, as JAX's CPU backend is), within the JAX suite's
  tolerances of the JAX package at each level;
- ``coeff_dtype`` storage and natively bf16 pipelines (DTCWT, DWT, SWT
  with ``upcast=False``, ScatLayerj2) against the JAX package's bf16
  output, compared in bf16;
- K17's plain versions (TF32, 3xTF32, bf16: ops/banded.py) against an
  fp32 einsum within each mode's rounding bound.

On the card the levels select K17's modes (tests/test_torch_cuda.py)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

import pytorch_wavelets_tpu as tw
from pytorch_wavelets_tpu.ops import precision as jprecision
import pytorch_wavelets_tpu_torch as tt
from pytorch_wavelets_tpu_torch.ops import banded, precision
from tests.torch_parity import FAST, force_jax_matmul, rand  # noqa: F401

torch.set_num_threads(1)

LEVELS = ("highest", "high", "default")
FWD_ATOL, INV_ATOL = 1e-5, 2e-5        # the JAX suite's DTCWT tolerances
# bf16 against the JAX package's bf16, in bf16: the ops round at the same
# places, the pairs of roundings that differ (PyTorch's and XLA's CPU
# kernels) leave the outputs within two bf16 steps (2 * 2^-7) of the
# larger of 1 and max |JAX|
BF16_TOL = 2 * 2.0 ** -7


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, dtype=jnp.float32))


def _close(mine, ref, atol):
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=atol)


def _close_bf16(mine, ref):
    """Both in bf16, within BF16_TOL of max(1, max |ref|)."""
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16
        scale = max(1.0, float(np.abs(_np(b)).max()))
        assert np.abs(_np(a) - _np(b)).max() <= BF16_TOL * scale


# ---------------------------------------------------------------------------
# the level API
# ---------------------------------------------------------------------------

def test_default_is_highest():
    assert tt.get_matmul_precision() == "highest"
    assert jprecision.get_matmul_precision() == lax.Precision.HIGHEST


def test_set_and_reset():
    tt.set_matmul_precision("high")
    try:
        assert tt.get_matmul_precision() == "high"
        assert banded.kernel_mode(torch.float32) == "3xtf32"
    finally:
        tt.set_matmul_precision("highest")
    assert tt.get_matmul_precision() == "highest"
    assert banded.kernel_mode(torch.float32) == "fp32"


def test_context_manager_restores():
    with tt.matmul_precision("default"):
        assert tt.get_matmul_precision() == "default"
        assert banded.kernel_mode(torch.float32) == "tf32"
        with tt.matmul_precision("high"):
            assert tt.get_matmul_precision() == "high"
        assert tt.get_matmul_precision() == "default"
    assert tt.get_matmul_precision() == "highest"


def test_unknown_level_rejected():
    for mod in (tt, tw):
        with pytest.raises(ValueError):
            mod.set_matmul_precision("bf16x9")
    assert tt.get_matmul_precision() == "highest"


def test_bf16_mode_at_every_level():
    """bf16 data takes K17's bf16 mode whatever the level; other dtypes
    take K1's fp32 entry, whose checks refuse them on the card; the plain
    versions keep TF32 off at every level."""
    for level in LEVELS:
        with tt.matmul_precision(level):
            assert banded.kernel_mode(torch.bfloat16) == "bf16"
            assert banded.kernel_mode(torch.float64) == "fp32"
            with precision.plain_flags():
                assert not torch.backends.cuda.matmul.allow_tf32
                assert not torch.backends.cudnn.allow_tf32


def test_backward_runs_at_the_forward_level(monkeypatch):
    """The autograd Functions that apply operators (the composed DTCWT
    pyramids, the SWT merges) run their backward's products at their
    forward's level, whatever the level when backward is called, as JAX's
    transposes run at the precision of the traced forward."""
    from pytorch_wavelets_tpu_torch.ops import fused_dtcwt
    from pytorch_wavelets_tpu_torch.transforms import dwt as tdwt
    seen = []

    def spy(orig):
        def fn(*args, **kwargs):
            seen.append(tt.get_matmul_precision())
            return orig(*args, **kwargs)
        return fn
    for module in (fused_dtcwt, tdwt):
        for name in ("apply_col", "apply_row"):
            monkeypatch.setattr(module, name, spy(getattr(module, name)))
    x = torch.from_numpy(rand((1, 2, 16, 16), 3)).requires_grad_()
    f, i = tt.DTCWTForward(J=2, device="cpu"), tt.DTCWTInverse(device="cpu")
    sf, si = tt.SWTForward(J=1, device="cpu"), tt.SWTInverse(device="cpu")
    with tt.matmul_precision("default"):
        loss = i(f(x)).sum() + si(sf(x)).sum()
    n_fwd = len(seen)
    assert n_fwd and set(seen) == {"default"}
    loss.backward()                     # called at 'highest'
    assert len(seen) > n_fwd and set(seen[n_fwd:]) == {"default"}
    assert tt.get_matmul_precision() == "highest"


# ---------------------------------------------------------------------------
# the modules across levels (CPU: exact at every level)
# ---------------------------------------------------------------------------

def _jit(fn, *args):
    """``fn`` as one XLA program (eager JAX compiles every primitive)."""
    return jax.jit(fn, compiler_options=FAST)(*args)


def _jax_under(level, fn, *args):
    """``fn`` jitted with the JAX package's level set at trace time."""
    with tw.matmul_precision(level):
        return _jit(fn, *args)


@pytest.fixture(scope="module")
def level_case():
    """One input, and the port's DTCWT / ScatLayerj2 / SWT / DWT outputs
    at 'highest' (the reference every level must reproduce)."""
    x = rand((1, 3, 32, 32), 0)
    return x, _port_outputs(x, "highest")


def _port_outputs(x, level):
    xt = torch.from_numpy(x)
    with tt.matmul_precision(level), torch.no_grad():
        yl, yh = tt.DTCWTForward(J=2, device="cpu")(xt)
        out = [yl, *yh, tt.DTCWTInverse(device="cpu")((yl, yh)),
               tt.ScatLayerj2(device="cpu")(xt)]
        cs = tt.SWTForward(J=2, wave="db2", device="cpu")(xt)
        out += [*cs, tt.SWTInverse(wave="db2", device="cpu")(cs)]
        dl, dh = tt.DWTForward(J=2, wave="db2", device="cpu")(xt)
        out += [dl, *dh, tt.DWTInverse(wave="db2", device="cpu")((dl, dh))]
    return out


def _jax_outputs(x, level):
    def fn(v):
        yl, yh = tw.DTCWTForward(J=2)(v)
        out = [yl, *yh, tw.DTCWTInverse()((yl, yh)), tw.ScatLayerj2()(v)]
        cs = tw.SWTForward(J=2, wave="db2")(v)
        out += [*cs, tw.SWTInverse(wave="db2")(cs)]
        dl, dh = tw.DWTForward(J=2, wave="db2")(v)
        return out + [dl, *dh, tw.DWTInverse(wave="db2")((dl, dh))]
    return _jax_under(level, fn, jnp.asarray(x))


@pytest.mark.parametrize("level", LEVELS)
def test_modules_exact_across_levels(level_case, level):
    """Every level gives the 'highest' outputs on the CPU (the plain
    versions have no TF32), and the JAX package's at that level within
    the JAX suite's DTCWT tolerances."""
    x, ref = level_case
    mine = _port_outputs(x, level)
    _close(mine, ref, 1e-6)
    _close(mine, _jax_outputs(x, level), INV_ATOL)


# ---------------------------------------------------------------------------
# coeff_dtype storage and native bf16 pipelines
# ---------------------------------------------------------------------------

def test_coeff_dtype_bf16_storage():
    """DTCWTForward(coeff_dtype='bfloat16') narrows only the bands; the
    inverse upcasts and returns fp32, as the JAX package's."""
    x = rand((2, 3, 64, 64), 0)
    f = tt.DTCWTForward(J=3, coeff_dtype="bfloat16", device="cpu")
    yl, yh = f(torch.from_numpy(x))
    assert yl.dtype == torch.float32
    assert all(h.dtype == torch.bfloat16 for h in yh)
    r = tt.DTCWTInverse(device="cpu")((yl, yh))
    assert r.dtype == torch.float32
    jyh, jr = _jit(lambda v: (lambda c: (c[1], tw.DTCWTInverse()(c)))(
        tw.DTCWTForward(J=3, coeff_dtype="bfloat16")(v)), jnp.asarray(x))
    _close_bf16(yh, jyh)
    # the inverse of bands that round apart (one bf16 step) where the fp32
    # forwards straddle a rounding midpoint
    scale = max(1.0, float(np.abs(_np(jr)).max()))
    assert np.abs(r.numpy() - _np(jr)).max() <= BF16_TOL * scale
    assert float(np.abs(r.numpy() - x).max() / np.abs(x).max()) < 5e-3


@pytest.mark.parametrize("one_d", [False, True])
def test_dwt_coeff_dtype_bf16_storage(one_d):
    x = rand((2, 2, 32, 32), 5)
    if one_d:
        x = x[:, :, 0]
    fcls, icls = (("DWT1DForward", "DWT1DInverse") if one_d
                  else ("DWTForward", "DWTInverse"))
    yl, yh = getattr(tt, fcls)(J=2, wave="db2", coeff_dtype="bfloat16",
                               device="cpu")(torch.from_numpy(x))
    assert yl.dtype == torch.float32
    assert all(h.dtype == torch.bfloat16 for h in yh)
    r = getattr(tt, icls)(wave="db2", device="cpu")((yl, yh))
    assert r.dtype == torch.float32
    _, jyh = _jit(getattr(tw, fcls)(J=2, wave="db2",
                                    coeff_dtype="bfloat16"), jnp.asarray(x))
    _close_bf16(yh, jyh)
    assert float(np.abs(r.numpy() - x).max() / np.abs(x).max()) < 2e-2


def test_swt_coeff_dtype_bf16_storage():
    x = rand((2, 2, 32, 32), 1)
    cs = tt.SWTForward(J=2, wave="db2", coeff_dtype="bfloat16",
                       device="cpu")(torch.from_numpy(x))
    assert all(c.dtype == torch.bfloat16 for c in cs)
    _close_bf16(cs, _jit(tw.SWTForward(J=2, wave="db2",
                                       coeff_dtype="bfloat16"),
                         jnp.asarray(x)))
    r = tt.SWTInverse(wave="db2", device="cpu")(cs)
    assert r.dtype == torch.float32
    assert float(np.abs(r.numpy() - x).max() / np.abs(x).max()) < 2e-2


def test_native_bf16_dtcwt_and_scattering(force_jax_matmul):  # noqa: F811
    """bf16 in, bf16 out through the DTCWT round trip and ScatLayerj2, as
    the JAX package's operator path (the path the port carries) gives."""
    x = rand((1, 3, 32, 32), 2)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    yl, yh = tt.DTCWTForward(J=2, device="cpu")(xt)
    r = tt.DTCWTInverse(device="cpu")((yl, yh))
    assert yl.dtype == r.dtype == torch.bfloat16
    def jfn(v):
        c = tw.DTCWTForward(J=2)(v)
        return [c[0], *c[1], tw.DTCWTInverse()(c), tw.ScatLayerj2()(v)]
    _close_bf16([yl, *yh, r, tt.ScatLayerj2(device="cpu")(xt)],
                _jit(jfn, xj))
    # the round trip in bf16 stays within the JAX suite's 2e-2 of max |x|
    assert float((r.float() - xt.float()).abs().max()) < 2e-2 * np.abs(
        x).max()


def test_native_bf16_dwt_and_swt():
    """A natively bf16 DWT pipeline keeps its dtype through the inverse;
    SWTInverse(upcast=False) keeps bf16 and the default upcasts."""
    x = rand((1, 2, 32, 32), 4)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    yl, yh = tt.DWTForward(J=2, wave="db2", device="cpu")(xt)
    r = tt.DWTInverse(wave="db2", device="cpu")((yl, yh))
    assert r.dtype == torch.bfloat16
    def jfn(v):
        c = tw.DWTForward(J=2, wave="db2")(v)
        s = tw.SWTForward(J=1, wave="db2")(v[:, :1, :16, :16])
        return ([c[0], *c[1], tw.DWTInverse(wave="db2")(c)],
                [*s, tw.SWTInverse(wave="db2", upcast=False)(s)])
    jd, js = _jit(jfn, xj)
    _close_bf16([yl, *yh, r], jd)
    cs = tt.SWTForward(J=1, wave="db2", device="cpu")(xt[:, :1, :16, :16])
    assert all(c.dtype == torch.bfloat16 for c in cs)
    r = tt.SWTInverse(wave="db2", upcast=False, device="cpu")(cs)
    assert r.dtype == torch.bfloat16
    _close_bf16([*cs, r], js)
    assert tt.SWTInverse(wave="db2", device="cpu")(cs).dtype == \
        torch.float32


# ---------------------------------------------------------------------------
# K17's plain versions
# ---------------------------------------------------------------------------

def _tf32_ref(a):
    """Round fp32 to 10 mantissa bits, to nearest, ties away from zero
    (cvt.rna.tf32.f32), on the integer bits in numpy."""
    b = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    b = ((b & 0x7FFFFFFF) + 0x1000) & 0x7FFFE000 | (b & 0x80000000)
    return b.astype(np.uint32).view(np.float32)


def test_tf32_rounding():
    v = rand((4096,), 7) * np.float32(10.0) ** rand((4096,), 8)
    ties = np.array([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11,
                     1 - 2 ** -12], np.float32)
    v = np.concatenate([v, ties])
    got = banded._tf32(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, _tf32_ref(v))
    assert got[-4] == 1 + 2 ** -10 and got[-3] == -(1 + 2 ** -10)
    assert (got.view(np.uint32) & 0x1FFF == 0).all()


@pytest.mark.parametrize("entry", ["col", "row"])
def test_k17_plain_versions(entry):
    """Against the fp32 einsum, relative to the sum of the products'
    magnitudes: TF32 rounds each operand by at most 2^-11, so a product
    by at most ~2^-10; 3xTF32 keeps ~22 bits of each (error ~2^-21); bf16
    rounds the operator by 2^-9 and the output once (inputs are bf16
    already).  With ``out``: accumulation and writes as the fp32 entry."""
    M, K = 40, 56
    T = rand((M, K), 9) / np.float32(np.sqrt(K))
    T[np.abs(np.subtract.outer(np.arange(M), np.arange(K))) > 12] = 0
    op = banded.Operator(T, "cpu")
    x = torch.from_numpy(rand((2, 3, K, K), 10))
    exact = getattr(banded, f"apply_{entry}_plain")(x, op)
    Ta, xa = torch.from_numpy(np.abs(T)), x.abs()
    eq = banded._EQ[entry]
    mag = torch.einsum(eq, Ta, xa)
    bounds = {"tf32": 2.0 ** -9, "3xtf32": 2.0 ** -20, "bf16": 2.0 ** -7}
    for mode, bound in bounds.items():
        plain = getattr(banded, f"apply_{entry}_{mode}_plain")
        xin = x.to(torch.bfloat16) if mode == "bf16" else x
        ref = getattr(banded, f"apply_{entry}_plain")(xin.float(), op)
        y = plain(xin, op)
        assert y.dtype == xin.dtype
        err = (y.float() - ref).abs()
        assert bool((err <= bound * mag + 1e-7).all()), mode
        # on the CPU the wrappers take these plain versions
        wrapper = getattr(banded, f"apply_{entry}_{mode}")
        assert torch.equal(wrapper(xin, op), y)
        # accumulation: out + the fp32 sum, rounded once (bf16: within one
        # bf16 step of out + the rounded product)
        out = torch.ones_like(y)
        acc = wrapper(xin, op, out.clone())
        want = out.float() + y.float()
        assert acc.dtype == y.dtype
        assert bool(((acc.float() - want).abs() <= (
            2.0 ** -7 if mode == "bf16" else 0.0) * (
                out.float().abs() + y.float().abs())).all())
        buf = torch.zeros_like(y)
        assert wrapper(xin, op, buf, accumulate=False) is buf
        assert torch.equal(buf, y)
    assert not torch.equal(
        getattr(banded, f"apply_{entry}_tf32_plain")(x, op), exact)
