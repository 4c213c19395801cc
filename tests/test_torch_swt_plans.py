"""The index maps of kernels K12 (``csrc/swt_atrous.cu``: the à trous split
and its transpose) and K13 (``csrc/iswt_spec.cu``: the spectral merge and
its adjoint), emulated in numpy exactly as the CUDA sources compute each
output, against their plain versions on the CPU, at every mode, short and
long (dilated) filters, pads several times the axis length; the ISWT's
host operators and its half-spectrum FFT merge against the JAX package's;
and the SWT modules' API: shapes, ``coeff_dtype``, ``upcast``, the
analysis filters of a 4-tuple wave, ``mesh``, and ``convert``."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pytorch_wavelets_tpu as tw
from pytorch_wavelets_tpu.ops import afb_sfb as jafb
from pytorch_wavelets_tpu.transforms import dwt as jdwt

import pytorch_wavelets_tpu_torch as tt
from pytorch_wavelets_tpu_torch import convert
from pytorch_wavelets_tpu_torch.ops import afb_sfb, iswt_merge
from pytorch_wavelets_tpu_torch.ops.pad import pad_index
from pytorch_wavelets_tpu_torch.transforms import dwt as pdwt
from tests.torch_parity import DWT_ATOL, SWT_MODES, cmp, rand, swt_parity

torch.set_num_threads(1)

# (taps, dilation): Haar, db4 at the SWT's first three levels, a 12-tap
# filter at 3, and 40 taps (db20's length) at 4, whose pads exceed every
# axis below
TAPS_D = [(2, 1), (8, 1), (8, 2), (8, 4), (12, 3), (40, 4)]
SIZES = (1, 2, 5, 9, 16)


def _src(i, n, mode):
    """pad_src (csrc/dwt_index.cuh) at one position: ops/pad.py's
    pad_index, its host twin, for a padded position relative to x[0]."""
    front = max(0, -i)
    return int(pad_index(n, front, max(0, i - n + 1), mode)[i + front])


def emulate_swt_afb(x, h0, h1, mode, d):
    """K12 swt_afb along one line: the fast window inside the axis, the
    padded index outside it."""
    n, L = len(x), len(h0)
    front, _, _, m_out = afb_sfb.atrous_plan(n, L, d, mode)
    lo, hi = np.zeros(m_out), np.zeros(m_out)
    for m in range(m_out):
        q0 = m - front
        for k in range(L):
            if q0 >= 0 and q0 + (L - 1) * d < n:
                v = x[q0 + k * d]
            else:
                r = _src(q0 + k * d, n, mode)
                v = 0.0 if r < 0 else x[r]
            lo[m] += h0[k] * v
            hi[m] += h1[k] * v
    return lo, hi


def emulate_swt_afb_adjoint(glo, ghi, h0, h1, mode, d, n):
    """K12 swt_afb_adjoint along one line: the direct window of each input
    sample, then, within ``edge`` of an axis end, every pad position whose
    source it is."""
    L = len(h0)
    front, _, _, m = afb_sfb.atrous_plan(n, L, d, mode)
    qmax = m - 1 - front + (L - 1) * d
    right = qmax - n + 1 if qmax >= n else 0
    edge = max(front, right) + 1

    def window(q, acc):
        for k in range(L):
            u = q + front - k * d
            if 0 <= u < m:
                acc += h0[k] * glo[u] + h1[k] * ghi[u]
        return acc

    dx = np.zeros(n)
    for t in range(n):
        acc = window(t, 0.0)
        if mode != "zero" and (t < edge or t >= n - edge):
            for q in list(range(-front, 0)) + list(range(n, qmax + 1)):
                if _src(q, n, mode) == t:
                    acc = window(q, acc)
        dx[t] = acc
    return dx


@pytest.mark.parametrize("L,d", TAPS_D)
@pytest.mark.parametrize("mode", SWT_MODES)
def test_k12_index_plans(mode, L, d):
    gen = np.random.RandomState(L * 10 + d)
    h0, h1 = gen.randn(2, L)
    for n in SIZES:
        x = gen.randn(n)
        y = afb_sfb.afb1d_atrous_corr_plain(
            torch.from_numpy(x).reshape(1, 1, 1, n), h0, h1, mode, 3, d)
        lo, hi = emulate_swt_afb(x, h0, h1, mode, d)
        np.testing.assert_allclose(y[0, 0, 0, 0].numpy(), lo, atol=1e-12)
        np.testing.assert_allclose(y[0, 0, 1, 0].numpy(), hi, atol=1e-12)
        g = gen.randn(2, len(lo))
        dx = afb_sfb.afb1d_atrous_adjoint_plain(
            torch.from_numpy(g).reshape(1, 1, 2, 1, -1), h0, h1, mode, 3, d,
            n)
        np.testing.assert_allclose(
            dx.reshape(-1).numpy(),
            emulate_swt_afb_adjoint(g[0], g[1], h0, h1, mode, d, n),
            atol=1e-12)


def emulate_spec(A, B, g0, g1, axis, split):
    """K13 per element: the filters indexed by the frequency along
    ``axis``, the complex products written out as the kernel's fmas."""
    out0, out1 = np.zeros_like(A), np.zeros_like(A)
    N, C, H, W = A.shape
    for idx in np.ndindex(N, C, H, W):
        f = idx[3] if axis == 3 else idx[2]
        a, b = g0[f], g1[f]
        z = A[idx]
        if split:
            out0[idx] = complex(a.real * z.real + a.imag * z.imag,
                                a.real * z.imag - a.imag * z.real)
            out1[idx] = complex(b.real * z.real + b.imag * z.imag,
                                b.real * z.imag - b.imag * z.real)
        else:
            w = B[idx]
            out0[idx] = complex(
                a.real * z.real - a.imag * z.imag + b.real * w.real
                - b.imag * w.imag,
                a.real * z.imag + a.imag * z.real + b.real * w.imag
                + b.imag * w.real)
    return out0, out1


@pytest.mark.parametrize("axis", [2, 3])
@pytest.mark.parametrize("n", [7, 8])
def test_k13_index_plans(axis, n):
    gen = np.random.RandomState(n + axis)
    shape = [2, 3, 5, 4]
    shape[axis] = n // 2 + 1
    A, B = (gen.randn(*shape) + 1j * gen.randn(*shape) for _ in range(2))
    g0, g1 = (gen.randn(shape[axis]) + 1j * gen.randn(shape[axis])
              for _ in range(2))
    t = [torch.from_numpy(v) for v in (A, B, g0, g1)]
    z = iswt_merge.spec_merge_plain(t[0], t[1], t[2], t[3], axis)
    np.testing.assert_allclose(z.numpy(), emulate_spec(A, B, g0, g1, axis,
                                                       False)[0], atol=1e-12)
    s = iswt_merge.spec_split_plain(t[0], t[2], t[3], axis)
    e0, e1 = emulate_spec(A, None, g0, g1, axis, True)
    np.testing.assert_allclose(s[0].numpy(), e0, atol=1e-12)
    np.testing.assert_allclose(s[1].numpy(), e1, atol=1e-12)


@pytest.mark.parametrize("axis", [2, 3])
@pytest.mark.parametrize("n", [9, 10])
def test_fft_merge_half_spectrum(axis, n):
    """The port's rfft / K13 / irfft merge and its adjoint equal the JAX
    package's full-spectrum ``_fft_ls_merge`` (``ifft(...).real``) and its
    vjp, at odd and even lengths, within 1e-6 (fp32 FFTs of O(1) data)."""
    taps = tuple(pdwt._tup(pdwt._rev(t))
                 for t in pdwt.dec_filters("db2")[:2])
    filt = jdwt._iswt_fft_filters(*taps, 2, n)
    for a, b in zip(filt, pdwt._iswt_fft_filters(*taps, 2, n)):
        np.testing.assert_array_equal(a, b)
    shape = [2, 3, 4, 5]
    shape[axis] = n
    lo, hi, g = (rand(shape, s) for s in (1, 2, 3))
    want, vjp = jax.vjp(lambda a, b: jdwt._fft_ls_merge(a, b, filt, axis),
                        jnp.asarray(lo), jnp.asarray(hi))
    plan = pdwt._FFTMerge(*filt, n, torch.device("cpu"), torch.float32)
    got = plan.merge(torch.from_numpy(lo), torch.from_numpy(hi), axis)
    cmp(got, np.asarray(want), 1e-6)
    cmp(list(plan.split(torch.from_numpy(g), axis)),
        [np.asarray(v) for v in vjp(jnp.asarray(g))], 1e-6)


def _tensor_bytes(obj, seen=None):
    """Bytes of every tensor reachable from ``obj`` through attributes,
    lists and tuples."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return 0
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (list, tuple)):
        return sum(_tensor_bytes(o, seen) for o in obj)
    if hasattr(obj, "__dict__"):
        return sum(_tensor_bytes(o, seen) for o in vars(obj).values())
    return 0


@pytest.mark.parametrize("mode,n", [("zero", 40), ("periodic", 2060),
                                    ("symmetric", 2060)])
def test_merge_plans_count_their_bytes(mode, n):
    """The dense pinv, FFT and banded-LS merge plans each state through
    ``nbytes`` every tensor they hold, which is what the shared plan cache
    (``transforms/plan_cache.py``) counts against its budget."""
    from pytorch_wavelets_tpu_torch.transforms.plan_cache import plan_bytes
    taps = tuple(pdwt._tup(pdwt._rev(t))
                 for t in pdwt.dec_filters("db1")[:2])
    plan = pdwt._merge_plan(taps, 1, mode, n, torch.device("cpu"),
                            torch.float32)
    assert plan.nbytes == _tensor_bytes(plan) > 0
    assert plan_bytes({"plan": [plan, np.zeros(3)], "n": n}) == \
        plan.nbytes + 24


@pytest.mark.parametrize("n", [40, 4100])
def test_atrous_operator_matches_jax(n):
    """The probed (n <= 4096) and the synthesized (n > 4096) operator."""
    taps = tuple(pdwt._tup(pdwt._rev(t))
                 for t in pdwt.dec_filters("db2")[:2])
    want = np.asarray(jafb._afb_atrous_matrix(*taps, "symmetric", 2, n))
    got = afb_sfb._afb_atrous_matrix(*taps, "symmetric", 2, n)
    assert got.shape == (2 * n, n)
    np.testing.assert_array_equal(got, want)


def test_four_tuple_wave():
    """Distinct column and row filters: the SWT has no pair swap (the
    first pair filters along H)."""
    w1, w2 = tw.filters.wavelet("db2"), tw.filters.wavelet("bior2.2")
    dec = tuple(tuple(float(v) for v in f) for f in
                (w1.dec_lo, w1.dec_hi, w2.dec_lo, w2.dec_hi))
    swt_parity((1, 2, 12, 10), dec, "symmetric", 2)


def test_shapes_and_j0():
    x = torch.from_numpy(rand((1, 2, 32, 30)))
    ys = tt.SWTForward(J=3, wave="db2", device="cpu")(x)
    assert [tuple(y.shape) for y in ys] == [(1, 2, 4, 32, 30)] * 3
    assert tt.SWTForward(J=0, device="cpu")(x) == []


def test_coeff_dtype_and_upcast():
    """bf16 storage equals JAX's rounding of the same stacks; the inverse
    upcasts it (upcast=True) to the fp32 inverse of the upcast stacks, or
    keeps it (upcast=False, the plain path)."""
    x = rand((1, 2, 16, 16), 8)
    f = tt.SWTForward(J=2, wave="db2", coeff_dtype="bfloat16", device="cpu")
    ys = f(torch.from_numpy(x))
    assert all(y.dtype == torch.bfloat16 for y in ys)
    jys = tw.SWTForward(J=2, wave="db2", coeff_dtype="bfloat16")(
        jnp.asarray(x))
    cmp(ys, [np.asarray(y, dtype=np.float32) for y in jys], DWT_ATOL)
    i = tt.SWTInverse(wave="db2", device="cpu")
    rec = i(ys)
    assert rec.dtype == torch.float32
    assert torch.equal(rec, i([y.float() for y in ys]))
    narrow = tt.SWTInverse(wave="db2", upcast=False, device="cpu")(ys)
    assert narrow.dtype == torch.bfloat16


def test_mesh_not_ported():
    """``mesh=`` is ported for the SWT (tests/test_torch_sharded_dwt.py):
    anything but a ``DeviceMesh`` raises."""
    for cls in (tt.SWTForward, tt.SWTInverse):
        with pytest.raises(TypeError, match="DeviceMesh"):
            cls(device="cpu", mesh=object())


def test_filters_from_jax():
    """A JAX SWT module's dec taps load into both port modules (the
    inverse holds dec taps too); the outputs then agree."""
    w = tw.filters.wavelet("sym3")
    dec = tuple(tuple(float(v) for v in f) for f in
                (w.dec_lo, w.dec_hi, w.dec_lo, w.dec_hi))
    jf = tw.SWTForward(J=2, wave=dec, mode="reflect")
    ji = tw.SWTInverse(wave=dec, mode="reflect")
    # built with other taps of the same length (db3), then loaded
    f = tt.SWTForward(J=2, wave="db3", mode="reflect", device="cpu")
    i = tt.SWTInverse(wave="db3", mode="reflect", device="cpu")
    f.load_state_dict(convert.swt_filters_from_jax(jf._filters))
    i.load_state_dict(convert.swt_filters_from_jax(ji._filters))
    assert set(i.state_dict()) == {"h0_col", "h1_col", "h0_row", "h1_row"}
    x = rand((1, 1, 12, 12), 4)
    jys = jf(jnp.asarray(x))
    cmp(f(torch.from_numpy(x)), jys, DWT_ATOL)
    cmp(i([torch.from_numpy(np.array(y)) for y in jys]), ji(jys), 2e-5)
    with pytest.raises(ValueError, match="4-tuple"):
        convert.swt_filters_from_jax(jf._filters[:2])
