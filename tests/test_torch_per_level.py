"""The port's per-level DTCWT path (CPU, plain versions of K8-K10 and of
K2/K3's per-level mode) == the JAX package's per-level path on the CPU
(its conv path), outputs and ``jax.vjp`` gradients, at the JAX suite's
DTCWT tolerances (tests/test_dtcwt.py): the level Functions
(``fwd_j1_op`` ... ``inv_j2plus_op``, the bandpass-diagonal ``_rot``
variants), every biort and qshift bank, skip_hps, lows-only and
highs-only inverses, two o_dim/ri_dim layouts; and the modules under
``set_operator_matmul(False)``, past ``MAX_MATMUL_N`` and with even-length
level-1 taps."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pytorch_wavelets_tpu as tw
from pytorch_wavelets_tpu.filters import biort as jbiort, qshift as jqshift
from pytorch_wavelets_tpu.ops import banded as jbanded
from pytorch_wavelets_tpu.ops.dtcwt_fb import prep_taps
from pytorch_wavelets_tpu.transforms import dtcwt as jlev

import pytorch_wavelets_tpu_torch as tt
from pytorch_wavelets_tpu_torch.ops import banded as pbanded
from pytorch_wavelets_tpu_torch.ops import dtcwt_fb
from pytorch_wavelets_tpu_torch.transforms import dtcwt as plev
from tests.torch_parity import FWD_ATOL, INV_ATOL, cmp, rand

torch.set_num_threads(1)

GRAD_ATOL = 2e-5     # the JAX suite's DTCWT tolerance (tests/test_dtcwt.py)


@pytest.fixture(autouse=True)
def per_level():
    """Both packages on their per-level paths (JAX: its conv path)."""
    jbanded.set_operator_matmul(False)
    pbanded.set_operator_matmul(False)
    yield
    jbanded.set_operator_matmul(None)
    pbanded.set_operator_matmul(None)


def _t(taps):
    return tuple(float(v) for v in prep_taps(taps))


def _banks(b, q):
    """Forward taps (level 1, level >= 2) and inverse taps of a bank
    pair; the inverse is None for the bandpass-diagonal banks, which only
    the scattering layers' forward levels use."""
    if b == "near_sym_b_bp":
        h0o, _, h1o, _, h2o, _ = jbiort(b)
        h0a, h0b, _, _, h1a, h1b, _, _, h2a, h2b, _, _ = jqshift(q)
        return ((_t(h0o), _t(h1o), _t(h2o)),
                tuple(map(_t, (h0a, h1a, h0b, h1b, h2a, h2b))), None)
    h0o, g0o, h1o, g1o = jbiort(b)
    h0a, h0b, g0a, g0b, h1a, h1b, g1a, g1b = jqshift(q)
    return ((_t(h0o), _t(h1o)), tuple(map(_t, (h0a, h1a, h0b, h1b))),
            ((_t(g0o), _t(g1o)), tuple(map(_t, (g0a, g1a, g0b, g1b)))))


def _run(pkg, grad, xs, cts, dims, mode, f1, f2, inv):
    """Every level case of one package, values and gradients in one flat
    list: per forward level (ll, bands, dx) and (ll, dx) with skip_hps;
    level 1 with skip_hps on an odd size; per inverse level (y, d lows,
    d bands), then lows only (y, d lows) and bands only (y, d bands).
    ``cts`` gives the cotangents in that order (None: make them later)."""
    rot = len(f1) == 3
    fwd = (pkg.fwd_j1_rot_op if rot else pkg.fwd_j1_op,
           pkg.fwd_j2plus_rot_op if rot else pkg.fwd_j2plus_op)
    od, rd = dims
    ct = iter(cts)
    out, coeffs = [], []
    for fn, taps, x in zip(fwd, (f1, f2), xs):
        (ll, h), dx = grad(lambda z: fn(z, *taps, False, od, rd, mode),
                           (x,), (next(ct), next(ct)))
        (lls,), dxs = grad(lambda z: (fn(z, *taps, True, od, rd, mode)[0],),
                           (x,), (next(ct),))
        out += [ll, h, *dx, lls, *dxs]
        coeffs.append((ll, h))
    (ll,), dx = grad(lambda z: (fwd[0](z, *f1, True, od, rd, mode)[0],),
                     (xs[2],), (next(ct),))
    out += [ll, *dx]
    if inv is None:
        return out
    for fn, taps, (ll, h) in zip((pkg.inv_j1_op, pkg.inv_j2plus_op), inv,
                                 coeffs):
        def g(lo, hi, fn=fn, taps=taps):
            return (fn(lo, hi, *taps, od, rd, mode),)
        for args, call in (((ll, h), g), ((ll,), lambda lo: g(lo, None)),
                           ((h,), lambda hi: g(None, hi))):
            (y,), d = grad(call, args, (next(ct),))
            out += [y, *d]
    return out


def _jax_grad(fn, args, cts):
    outs, vjp = jax.vjp(lambda *a: tuple(fn(*a)), *args)
    return outs, vjp(tuple(jnp.asarray(c) for c in cts))


def _torch_grad(fn, args, cts):
    leaves = [a.detach().clone().requires_grad_() for a in args]
    outs = tuple(fn(*leaves))
    if cts[0] is None:        # shapes only: zeros, as long as they fit
        cts = [torch.zeros(o.shape) for o in outs]
    grads = torch.autograd.grad(outs, leaves,
                                [torch.as_tensor(c) for c in cts])
    return tuple(o.detach() for o in outs), grads


class _Shapes:
    """Cotangents made to measure: the first pass records each output's
    shape, the second hands out seeded random arrays of those shapes."""

    def __init__(self):
        self.shapes = []

    def __iter__(self):
        return self

    def __next__(self):
        return None

    def record(self, fn, args, cts):
        outs, grads = _torch_grad(fn, args, [None])
        self.shapes += [tuple(o.shape) for o in outs]
        return outs, grads


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


# (biort, qshift, (o_dim, ri_dim), mode): every bank of each kind once
CASES = [
    ("antonini", "qshift_06", (2, -1), "symmetric"),
    ("legall", "qshift_a", (1, 3), "symmetric"),
    ("near_sym_a", "qshift_b", (2, -1), "zero"),
    ("near_sym_b", "qshift_c", (1, 3), "symmetric"),
    ("near_sym_a", "qshift_d", (1, 3), "symmetric"),
    ("near_sym_b", "qshift_32", (2, -1), "symmetric"),
    ("near_sym_b_bp", "qshift_b_bp", (1, -1), "symmetric"),
    ("near_sym_b_bp", "qshift_b_bp", (2, 4), "zero"),
]


@pytest.mark.parametrize("b,q,dims,mode", CASES)
def test_level_ops_match_jax(b, q, dims, mode):
    """Each level Function's outputs and gradients (the JAX custom VJPs'
    bwd: the inverse level with the same taps, the q-shift trees
    swapped) against JAX's, in one jitted JAX program per case."""
    f1, f2, inv = _banks(b, q)
    xs = [rand((1, 2, 14, 18), 1), rand((1, 2, 16, 12), 2),
          rand((1, 2, 13, 17), 3)]
    txs = [torch.from_numpy(x) for x in xs]
    probe = _Shapes()
    _run(plev, probe.record, txs, probe, dims, mode, f1, f2, inv)
    cts = [rand(s, 10 + k) for k, s in enumerate(probe.shapes)]

    def jax_all(xs, cts):
        return _run(jlev, _jax_grad, xs, cts, dims, mode, f1, f2, inv)
    ref = jax.jit(jax_all)(xs, cts)
    mine = _run(plev, _torch_grad, txs, cts, dims, mode, f1, f2, inv)
    assert len(mine) == len(ref)
    for k, (a, r) in enumerate(zip(mine, ref)):
        assert (a is None) == (r is None), k
        if a is not None:
            assert tuple(a.shape) == tuple(r.shape), k
            np.testing.assert_allclose(_np(a), np.asarray(r),
                                       atol=GRAD_ATOL, err_msg=str(k))


@pytest.mark.parametrize("shape,kw", [
    ((2, 3, 37, 42), dict(J=3)),
    ((1, 2, 32, 40), dict(J=2, o_dim=1, ri_dim=3, biort="near_sym_b",
                          qshift="qshift_c")),
    ((1, 2, 48, 40), dict(J=3, qshift="qshift_32", mode="zero",
                          skip_hps=[False, True, False],
                          include_scale=[True, False, True])),
])
def test_modules_per_level_match_jax(shape, kw):
    """DTCWTForward -> DTCWTInverse and x.grad of a loss on every output,
    per level in both packages."""
    dims = {k: v for k, v in kw.items() if k in ("o_dim", "ri_dim",
                                                 "biort", "qshift", "mode")}
    x = rand(shape, 4)
    pf = tt.DTCWTForward(device="cpu", **kw)
    pi = tt.DTCWTInverse(device="cpu", **dims)
    _modules_match(tw.DTCWTForward(**kw), tw.DTCWTInverse(**dims), pf, pi,
                   x)


def _modules_match(jf, ji, pf, pi, x, grad=True):
    """Every output of forward -> inverse, and (with ``grad``) the
    gradient of a loss on all of them, through both packages (the JAX
    side jitted)."""
    def outs(f, i, z):
        yl, yh = f(z)
        low = yl[-1] if isinstance(yl, list) else yl
        lows = [t for t in (yl if isinstance(yl, list) else [yl])
                if t is not None]
        return [*lows, *[h for h in yh if h is not None], i((low, yh))]

    xt = torch.from_numpy(x).requires_grad_()
    mine = outs(pf, pi, xt)
    cts = [rand(tuple(m.shape), 30 + k) for k, m in enumerate(mine)]

    def jax_side(z, cts):
        if not grad:
            return outs(jf, ji, z), None
        ref, vjp = jax.vjp(lambda z: outs(jf, ji, z), z)
        return ref, vjp([jnp.asarray(c) for c in cts])[0]
    ref, jg = jax.jit(jax_side)(jnp.asarray(x), cts)
    cmp(mine[:-1], ref[:-1], FWD_ATOL)
    cmp(mine[-1], ref[-1], INV_ATOL)
    if not grad:
        return
    sum((m * torch.from_numpy(c)).sum() for m, c in zip(mine, cts)) \
        .backward()
    cmp(xt.grad, jg, GRAD_ATOL)


def test_past_max_matmul_n():
    """An axis above MAX_MATMUL_N takes the per-level path under the
    default dispatch (no composed plan is built)."""
    pbanded.set_operator_matmul(None)
    assert 8840 > pbanded.MAX_MATMUL_N
    _modules_match(tw.DTCWTForward(J=2), tw.DTCWTInverse(),
                   tt.DTCWTForward(J=2, device="cpu"),
                   tt.DTCWTInverse(device="cpu"), rand((1, 1, 8, 8840), 5))


def test_even_length_level1_taps():
    """Custom even-length level-1 taps give odd outputs (n + 1): the
    lowpass-only transform and its inverse run as in the JAX package (whose
    custom VJP refuses the n + 2 gradient, so only the values are held
    against it); the bands, whose corners are undefined, raise in both."""
    rs = np.random.RandomState(6)
    taps = (rs.randn(4), rs.randn(4))
    x = rand((1, 2, 32, 30), 7)
    pf = tt.DTCWTForward(biort=taps, J=1, skip_hps=True, device="cpu")
    assert tuple(pf(torch.from_numpy(x))[0].shape) == (1, 2, 33, 31)
    _modules_match(tw.DTCWTForward(biort=taps, J=1, skip_hps=True),
                   tw.DTCWTInverse(biort=taps), pf,
                   tt.DTCWTInverse(biort=taps, device="cpu"), x, grad=False)
    with pytest.raises(TypeError):
        jax.eval_shape(tw.DTCWTForward(biort=taps, J=1), jnp.asarray(x))
    with pytest.raises(ValueError, match="odd"):
        tt.DTCWTForward(biort=taps, J=1, device="cpu")(torch.from_numpy(x))


def test_dispatch():
    """Which path runs: the stencils (K8-K10's wrappers) are called only
    on the per-level path."""
    calls = []
    orig = dtcwt_fb.dtcwt_filt

    def counting(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    dtcwt_fb.dtcwt_filt = counting
    try:
        x = torch.from_numpy(rand((1, 1, 16, 16), 8))
        for force, per_level in ((None, False), (True, False),
                                 (False, True)):
            pbanded.set_operator_matmul(force)
            del calls[:]
            tt.DTCWTInverse(device="cpu")(tt.DTCWTForward(J=2,
                                                          device="cpu")(x))
            assert bool(calls) == per_level, force
            del calls[:]
            tt.ScatLayer(device="cpu")(x)
            assert bool(calls) == per_level, force
            del calls[:]
            tt.ScatLayer(biort="near_sym_b_bp", device="cpu")(x)
            assert calls, force        # bandpass-diagonal: always per level
    finally:
        dtcwt_fb.dtcwt_filt = orig


def test_level_errors():
    x = torch.zeros(1, 1, 18, 16)
    f2 = _banks("near_sym_a", "qshift_a")[1]
    with pytest.raises(ValueError, match="multiple of 4"):
        plev.fwd_j2plus(x, *f2, None, None, False, 1, 4, "symmetric")
    with pytest.raises(NotImplementedError, match="symmetric"):
        dtcwt_fb.coldfilt(x[:, :, :16], f2[0], f2[2], mode="zero")
    with pytest.raises(ValueError, match="multiple of 2"):
        dtcwt_fb.colifilt(x[:, :, :15], f2[0], f2[2])
    with pytest.raises(ValueError, match="no lowpass"):
        tt.DTCWTInverse(device="cpu")((None, [None, None]))
