"""Second-order gradients of each of the port's autograd Functions, on the
CPU in float64: ``torch.autograd.gradgradcheck`` (the backward's own
backward against finite differences of the backward) for every Function
at a tiny size, one parametrised case each; and K18's plain version
against autograd's second derivative of K4's plain formula."""
import numpy as np
import pytest
import torch

from pytorch_wavelets_tpu_torch.ops import afb_sfb, fused_dtcwt, nonsep
from pytorch_wavelets_tpu_torch.ops.scat_mag import (
    scat_mag_bwd2_plain, scat_mag_fwd_plain,
)
from pytorch_wavelets_tpu_torch.transforms import dtcwt as pdt
from pytorch_wavelets_tpu_torch.transforms import dwt as pdwt
from pytorch_wavelets_tpu_torch.transforms import scatternet as pscat
from pytorch_wavelets_tpu_torch.transforms.dtcwt_xfm import (
    dtcwt_fwd_filters, dtcwt_inv_filters,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _r(shape, seed):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape))


def _taps(wave, rec=False):
    f = (pdwt.rec_filters if rec else pdwt.dec_filters)(wave)
    return tuple(pdwt._fwdarr(t) if rec else pdwt._rev(t) for t in f)


def _pyramid_ops():
    f, g = dtcwt_fwd_filters(), dtcwt_inv_filters()
    fwd = fused_dtcwt.analysis_operators(pdt._fwd_pyramid_plan(
        f["h0o"], f["h1o"], f["h0a"], f["h1a"], f["h0b"], f["h1b"], 2,
        (False, False), (True, False), "symmetric", 16, 16), CPU)
    inv = pdt.inv_pyramid_operators(
        g["g0o"], g["g1o"], g["g0a"], g["g1a"], g["g0b"], g["g1b"],
        "symmetric", (8, 8), ((8, 8), (4, 4)), CPU)
    return fwd, inv


def _analysis():
    ops = _pyramid_ops()[0]

    def fn(x):
        lls, yh = fused_dtcwt.analysis_pyramid(x, ops, 1, 5)
        return (*[t for t in lls if t is not None], *yh)
    return fn, [(1, 1, 16, 16)]


def _synthesis():
    ops = _pyramid_ops()[1]
    return (lambda ll, h1, h2: fused_dtcwt.synthesis_pyramid(ll, [h1, h2],
                                                             ops),
            [(1, 1, 8, 8), (1, 1, 6, 8, 8, 2), (1, 1, 6, 4, 4, 2)])


def _level(j1, inverse):
    f, g = dtcwt_fwd_filters(), dtcwt_inv_filters()
    if inverse:
        if j1:
            return (lambda ll, h: pdt.inv_j1_op(ll, h, g["g0o"], g["g1o"], 2,
                                                -1, "symmetric"),
                    [(1, 2, 12, 10), (1, 2, 6, 6, 5, 2)])
        return (lambda ll, h: pdt.inv_j2plus_op(
            ll, h, g["g0a"], g["g1a"], g["g0b"], g["g1b"], 2, -1,
            "symmetric"), [(1, 2, 6, 4), (1, 2, 6, 3, 2, 2)])
    if j1:
        return (lambda x: pdt.fwd_j1_op(x, f["h0o"], f["h1o"], False, 2, -1,
                                        "symmetric"), [(1, 2, 12, 10)])
    return (lambda x: pdt.fwd_j2plus_op(x, f["h0a"], f["h1a"], f["h0b"],
                                        f["h1b"], False, 2, -1, "symmetric"),
            [(1, 2, 12, 8)])


def _afb1d(out_len):
    h0, h1 = _taps("db2")[:2]
    return (lambda x: afb_sfb._AFB1D.apply(x, h0, h1, "symmetric", 2,
                                           out_len), [(1, 2, 9, 5)])


def _sfb1d(out_len):
    g0, g1 = _taps("db2", rec=True)[:2]
    return (lambda lo, hi: afb_sfb._SFB1D.apply(lo, hi, g0, g1,
                                                "periodization", 3, out_len),
            [(1, 2, 3, 5), (1, 2, 3, 5)])


def _afb1d_atrous():
    h0, h1 = _taps("db2")[:2]
    return (lambda x: afb_sfb._AFB1DAtrous.apply(x, h0, h1, "reflect", 3, 2),
            [(1, 2, 5, 9)])


def _sfb1d_atrous():
    g0, g1 = _taps("db2", rec=True)[:2]
    return (lambda lo, hi: afb_sfb._SFB1DAtrous.apply(lo, hi, g0, g1,
                                                      "symmetric", 2, 2),
            [(1, 2, 9, 5), (1, 2, 9, 5)])


def _afb2d_atrous():
    taps = _taps("db2")
    return (lambda x: afb_sfb._AFB2DAtrous.apply(x, taps, "periodization",
                                                 1), [(1, 1, 7, 6)])


def _nonsep_afb():
    f = np.random.RandomState(3).randn(4, 4, 3)
    return lambda x: nonsep.NonsepAFB.apply(x, f, "zero"), [(1, 2, 7, 6)]


def _nonsep_sfb():
    f = np.random.RandomState(4).randn(4, 4, 4)
    return (lambda c: nonsep.NonsepSFB.apply(c, f, "periodization"),
            [(1, 1, 4, 4, 3)])


def _separable_afb():
    return (lambda x: afb_sfb.afb2d(x, *pdwt.dec_filters("db2"),
                                    mode="symmetric"), [(1, 1, 7, 6)])


def _separable_sfb():
    return (lambda a, b, c, d: afb_sfb.sfb2d(
        a, b, c, d, *pdwt.rec_filters("db2"), mode="zero"),
        [(1, 1, 4, 3)] * 4)


def _dwt_step(inverse, one_d):
    mode = "symmetric"
    if one_d:
        if inverse:
            taps = _taps("db2", rec=True)[:2]
            return (lambda lo, hi: pdwt._SFB1D.apply(lo, hi, taps, mode, 4),
                    [(1, 2, 4), (1, 2, 4)])
        taps = _taps("db2")[:2]
        return (lambda x: pdwt._AFB1D.apply(x, taps, mode), [(1, 2, 7)])
    if inverse:
        taps = _taps("db2", rec=True)
        return (lambda lo, hi: pdwt._SFB2D.apply(lo, hi, taps, mode, (4, 3)),
                [(1, 1, 4, 3), (1, 1, 3, 4, 3)])
    taps = _taps("db2")
    return lambda x: pdwt._AFB2D.apply(x, taps, mode), [(1, 1, 7, 6)]


def _ls_merge():
    taps = tuple(pdwt._tup(t) for t in _taps("db2")[:2])
    return (lambda lo, hi: pdwt.ls_merge(lo, hi, taps, 2, 2, "symmetric"),
            [(1, 1, 8, 3), (1, 1, 8, 3)])


def _smooth_mag(combine):
    return (lambda h: pscat.smooth_mag(h, 0.1, combine),
            [(1, 6, 2, 3, 2, 2)])


def _avg_pool2():
    return pscat.avg_pool2, [(1, 2, 4, 6)]


CASES = {
    "fused_dtcwt._AnalysisPyramid": _analysis,
    "fused_dtcwt._SynthesisPyramid": _synthesis,
    "dtcwt._FwdLevel j1": lambda: _level(True, False),
    "dtcwt._FwdLevel j2": lambda: _level(False, False),
    "dtcwt._InvLevel j1": lambda: _level(True, True),
    "dtcwt._InvLevel j2": lambda: _level(False, True),
    "afb_sfb._AFB1D": lambda: _afb1d(None),
    "afb_sfb._AFB1D out_len": lambda: _afb1d(4),
    "afb_sfb._SFB1D": lambda: _sfb1d(None),
    "afb_sfb._SFB1D out_len": lambda: _sfb1d(7),
    "afb_sfb._AFB1DAtrous": _afb1d_atrous,
    "afb_sfb._SFB1DAtrous": _sfb1d_atrous,
    "afb_sfb._AFB2DAtrous": _afb2d_atrous,
    "nonsep.NonsepAFB": _nonsep_afb,
    "nonsep.SeparableAFB": _separable_afb,
    "nonsep.SeparableSFB": _separable_sfb,
    "nonsep.NonsepSFB": _nonsep_sfb,
    "dwt._AFB2D": lambda: _dwt_step(False, False),
    "dwt._SFB2D": lambda: _dwt_step(True, False),
    "dwt._AFB1D": lambda: _dwt_step(False, True),
    "dwt._SFB1D": lambda: _dwt_step(True, True),
    "dwt._LSMerge": _ls_merge,
    "scatternet._SmoothMag": lambda: _smooth_mag(False),
    "scatternet._SmoothMag combine": lambda: _smooth_mag(True),
    "scatternet._AvgPool2": _avg_pool2,
}


@pytest.mark.parametrize("name", list(CASES))
def test_gradgradcheck(name):
    fn, shapes = CASES[name]()
    ins = [_r(s, 10 + k).requires_grad_() for k, s in enumerate(shapes)]
    assert torch.autograd.gradgradcheck(fn, ins, eps=1e-6, atol=1e-5,
                                        fast_mode=True)


@pytest.mark.parametrize("combine", [False, True])
@pytest.mark.parametrize("bias", [0.0, 1e-2])
def test_k18_plain_is_second_derivative(combine, bias):
    """scat_mag_bwd2_plain(h, g, u) == autograd's (d/dh, d/dg) of
    <d/dh <g, fwd(h)>, u> through K4's plain formula, float64 (at bias 0
    on nonzero bands)."""
    h = _r((2, 6, 3, 4, 5, 2), 1).requires_grad_()
    g = _r((2, 6, 1 if combine else 3, 4, 5), 2).requires_grad_()
    u = _r(h.shape, 3)
    dh, = torch.autograd.grad((scat_mag_fwd_plain(h, bias, combine) * g)
                              .sum(), h, create_graph=True)
    want_h, want_g = torch.autograd.grad((dh * u).sum(), (h, g))
    got_g, got_h = scat_mag_bwd2_plain(h.detach(), g.detach(), u, bias,
                                       combine)
    torch.testing.assert_close(got_h, want_h, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(got_g, want_g, rtol=1e-12, atol=1e-12)


def test_k18_plain_at_zero_bias_and_zero_band():
    """At bias 0 a zero coefficient gives NaN, as K5 does there."""
    h = torch.zeros(1, 6, 1, 1, 2, 2, dtype=torch.float64)
    h[..., 1, :] = 1.0
    g = torch.ones(1, 6, 1, 1, 2, dtype=torch.float64)
    dg, dh = scat_mag_bwd2_plain(h, g, torch.ones_like(h), 0.0)
    assert torch.isnan(dg[..., 0]).all() and torch.isnan(dh[..., 0, :]).all()
    assert torch.isfinite(dg[..., 1]).all()
    assert torch.isfinite(dh[..., 1, :]).all()
