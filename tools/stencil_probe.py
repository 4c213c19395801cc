#!/usr/bin/env python3
"""Time K2 (q2c_pack), K3 (c2q_unpack), K4 (scat_mag_fwd), K5 (scat_mag_bwd),
K6 (dwt_afb), K7 (dwt_sfb), K8 (dtcwt_filt), K9 (dtcwt_dfilt), K10
(dtcwt_ifilt), K11 (avg_pool2 and its adjoint), K12
(swt_afb and its adjoint), K14 (nonsep_afb and its adjoint), K15
(nonsep_sfb and its adjoint), K13 (spec_merge and spec_split), K16
(swt_sfb and its adjoint) and K19 (halo_pack, halo_assemble, halo_fold)
on one CUDA card at the shapes of chip_smoke.py's DTCWT, scattering,
DWT, per-level, SWT, non-separable, à trous and sharded paths, each call
checked against its plain version.  K13 is also timed with the irfft
that follows it.

    python3 tools/stencil_probe.py [--root DIR] [--merge-tile-out N]
                                   [--only k2|k3|k4|k5|k6|k7|k8|k9|k10|
                                    k11|k12|k13|k14|k15|k16|k19 ...]
                                   [--sass q2c_pack iswt_spec ...]

``--root`` imports ``pytorch_wavelets_tpu_torch`` from another checkout
(say an unpacked parent commit), so that two versions can be timed on one
card in one sitting: run it once per root, in turns.  ``--merge-tile-out``
sets the outputs a row of K12's and K16's row tile aims at
(``ops/afb_sfb.py:merge_row_tile``, 64 by default), to try others.
Prints one JSON line a call (device ms: CUDA events over back-to-back
calls after a warm-up) and the card's name and power limit.  Imports
torch, numpy and the port only.
"""
import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch


def timed_ms(fn, reps=10, batches=3):
    """Median over batches of the mean device time of ``reps`` calls: the
    card spins (~50 ms) while the host enqueues a batch, so a short
    kernel is timed, not the host's launch rate (chip_smoke.timed_ms)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


def k8_cases(fb, filters):
    """(label, x, taps, axis, mode): the level-1 filters of scat_bp's two
    stages and of dtcwt_large."""
    bp = filters.biort("near_sym_b_bp")
    sa = filters.biort("near_sym_a")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape, bank, name in (((128, 3, 256, 256), bp, "scat_bp 1"),
                              ((128, 18, 128, 128), bp, "scat_bp 2"),
                              ((1, 3, 9216, 9216), sa, "dtcwt_large")):
        x = torch.randn(shape, generator=gen, device="cuda")
        for i in (0, 1):
            t = fb.prep_taps(bank[i])
            for axis in (3, 2):
                yield f"{name} L={len(t)} axis {axis}", x, t, axis
        del x


def run_k8(fb, filters):
    for label, x, t, axis in k8_cases(fb, filters):
        got = fb.dtcwt_filt(x, t, axis, "symmetric")
        want = fb.dtcwt_filt_plain(x, t, axis, "symmetric")
        err = float((got - want).abs().max())
        ok = bool(torch.allclose(got, want, rtol=1e-5, atol=1e-5))
        ms = timed_ms(lambda: fb.dtcwt_filt(x, t, axis, "symmetric"))
        bound = 4.0 * (x.numel() + got.numel()) / 3.35e12 * 1e3
        print(json.dumps({"kernel": "dtcwt_filt", "case": label, "ms": ms,
                          "bound_ms": bound, "max_abs_err": err, "ok": ok}),
              flush=True)
        del got, want


def run_k14(nonsep, filters):
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(1)
    h0a, h0b, _, _, h1a, h1b, _, _ = filters.qshift("qshift_a")
    quad = np.stack([np.outer(c, r) for c in (h0a, h1a, h0b, h1b)
                     for r in (h0a, h1a, h0b, h1b)])
    w = filters.wavelet("db4")
    db4 = nonsep.outer_filters(w.dec_lo, w.dec_hi, w.dec_lo,
                               w.dec_hi)[:, ::-1, ::-1].copy()
    for label, shape, f, mode in (
            ("quad", (128, 3, 256, 256), quad, "zero"),
            ("db4 per", (32, 10, 512, 512), db4, "periodization"),
            ("db4 sym", (32, 10, 512, 512), db4, "symmetric")):
        x = torch.randn(shape, generator=gen, device="cuda")
        got = nonsep.nonsep_afb(x, f, mode)
        check = slice(0, 4)
        want = nonsep.nonsep_afb_plain(x[check], f, mode)
        err = float((got[check] - want).abs().max())
        ms = timed_ms(lambda: nonsep.nonsep_afb(x, f, mode))
        K, Ly, Lx = f.shape
        flop = 2.0 * Ly * Lx * got.numel()
        bound = max(flop / 67e12, 4.0 * (x.numel() + got.numel())
                    / 3.35e12) * 1e3
        line = {"kernel": "nonsep_afb", "case": label, "ms": ms,
                "bound_ms": bound, "max_abs_err": err,
                "ok": bool(torch.allclose(got[check], want, rtol=1e-5,
                                          atol=1e-5))}
        if mode == "zero":
            wt = torch.as_tensor(f[:, None], dtype=torch.float32,
                                 device="cuda")
            H, W = shape[2:]
            _, front = nonsep.afb_axis_plan(H, Ly, mode)[:2]
            back = 2 * (got.shape[3] - 1) + Ly - H - front
            xp = F.pad(x.reshape(-1, 1, H, W), (front, back, front, back))
            line["cudnn_ms"] = timed_ms(lambda: F.conv2d(xp, wt, stride=2))
        print(json.dumps(line), flush=True)
        if mode != "zero":
            g = torch.randn(got.shape, generator=gen, device="cuda")
            H, W = shape[2:]
            dx = nonsep.nonsep_afb_adjoint(g, f, mode, H, W)
            want = nonsep.nonsep_afb_adjoint_plain(g[check], f, mode, H, W)
            err = float((dx[check] - want).abs().max())
            ms = timed_ms(lambda: nonsep.nonsep_afb_adjoint(g, f, mode, H,
                                                            W))
            print(json.dumps({
                "kernel": "nonsep_afb_adjoint", "case": label, "ms": ms,
                "bound_ms": bound, "max_abs_err": err,
                "ok": bool(torch.allclose(dx[check], want, rtol=1e-5,
                                          atol=1e-5))}), flush=True)
            del g, dx
        del x, got


def _line(kernel, label, got, want, ms, nbytes, inst=None):
    line = {"kernel": kernel, "case": label, "ms": ms,
            "bound_ms": nbytes / 3.35e12 * 1e3,
            "max_abs_err": float((got - want).abs().max()),
            "ok": bool(torch.allclose(got, want, rtol=1e-5, atol=1e-5))}
    if inst:
        line["instantiations"] = inst
    print(json.dumps(line), flush=True)


def _insts(wrapper, run):
    before = dict(getattr(wrapper, "instantiations", {}))
    run()
    return {k: v - before.get(k, 0) for k, v in
            getattr(wrapper, "instantiations", {}).items()
            if v != before.get(k, 0)}


def run_k9(fb, filters):
    """dtcwt_large's level-2 and level-3 decimations (qshift_a: rowdfilt,
    then coldfilt into a band of the level's (N, C, 3, H', W') stack, as
    fwd_j2plus writes) and scat_bp's level-2 pair (qshift_b_bp, 256^2)."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    for label, shape, axis, bank in (
            ("large L2 row", (1, 3, 9216, 9216), 3, "qshift_a"),
            ("large L2 col", (1, 3, 9216, 4608), 2, "qshift_a"),
            ("large L3 row", (1, 3, 4608, 4608), 3, "qshift_a"),
            ("large L3 col", (1, 3, 4608, 2304), 2, "qshift_a"),
            ("bp row", (128, 3, 256, 256), 3, "qshift_b_bp"),
            ("bp col", (128, 3, 256, 128), 2, "qshift_b_bp")):
        q = filters.qshift(bank)
        for highpass in (False, True):
            ha, hb = ((fb.prep_taps(q[5]), fb.prep_taps(q[4])) if highpass
                      else (fb.prep_taps(q[1]), fb.prep_taps(q[0])))
            x = torch.randn(shape, generator=gen, device="cuda")
            out = None
            if axis == 2:
                s = list(shape)
                s[2] //= 2
                out = torch.empty((s[0], s[1], 3, s[2], s[3]),
                                  device="cuda")[:, :, 1]
            inst = _insts(fb.dtcwt_dfilt, lambda: fb.dtcwt_dfilt(
                x, ha, hb, highpass, axis, out))
            got = fb.dtcwt_dfilt(x, ha, hb, highpass, axis).clone()
            crop = slice(0, 1)
            want = fb.dtcwt_dfilt_plain(x[crop], ha, hb, highpass, axis)
            ms = timed_ms(lambda: fb.dtcwt_dfilt(x, ha, hb, highpass, axis,
                                                 out))
            _line("dtcwt_dfilt", f"{label} hp={int(highpass)}", got[crop],
                  want, ms, 4.0 * (x.numel() + got.numel()), inst)
            del x, out, got, want


def run_k6(afb, filters):
    """dwt_main's splits (DWT J=3, db4, 'symmetric', 32x10x512^2: the row
    split of each level's input, the lowpass band of the level above read
    in place, then the column split of its (N, 2C, H, W') output; odd
    widths 259, 133, 70), dwt1d's first split (16x8 planes of one row)
    and alt_main's first pair (10 taps, 128x3)."""
    db4, qsa = filters.wavelet("db4"), filters.qshift("qshift_a")
    gen = torch.Generator(device="cuda").manual_seed(7)
    h_db4 = [np.asarray(h, np.float64)[::-1].copy()
             for h in (db4.dec_lo, db4.dec_hi)]
    h_alt = [np.asarray(qsa[i], np.float64).ravel()[::-1].copy()
             for i in (0, 4)]
    cases = []
    for j, n in ((1, 512), (2, 259), (3, 133)):
        m = (n + 7) // 2
        cases += [(f"dwt L{j} row", (32, 10, n, n), 3, h_db4, j > 1),
                  (f"dwt L{j} col", (32, 20, n, m), 2, h_db4, False)]
    cases += [("dwt1d L1 row", (16, 8, 1, 65536), 3, h_db4, False),
              ("alt L1 row", (128, 3, 256, 256), 3, h_alt, False),
              ("alt L1 col", (128, 6, 256, 132), 2, h_alt, False)]
    mode = "symmetric"
    for label, shape, axis, (h0, h1), band in cases:
        if band:   # the LL band of the level above's (N, C, 4, H, W) stack
            N, C, H, W = shape
            x = torch.randn((N, C, 4, H, W), generator=gen,
                            device="cuda")[:, :, 0]
        else:
            x = torch.randn(shape, generator=gen, device="cuda")
        inst = _insts(afb.afb1d_corr, lambda: afb.afb1d_corr(
            x, h0, h1, mode, axis))
        got = afb.afb1d_corr(x, h0, h1, mode, axis)
        crop = slice(0, 2)
        want = afb.afb1d_corr_plain(x[crop], h0, h1, mode, axis)
        ms = timed_ms(lambda: afb.afb1d_corr(x, h0, h1, mode, axis))
        _line("dwt_afb", label, got[crop], want, ms,
              4.0 * (x.numel() + got.numel()), inst)
        del got, want, x


def run_k10(fb, filters):
    """dtcwt_large's level-2 and level-3 interpolations (colifilt into and
    onto a fresh output, rowifilt) and a scat_bp-sized pair."""
    q = filters.qshift("qshift_a")
    ha, hb = fb.prep_taps(q[1]), fb.prep_taps(q[0])
    gen = torch.Generator(device="cuda").manual_seed(2)
    for label, shape, axis in (
            ("large L2 col", (1, 3, 4608, 4608), 2),
            ("large L2 row", (1, 3, 9216, 4608), 3),
            ("large L3 col", (1, 3, 2304, 2304), 2),
            ("large L3 row", (1, 3, 4608, 2304), 3),
            ("bp col", (128, 3, 64, 128), 2),
            ("bp row", (128, 3, 128, 64), 3)):
        x = torch.randn(shape, generator=gen, device="cuda")
        for acc in (False, True):
            out = None
            if acc:
                s = list(shape)
                s[axis] *= 2
                out = torch.randn(s, generator=gen, device="cuda")
            buf = None if out is None else out.clone()
            inst = _insts(fb.dtcwt_ifilt, lambda: fb.dtcwt_ifilt(
                x, ha, hb, False, axis, buf, acc))
            got = fb.dtcwt_ifilt(x, ha, hb, False, axis,
                                 None if out is None else out.clone(), acc)
            crop = slice(0, 1)
            want = fb.dtcwt_ifilt_plain(
                x[crop], ha, hb, False, axis,
                None if out is None else out[crop].clone(), acc)
            ms = timed_ms(lambda: fb.dtcwt_ifilt(x, ha, hb, False, axis,
                                                 buf, acc))
            nbytes = 4.0 * (x.numel() + got.numel() * (2 if acc else 1))
            _line("dtcwt_ifilt", label + (" acc" if acc else ""), got[crop],
                  want, ms, nbytes, inst)
            del got, want, out, buf
        del x


def run_k16(afb, filters):
    """swt_sfb's merges on swt_main's shape (32x3x256^2, db4, the column
    merges reading two bands of a stack in place, the row merge), d = 1,
    2, 4, and the adjoint of each axis at d = 2."""
    w = filters.wavelet("db4")
    g0, g1 = np.asarray(w.rec_lo), np.asarray(w.rec_hi)
    gen = torch.Generator(device="cuda").manual_seed(3)
    stack = torch.randn((32, 3, 4, 256, 256), generator=gen, device="cuda")
    mode, crop = "periodization", slice(0, 2)
    for d in (1, 2, 4):
        for axis in (2, 3):
            lo, hi = ((stack[:, :, 0], stack[:, :, 1]) if axis == 2 else
                      (stack[:, :, 0].contiguous(),
                       stack[:, :, 1].contiguous()))
            inst = _insts(afb.sfb1d_atrous_conv, lambda: afb.sfb1d_atrous_conv(
                lo, hi, g0, g1, mode, axis, d))
            got = afb.sfb1d_atrous_conv(lo, hi, g0, g1, mode, axis, d)
            want = afb.sfb1d_atrous_conv_plain(lo[crop], hi[crop], g0, g1,
                                               mode, axis, d)
            ms = timed_ms(lambda: afb.sfb1d_atrous_conv(lo, hi, g0, g1,
                                                        mode, axis, d))
            _line("swt_sfb", f"d={d} axis {axis}", got[crop], want, ms,
                  12.0 * got.numel(), inst)
            if d == 2:
                dy = lo.contiguous()
                inst = _insts(afb.sfb1d_atrous_adjoint,
                              lambda: afb.sfb1d_atrous_adjoint(
                                  dy, g0, g1, mode, axis, d))
                got = afb.sfb1d_atrous_adjoint(dy, g0, g1, mode, axis, d)
                want = afb.sfb1d_atrous_adjoint_plain(dy[crop], g0, g1,
                                                      mode, axis, d)
                ms = timed_ms(lambda: afb.sfb1d_atrous_adjoint(
                    dy, g0, g1, mode, axis, d))
                _line("swt_sfb_adjoint", f"d={d} axis {axis}", got[crop],
                      want, ms, 12.0 * dy.numel(), inst)
            del got, want


# the scattering paths' K4/K5 calls: (label, bands (N, 6, C, h, w),
# combine): scat's three, the colour layer's three, the small bp layer's
MAG_CASES = (("scat L1", (128, 6, 3, 128, 128), False),
             ("scat L2", (128, 6, 3, 64, 64), False),
             ("scat 2nd order", (128, 6, 18, 64, 64), False),
             ("colour L1 combine", (16, 6, 3, 128, 128), True),
             ("colour L2 combine", (16, 6, 3, 64, 64), True),
             ("colour 2nd order", (16, 6, 6, 64, 64), False),
             ("bp16 L1", (16, 6, 3, 128, 128), False))


def run_mag(mag, backward):
    """K4 (or K5 with ``backward``) on the scattering paths' bands, each
    instantiation (``vector``, then ``strided`` on the same contiguous
    bands) timed against its bytes bound; the cotangent, as torch.cat's
    backward hands it, a plane-contiguous slice of a wider gradient.  A
    tree without instantiations (an older parent) times its wrapper,
    labelled ``parent``."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    bias = 1e-2
    name = "scat_mag_bwd" if backward else "scat_mag_fwd"
    for label, (N, _, C, hh, ww), combine in MAG_CASES:
        h = torch.randn((N, 6, C, hh, ww, 2), generator=gen, device="cuda")
        cout = 1 if combine else C
        G = torch.randn((N, 6 * cout + 1, hh, ww), generator=gen,
                        device="cuda")
        g = G[:, 1:].view(N, 6, cout, hh, ww)
        args = (h, g, bias, combine) if backward else (h, bias, combine)
        plain = getattr(mag, name + "_plain")(*args)
        if hasattr(mag, "mag_instantiation"):
            launch = mag._bwd_launch if backward else mag._fwd_launch
            runs = {inst: (lambda i=inst: launch(*args, i))
                    for inst in mag.MAG_INSTS}
        else:
            runs = {"parent": lambda: getattr(mag, name)(*args)}
        nbytes = 4.0 * ((2 * h.numel() + g.numel()) if backward
                        else h.numel() + plain.numel())
        for inst, run in runs.items():
            got = run()
            ms = timed_ms(run)
            bound = nbytes / 3.35e12 * 1e3
            print(json.dumps({
                "kernel": name, "case": label, "inst": inst, "ms": ms,
                "bound_ms": bound, "share_of_bound": bound / ms,
                "max_abs_err": float((got - plain).abs().max()),
                "ok": bool(torch.allclose(got, plain, rtol=3e-7,
                                          atol=1e-7))}), flush=True)
            del got
        del h, G, g, plain


def k2_calls(tt, quad, fused, lev):
    """(label, [(y, bands, orients, interleaved)]) of K2's calls in one
    forward of each path: main (composed, fp32 and bf16), scat (composed
    ScatLayerj2, fp32 and bf16), bp (per level, the bandpass-diagonal
    filters) and large (per level, 1x3x9216^2, J=3), recorded where the
    pyramids and the level functions call it."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    bp = dict(biort="near_sym_b_bp", qshift="qshift_b_bp")
    for label, shape, dtype, make in (
            ("main", (10, 10, 128, 128), torch.float32,
             lambda: tt.DTCWTForward(J=2, device="cuda")),
            ("main bf16", (10, 10, 128, 128), torch.bfloat16,
             lambda: tt.DTCWTForward(J=2, device="cuda")),
            ("scat", (128, 3, 256, 256), torch.float32,
             lambda: tt.ScatLayerj2(device="cuda")),
            ("scat bf16", (128, 3, 256, 256), torch.bfloat16,
             lambda: tt.ScatLayerj2(device="cuda")),
            ("bp", (128, 3, 256, 256), torch.float32,
             lambda: tt.ScatLayerj2(device="cuda", **bp)),
            ("large", (1, 3, 9216, 9216), torch.float32,
             lambda: tt.DTCWTForward(J=3, device="cuda"))):
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        calls = []
        origs = [(mod, mod.q2c_pack) for mod in (fused, lev)]

        def rec(y, out, orients, interleaved=False, orig=quad.q2c_pack):
            calls.append((y, out, orients, interleaved))
            return orig(y, out, orients, interleaved)
        for mod, _ in origs:
            mod.q2c_pack = rec
        try:
            m = make()
            m(x)
        finally:
            for mod, orig in origs:
                mod.q2c_pack = orig
        torch.cuda.synchronize()
        yield label, calls
        del x, calls, m
        torch.cuda.empty_cache()


def _walk_of(wrapper, run):
    """Run ``run`` once; the instantiation its wrapper counted (``parent``
    for a tree whose wrapper counts none) and the result."""
    before = dict(getattr(wrapper, "instantiations", {}))
    got = run()
    walk = [k for k, v in getattr(wrapper, "instantiations", {}).items()
            if v != before.get(k, 0)]
    return (walk[0] if walk else "parent"), got


def run_k2(tt, quad, fused, lev):
    """K2 on the paths' calls (:func:`k2_calls`), labelled with the
    instantiation the call took (``parent`` for a tree that counts
    none), bit for bit against the plain version computed in fp32 and
    rounded once, against its bytes bound (each corner read once, each
    (re, im) written once) and a ``copy_`` of as many bytes."""
    for label, calls in k2_calls(tt, quad, fused, lev):
        for y, out, orients, il in calls:
            written = [o for pair in orients for o in pair]
            want = torch.zeros(out.shape, device="cuda")
            quad.q2c_pack_plain(y.float(), want, orients, il)
            want = want[:, :, written].to(y.dtype)
            nbytes = y.element_size() * (y.numel() + want.numel())
            # the practical ceiling: a copy of as many bytes each way
            src = torch.empty(y.numel(), device="cuda", dtype=y.dtype)
            dst = torch.empty_like(src)
            copy_ms = timed_ms(lambda: dst.copy_(src))
            del src, dst
            out.fill_(float("nan"))

            def run():
                return quad.q2c_pack(y, out, orients, il)
            inst, _ = _walk_of(quad.q2c_pack, run)
            got = out[:, :, written]
            ms = timed_ms(run)
            bound = nbytes / 3.35e12 * 1e3
            print(json.dumps({
                "kernel": "q2c_pack", "case": label,
                "y": list(y.shape), "dtype": str(y.dtype),
                "interleaved": il, "inst": inst, "ms": ms,
                "bound_ms": bound, "share_of_bound": bound / ms,
                "copy_ms": copy_ms,
                "ok": bool(torch.equal(got, want))}), flush=True)
            del got, want


def _recorded(targets, run):
    """The calls ``run()`` makes to the wrappers named in ``targets``
    ((module, name) pairs, swapped for recording ones): [(name, args,
    kwargs)]."""
    calls, origs = [], []
    for mod, name in targets:
        orig = getattr(mod, name)
        origs.append((mod, name, orig))

        def rec(*args, _name=name, _orig=orig, **kwargs):
            calls.append((_name, args, kwargs))
            return _orig(*args, **kwargs)
        setattr(mod, name, rec)
    try:
        with torch.enable_grad():   # the steps differentiate
            run()
    finally:
        for mod, name, orig in origs:
            setattr(mod, name, orig)
    torch.cuda.synchronize()
    return calls


def _summary(kernel, label, sums):
    for inst, (ms, bound, n) in sums.items():
        print(json.dumps({"kernel": kernel, "summary": label, "inst": inst,
                          "launches": n, "ms": ms, "bound_ms": bound,
                          "share_of_bound": bound / ms}), flush=True)


def k3_paths(tt):
    """(label, dtype, the path's step): main (DTCWT J=2 round trip and
    its x.grad, composed, fp32 and bf16), scat (ScatLayerj2 forward and
    backward, fp32 and bf16), bp (the same with the bandpass-diagonal
    filters: per level) and large (DTCWT J=3 round trip of 1x3x9216^2,
    per level)."""
    bp = dict(biort="near_sym_b_bp", qshift="qshift_b_bp")

    def grad_step(make, shape):
        def step(x):
            f, i = make()
            xg = x.requires_grad_()
            out = f(xg) if i is None else i(f(xg))
            torch.autograd.grad(out, xg, torch.ones_like(out))
        return shape, step

    def round_trip(x):
        f, i = tt.DTCWTForward(J=3, device="cuda"), \
            tt.DTCWTInverse(device="cuda")
        with torch.no_grad():
            i(f(x))
    dt = (lambda: tt.DTCWTForward(J=2, device="cuda"),
          lambda: tt.DTCWTInverse(device="cuda"))
    main = grad_step(lambda: (dt[0](), dt[1]()), (10, 10, 128, 128))
    scat = grad_step(lambda: (tt.ScatLayerj2(device="cuda"), None),
                     (128, 3, 256, 256))
    yield "main", torch.float32, main
    yield "main bf16", torch.bfloat16, main
    yield "scat", torch.float32, scat
    yield "scat bf16", torch.bfloat16, scat
    yield "bp", torch.float32, grad_step(
        lambda: (tt.ScatLayerj2(device="cuda", **bp), None),
        (128, 3, 256, 256))
    yield "large", torch.float32, ((1, 3, 9216, 9216), round_trip)


def run_k3(tt, quad, fused, lev):
    """K3 on the paths' calls (:func:`k3_paths`), labelled with the
    instantiation the call took (``parent`` for a tree that counts none),
    bit for bit against the plain version computed in fp32 and rounded
    once, against its bytes bound (each (re, im) read once, each quadrant
    value written once) and a ``copy_`` of as many bytes; then each
    path's sums."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    for label, dtype, (shape, step) in k3_paths(tt):
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        calls = _recorded([(fused, "c2q_unpack"), (lev, "c2q_unpack")],
                          lambda: step(x))
        sums = {}
        for _, (h, orients, *il), kw in calls:
            il = bool(kw.get("interleaved", il and il[0]))
            h = h.detach()
            want = quad.c2q_unpack_plain(h.float(), orients, il).to(h.dtype)
            nbytes = h.element_size() * 2 * want.numel()
            src = torch.empty(want.numel(), device="cuda", dtype=h.dtype)
            dst = torch.empty_like(src)
            copy_ms = timed_ms(lambda: dst.copy_(src))
            del src, dst

            def run():
                return quad.c2q_unpack(h, orients, il)
            inst, got = _walk_of(quad.c2q_unpack, run)
            ms = timed_ms(run)
            bound = nbytes / 3.35e12 * 1e3
            s = sums.setdefault(inst, [0.0, 0.0, 0])
            s[0] += ms
            s[1] += bound
            s[2] += 1
            print(json.dumps({
                "kernel": "c2q_unpack", "case": label, "h": list(h.shape),
                "stride": list(h.stride()), "dtype": str(h.dtype),
                "interleaved": il, "inst": inst, "ms": ms, "bound_ms": bound,
                "share_of_bound": bound / ms, "copy_ms": copy_ms,
                "ok": bool(torch.equal(got, want))}), flush=True)
            del got, want
        _summary("c2q_unpack", label, sums)
        del x, calls
        torch.cuda.empty_cache()


def run_k11(tt, pool, scat):
    """K11 forward and adjoint on the per-level scattering paths' calls
    (bp: ScatLayerj2 bp on 128x3x256^2; bp16: ScatLayer bp on
    16x3x256^2; bpc: ScatLayerj2 bp combine_colour on 16x3x256^2, forward
    and backward), labelled with the instantiation each took (``parent``
    for a tree that counts none), exactly against the plain versions,
    against the bytes bound (each input read once, each output written
    once), with ``F.avg_pool2d`` beside the forward and, beside the
    adjoint, a broadcasting ``copy_`` of the cotangent into a tensor of
    dx's shape (the same bytes each way, unscaled) and a fill of dx (its
    writes alone); then each path's sums."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(9)
    bp = dict(biort="near_sym_b_bp", qshift="qshift_b_bp")
    for label, shape, make in (
            ("bp", (128, 3, 256, 256),
             lambda: tt.ScatLayerj2(device="cuda", **bp)),
            ("bp16", (16, 3, 256, 256),
             lambda: tt.ScatLayer(device="cuda", biort="near_sym_b_bp")),
            ("bpc", (16, 3, 256, 256),
             lambda: tt.ScatLayerj2(device="cuda", combine_colour=True,
                                    **bp))):
        x = torch.randn(shape, generator=gen, device="cuda")
        m = make()

        def step():
            xg = x.clone().requires_grad_()
            z = m(xg)
            torch.autograd.grad(z, xg, torch.ones_like(z))
        calls = _recorded([(scat, "avg_pool2_fwd"),
                           (scat, "avg_pool2_bwd")], step)
        sums = {}
        for name, (v,), _ in calls:
            v = v.detach()
            kern = getattr(pool, name)
            want = getattr(pool, name + "_plain")(v)
            inst, got = _walk_of(kern, lambda: kern(v))
            ms = timed_ms(lambda: kern(v))
            bound = 4.0 * (v.numel() + want.numel()) / 3.35e12 * 1e3
            line = {"kernel": name, "case": label, "x": list(v.shape),
                    "stride": list(v.stride()), "inst": inst, "ms": ms,
                    "bound_ms": bound, "share_of_bound": bound / ms,
                    "ok": bool(torch.equal(got, want))}
            if name == "avg_pool2_fwd":
                line["library_ms"] = timed_ms(lambda: F.avg_pool2d(v, 2))
            else:
                N, C, h, w = v.shape
                dst = torch.empty((N, C, h, 2, w, 2), device="cuda")
                src = v[:, :, :, None, :, None].expand(dst.shape)
                line["expand_copy_ms"] = timed_ms(lambda: dst.copy_(src))
                # the writes alone: a fill of dx's bytes
                line["fill_ms"] = timed_ms(lambda: dst.fill_(0.25))
                del dst, src
            print(json.dumps(line), flush=True)
            s = sums.setdefault(f"{name} {inst}", [0.0, 0.0, 0])
            s[0] += ms
            s[1] += bound
            s[2] += 1
            del got, want
        _summary("avg_pool2", label, sums)
        del x, m, calls
        torch.cuda.empty_cache()


def run_k13(im):
    """K13's merge and split on swt_long's 'periodization' spectra (rfft
    along H and along W of 1x3x4096^2 planes; and along W of 4094-wide
    planes, whose rows of 2048 values all start on a 16-byte line, no
    value alone), labelled with the walk the
    call took (``parent`` for a tree that counts none), alone against its
    bytes bound and as the whole merge with the irfft after it
    (``with_irfft_ms``: the output layout decides what PyTorch's c2r path
    copies; a tree that counts walks writes the rfft layout, transformed
    along the last dimension of a view as transforms/dwt.py does, the
    parent along dim)."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    n = 4096
    lo, hi = (torch.randn((1, 3, n, n), generator=gen, device="cuda")
              for _ in range(2))
    view = hasattr(im, "SPEC_WALKS")

    def irfft(S, dim, n):
        if not view:
            return torch.fft.irfft(S, n=n, dim=dim)
        return torch.fft.irfft(S.movedim(dim, -1), n=n,
                               dim=-1).movedim(-1, dim)
    for axis, na in ((2, n), (3, n), (3, n - 2)):
        A, B = (torch.fft.rfft(t[..., :na], dim=axis) for t in (lo, hi))
        nf = A.shape[axis]
        g0, g1 = (torch.randn(nf, generator=gen, device="cuda",
                              dtype=torch.complex64) for _ in range(2))
        bound = 24.0 * A.numel() / 3.35e12 * 1e3
        for name, run, want in (
                ("spec_merge", lambda: im.spec_merge(A, B, g0, g1, axis),
                 im.spec_merge_plain(A, B, g0, g1, axis)),
                ("spec_split", lambda: im.spec_split(A, g0, g1, axis),
                 im.spec_split_plain(A, g0, g1, axis))):
            walk, got = _walk_of(getattr(im, name), run)
            err = float((got - want).abs().max())
            d = axis if name == "spec_merge" else axis + 1
            line = {"kernel": name, "case": f"swt_long axis {axis}" + (
                        "" if na == n else f", {na} samples"),
                    "walk": walk, "ms": timed_ms(run), "bound_ms": bound,
                    "max_abs_err": err, "ok": err < 1e-3,
                    "out_strides": list(got.stride()),
                    "with_irfft_ms": timed_ms(lambda: irfft(run(), d, na))}
            line["share_of_bound"] = bound / line["ms"]
            print(json.dumps(line), flush=True)
            del got, want
        del A, B
        torch.cuda.empty_cache()


def sass_counts(cuda, name):
    """Per kernel function of the built library of csrc/``name``.cu
    (``cuobjdump -sass``): its instructions and its integer division
    sequences, 64-bit (``I2F.U64.RP``) and 32-bit (``I2F.U32.RP``)."""
    import re
    tool = str(Path(cuda._nvcc()).with_name("cuobjdump"))
    out = subprocess.run([tool, "-sass", str(cuda._target(name))],
                         capture_output=True, text=True, check=True).stdout
    for part in re.split(r"\n\s*Function : ", out)[1:]:
        fn = part.splitlines()[0].strip()
        body = part.splitlines()[1:]
        instr = [ln for ln in body if re.match(r"\s*/\*[0-9a-f]{4,}\*/", ln)]
        print(json.dumps({
            "sass": name, "function": fn[:120], "instructions": len(instr),
            "div64": sum("I2F.U64.RP" in ln for ln in instr),
            "div32": sum("I2F.U32.RP" in ln for ln in instr)}), flush=True)


def run_k12(afb, filters):
    """The SWT's splits and their adjoints, db4: swt_main's three levels
    (32x3x256^2 'periodization', d = 1, 2, 4: the row split of x or of
    the LL band of the level above's (N, C, 4, H, W) stack read in place,
    the column split of its (N, 2C, H, W) output; the column adjoint of
    the level's (N, 2C, 2, H, W) cotangent, the row adjoint of its
    (N, C, 2, H, W) result) and the two swt_long levels on 1x3x4096^2
    ('periodization', the fft cell) and 1x1x4096^2 ('symmetric', the
    banded cell), d = 1, 2."""
    w = filters.wavelet("db4")
    h0, h1 = (np.asarray(h, np.float64)[::-1].copy()
              for h in (w.dec_lo, w.dec_hi))
    gen = torch.Generator(device="cuda").manual_seed(8)
    crop = slice(0, 1)
    for cell, (N, C, H, W), mode, ds in (
            ("swt", (32, 3, 256, 256), "periodization", (1, 2, 4)),
            ("fft", (1, 3, 4096, 4096), "periodization", (1, 2)),
            ("banded", (1, 1, 4096, 4096), "symmetric", (1, 2))):
        stack = torch.randn((N, C, 4, H, W), generator=gen, device="cuda")
        g2 = stack[:, :, :2].contiguous()
        for d in ds:
            x = stack[:, :, 0] if d > 1 else stack[:, :, 0].contiguous()
            lohi = afb.afb1d_atrous_corr(x, h0, h1, mode, 3, d).reshape(
                N, 2 * C, H, W)
            g = stack.reshape(N, 2 * C, 2, H, W)
            for label, run, plain, inp, wrapper in (
                    ("row", lambda: afb.afb1d_atrous_corr(
                        x, h0, h1, mode, 3, d),
                     lambda: afb.afb1d_atrous_corr_plain(
                         x[crop], h0, h1, mode, 3, d), x,
                     afb.afb1d_atrous_corr),
                    ("col", lambda: afb.afb1d_atrous_corr(
                        lohi, h0, h1, mode, 2, d),
                     lambda: afb.afb1d_atrous_corr_plain(
                         lohi[crop], h0, h1, mode, 2, d), lohi,
                     afb.afb1d_atrous_corr),
                    ("col adjoint", lambda: afb.afb1d_atrous_adjoint(
                        g, h0, h1, mode, 2, d, H),
                     lambda: afb.afb1d_atrous_adjoint_plain(
                         g[crop], h0, h1, mode, 2, d, H), g,
                     afb.afb1d_atrous_adjoint),
                    ("row adjoint", lambda: afb.afb1d_atrous_adjoint(
                        g2, h0, h1, mode, 3, d, W),
                     lambda: afb.afb1d_atrous_adjoint_plain(
                         g2[crop], h0, h1, mode, 3, d, W), g2,
                     afb.afb1d_atrous_adjoint)):
                inst = _insts(wrapper, run)
                got = run()
                ms = timed_ms(run)
                _line(wrapper.__name__, f"{cell} d={d} {label}", got[crop],
                      plain(), ms, 4.0 * (inp.numel() + got.numel()), inst)
                del got
            del x, lohi, g
        del stack, g2


def run_k7(afb, filters):
    """dwt_main's merges (DWT J=3, db4, 'symmetric', 32x10x512^2: the
    column merges of two bands of a level's stack read in place, the row
    merge of their results, at each level's size), dwt1d's row merges
    (16x8 planes of one row) and alt_main's (10 taps, 128x3)."""
    db4, qsa = filters.wavelet("db4"), filters.qshift("qshift_a")
    gen = torch.Generator(device="cuda").manual_seed(4)
    cases = [(f"dwt L{j} {ax}", (32, 10), nin, db4.rec_lo, db4.rec_hi, ax)
             for j, nin in ((3, 70), (2, 133), (1, 259))
             for ax in ("col", "row")]
    cases += [("dwt1d L1 row", (16, 8), 32771, db4.rec_lo, db4.rec_hi,
               "row1d"),
              ("alt L1 col", (128, 3), 128, qsa[2], qsa[6], "col"),
              ("alt L1 row", (128, 3), 128, qsa[2], qsa[6], "row")]
    mode = "symmetric"
    for label, (N, C), nin, g0, g1, ax in cases:
        g0, g1 = (np.asarray(g, np.float64).ravel() for g in (g0, g1))
        L = len(g0)
        if ax == "col":
            stack = torch.randn((N, C, 3, nin, nin), generator=gen,
                                device="cuda")
            lo, hi, axis = stack[:, :, 0], stack[:, :, 1], 2
        elif ax == "row":
            lo, hi = (torch.randn((N, C, 2 * nin - L + 2, nin),
                                  generator=gen, device="cuda")
                      for _ in range(2))
            axis = 3
        else:
            lo, hi = (torch.randn((N, C, 1, nin), generator=gen,
                                  device="cuda") for _ in range(2))
            axis = 3
        inst = _insts(afb.sfb1d_conv, lambda: afb.sfb1d_conv(
            lo, hi, g0, g1, mode, axis))
        got = afb.sfb1d_conv(lo, hi, g0, g1, mode, axis)
        crop = slice(0, 2)
        want = afb.sfb1d_conv_plain(lo[crop], hi[crop], g0, g1, mode, axis)
        ms = timed_ms(lambda: afb.sfb1d_conv(lo, hi, g0, g1, mode, axis))
        _line("dwt_sfb", label, got[crop], want, ms,
              4.0 * (lo.numel() + hi.numel() + got.numel()), inst)
        del got, want, lo, hi


def run_k15(nonsep, filters):
    """nonsep_rt's synthesis and its adjoint (db4 on 32x10x512^2: bands
    of 256^2 in 'periodization', 259^2 in 'symmetric')."""
    w = filters.wavelet("db4")
    f = nonsep.outer_filters(w.rec_lo, w.rec_hi, w.rec_lo, w.rec_hi)
    gen = torch.Generator(device="cuda").manual_seed(5)
    crop = slice(0, 2)
    for mode, n in (("periodization", 256), ("symmetric", 259)):
        c = torch.randn((32, 10, 4, n, n), generator=gen, device="cuda")
        inst = _insts(nonsep.nonsep_sfb, lambda: nonsep.nonsep_sfb(c, f,
                                                                   mode))
        y = nonsep.nonsep_sfb(c, f, mode)
        want = nonsep.nonsep_sfb_plain(c[crop], f, mode)
        ms = timed_ms(lambda: nonsep.nonsep_sfb(c, f, mode))
        nbytes = 4.0 * (c.numel() + y.numel())
        _line("nonsep_sfb", mode, y[crop], want, ms, nbytes, inst)
        g = torch.randn(y.shape, generator=gen, device="cuda")
        inst = _insts(nonsep.nonsep_sfb_adjoint,
                      lambda: nonsep.nonsep_sfb_adjoint(g, f, mode, n, n))
        dc = nonsep.nonsep_sfb_adjoint(g, f, mode, n, n)
        want = nonsep.nonsep_sfb_adjoint_plain(g[crop], f, mode, n, n)
        ms = timed_ms(lambda: nonsep.nonsep_sfb_adjoint(g, f, mode, n, n))
        _line("nonsep_sfb_adjoint", mode, dc[crop], want, ms, nbytes, inst)
        del c, y, g, dc, want


K19_CASES = (   # (label, tile, axis, dtype): chip_smoke.py's K19 tiles
    ("main 10x10x128x64 W", (10, 10, 128, 64), 3, torch.float32),
    ("large 128x3x256x128 W", (128, 3, 256, 128), 3, torch.float32),
    ("large 128x3x128x256 H", (128, 3, 128, 256), 2, torch.float32),
    ("large 128x3x256x128 W bf16", (128, 3, 256, 128), 3, torch.bfloat16))


def run_k19(halo, left=10, right=10):
    """K19's pack, assemble and fold (an interior rank's: halos received
    on both sides) at chip_smoke.py's tiles, each against its plain
    version (exact) and beside torch.cat of the same buffer; where the
    package takes several parts a call, also the two-part exchange of a
    [lo | hi] merge (each half a tile) against two one-part calls."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, tile, axis, dtype in K19_CASES:
        x = torch.randn(tile, generator=gen, device="cuda").to(dtype)
        L = x.shape[axis]
        per = x.numel() // L
        tail, head = x.new_empty(per * left), x.new_empty(per * right)
        rl = torch.randn(per * left, generator=gen, device="cuda").to(dtype)
        rr = torch.randn(per * right, generator=gen, device="cuda").to(dtype)
        shape = list(tile)
        shape[axis] = left + L + right
        win = x.new_empty(shape)
        gw = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        blk_l, blk_r = list(tile), list(tile)
        blk_l[axis], blk_r[axis] = left, right
        calls = {
            "halo_pack": (
                lambda: halo.halo_pack(x, axis, left, right, tail, head),
                lambda: torch.cat([x.narrow(axis, L - left, left)
                                   .reshape(-1),
                                   x.narrow(axis, 0, right).reshape(-1)])),
            "halo_assemble": (
                lambda: halo.halo_assemble(x, axis, left, right, "recv",
                                           "recv", rl, rr, win),
                lambda: torch.cat([rl.view(blk_l), x, rr.view(blk_r)],
                                  dim=axis)),
            "halo_fold": (
                lambda: halo.halo_fold(gw, axis, left, right, "recv", "recv",
                                       rr, rl), None)}
        for name, (kern, lib) in calls.items():
            kern()
            ok = True
            if name == "halo_assemble":
                ok = torch.equal(win, lib())
            elif name == "halo_fold":
                ok = torch.equal(kern(), halo.halo_fold_plain(
                    gw, axis, left, right, "recv", "recv", rr, rl))
            else:
                ok = torch.equal(torch.cat([tail, head]), lib())
            nbytes = x.element_size() * per * (
                2 * (left + right) if name == "halo_pack"
                else 2 * (L + left + right))
            ms = timed_ms(kern)
            print(json.dumps({
                "kernel": "k19", "entry": name, "case": label, "ok": ok,
                "ms": ms, "bound_ms": nbytes / 3.35e12 * 1e3,
                "share_of_bound": nbytes / 3.35e12 * 1e3 / ms,
                "torch_cat_ms": None if lib is None else timed_ms(lib)}),
                flush=True)
        del x, win, gw
    if not hasattr(halo, "part_groups"):
        return
    # a two-part exchange on the main tile: one launch against two
    lo, hi = (torch.randn((10, 10, 128, 32), generator=gen, device="cuda")
              for _ in range(2))
    per = lo.numel() // 32
    send = lo.new_empty(2 * per * (left + right))
    rl = torch.randn(2 * per * left, generator=gen, device="cuda")
    rr = torch.randn(2 * per * right, generator=gen, device="cuda")
    win = lo.new_empty((10, 10, 128, 2 * (32 + left + right)))
    w0, w1 = win.narrow(3, 0, 32 + left + right), win.narrow(
        3, 32 + left + right, 32 + left + right)
    for name, one, two in (
            ("halo_pack",
             lambda: halo.halo_pack([lo, hi], 3, left, right,
                                    send[:2 * per * left],
                                    send[2 * per * left:]),
             lambda: (halo.halo_pack(lo, 3, left, right, send[:per * left],
                                     send[per * left:2 * per * left]),
                      halo.halo_pack(hi, 3, left, right,
                                     send[2 * per * left:
                                          2 * per * left + per * right],
                                     send[2 * per * left + per * right:]))),
            ("halo_assemble",
             lambda: halo.halo_assemble([lo, hi], 3, left, right, "recv",
                                        "recv", rl, rr, win),
             lambda: (halo.halo_assemble(lo, 3, left, right, "recv", "recv",
                                         rl[:per * left], rr[:per * right],
                                         w0),
                      halo.halo_assemble(hi, 3, left, right, "recv", "recv",
                                         rl[per * left:], rr[per * right:],
                                         w1)))):
        print(json.dumps({"kernel": "k19", "entry": name,
                          "case": "two parts 10x10x128x32 W",
                          "one_launch_ms": timed_ms(one),
                          "two_launches_ms": timed_ms(two)}), flush=True)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=None)
    p.add_argument("--only", nargs="+", choices=("k2", "k3", "k4", "k5",
                                                 "k6", "k7", "k8", "k9",
                                                 "k10", "k11", "k12", "k13",
                                                 "k14", "k15", "k16", "k19"),
                   default=None)
    p.add_argument("--merge-tile-out", type=int, default=None)
    p.add_argument("--sass", nargs="+", default=(),
                   help="csrc sources whose built kernels' instructions "
                        "and division sequences to count (cuobjdump)")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("stencil_probe: no CUDA device", file=sys.stderr)
        return 2
    # the checkout this script lies in, unless another is named
    sys.path.insert(0, args.root or str(Path(__file__).resolve().parents[1]))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    import pytorch_wavelets_tpu_torch as tt
    from pytorch_wavelets_tpu_torch import filters
    from pytorch_wavelets_tpu_torch.ops import (
        _cuda, afb_sfb, dtcwt_fb, fused_dtcwt, halo, iswt_merge, nonsep,
        pool, quad, scat_mag,
    )
    from pytorch_wavelets_tpu_torch.transforms import dtcwt as lev
    from pytorch_wavelets_tpu_torch.transforms import scatternet
    _cuda.build()
    if args.merge_tile_out:
        afb_sfb._MERGE_TILE_OUT = args.merge_tile_out
    print(json.dumps({"root": args.root or ".", "package": nonsep.__file__,
                      "merge_tile_out": afb_sfb._MERGE_TILE_OUT}),
          flush=True)
    runs = {"k2": lambda: run_k2(tt, quad, fused_dtcwt, lev),
            "k3": lambda: run_k3(tt, quad, fused_dtcwt, lev),
            "k11": lambda: run_k11(tt, pool, scatternet),
            "k13": lambda: run_k13(iswt_merge),
            "k4": lambda: run_mag(scat_mag, False),
            "k5": lambda: run_mag(scat_mag, True),
            "k6": lambda: run_k6(afb_sfb, filters),
            "k7": lambda: run_k7(afb_sfb, filters),
            "k8": lambda: run_k8(dtcwt_fb, filters),
            "k9": lambda: run_k9(dtcwt_fb, filters),
            "k10": lambda: run_k10(dtcwt_fb, filters),
            "k12": lambda: run_k12(afb_sfb, filters),
            "k14": lambda: run_k14(nonsep, filters),
            "k15": lambda: run_k15(nonsep, filters),
            "k16": lambda: run_k16(afb_sfb, filters),
            "k19": lambda: run_k19(halo)}
    for name in args.sass:
        sass_counts(_cuda, name)
    with torch.no_grad():
        for name, run in runs.items():
            if args.only is None or name in args.only:
                run()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
