#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU: build, check and time.

Run from the root of a checkout, on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. env: card, torch/CUDA versions, TF32 flags (asserted off).
2. build: the hand-written kernels of pytorch_wavelets_tpu_torch/csrc/,
   from the checkout's sources (one nvcc per source, in parallel).
3. main path: DTCWTForward(J=2, near_sym_a, qshift_a) then DTCWTInverse
   on a 10x10x128x128 fp32 batch (torch.Generator seed 0), with every
   kernel's launch count set to 0 just before and read just after;
   checked against the port's own CPU plain run of the same input and
   for perfect reconstruction; timed (CUDA events) in ms and Mpix/s, as
   the caller waits and as device time alone (their ratio is the device
   busy share).
4. banded path: the same at 8x3x512x512, J=3, whose operators have
   short bands, so K1 skips most of their tiles.
5. train_main: the main path with x.requires_grad_() and fixed random
   cotangents on the reconstruction, yl and every yh; x.grad checked
   against the CPU plain run, the adjoint identity <A x, g> = <x, A^T g>
   checked on the card for both pyramids; forward + backward timed; the
   launches counted per step and per pyramid role.
6. scat_j2: ScatLayerj2() on 128x3x256x256 fp32 (the reference's
   published ScatterNet workload): the forward alone, then forward +
   backward (the gradient of sum(Z * G) for a fixed random G); output and
   x.grad checked finite, shaped, and against the CPU plain run on the
   first 8 images; forward / backward ms, Mpix/s and peak memory, beside
   the reference's GTX1080 figures.  Then scat_j2_colour: the same for
   combine_colour=True at 16x3x256x256, checked on its first 4 images.
7. dwt_main: DWTForward(J=3, db4, symmetric) then DWTInverse on
   32x10x512x512 fp32 (benchmarks/run.py:8's --dwt workload, the
   reference's DWT graph setting), checked on its first 4 images against
   the CPU plain run and for perfect reconstruction; Mpix/s as the caller
   waits, device time, busy share, launches per role (K6 analysis, K7
   synthesis), peak memory.  dwt_train: the same modules with the
   gradient of sum(rec * G0) + sum(yl * G1) + sum(yh_j * G2+j) w.r.t. x
   (the reference-semantics backwards: K7, then K6), x.grad checked on the
   first 4 images, and the adjoint identity of both Functions in 'zero'
   mode on the card (the only mode where the reference's backward is the
   true adjoint).  dwt1d: DWT1DForward(J=5, db4, symmetric) + inverse +
   gradient on 16x8x65536, checked the same way.  Then K6/K7 at edge
   cases (odd sizes, db38 at periodization's single-fold sizes, strided
   views as inputs) against their plain versions.
8. per kernel: every kernel call of one run of each path, recorded and
   replayed on the same tensors against its plain PyTorch version (with
   the tolerance stated), timed (device time) beside the plain version
   and one PyTorch library call where one computes the same function,
   with the least time the card could take for the call (bound: bytes
   over HBM rate or FLOPs over the fp32 rate, whichever is larger),
   summed per kernel and per role (forward pyramid, its adjoint B4, the
   inverse's adjoint, the magnitudes; the DWT's analysis, synthesis and
   their backwards).
9. profile: device time by kernel of the main path, of one ScatLayerj2
   training step and of one DWT training step (torch.profiler).

Each path's peak_mem_bytes (torch.cuda.max_memory_allocated over its
timed calls) includes mem_held_before_bytes: what was allocated when its
peak was reset (its inputs, and the calls recorded by earlier paths).

Then a {"kernels": [...]} line, the card's name and power limit as
nvidia-smi prints them, and last {"ok": true, "device": {...}}.
Imports torch, numpy and the port only.
"""
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_FP32_FLOPS = 67e12      # fp32 on the CUDA cores
PEAK_HBM_BYTES = 3.35e12     # HBM3
K1_TOL = dict(rtol=1e-5, atol=1e-5)   # fp32 sums in another order
FWD_ATOL, INV_ATOL = 1e-5, 2e-5       # the JAX suite's DTCWT tolerances
PR_TOL = 1e-5                         # perfect reconstruction
SPIN_CYCLES = 100_000_000   # ~50 ms at ~2 GHz: covers enqueuing a batch

MAG_TOL = dict(rtol=3e-7, atol=1e-7)  # K4/K5: IEEE ops, the same order
GRAD_ATOL = 2e-5                      # the JAX suite's ScatterNet/DTCWT
ADJOINT_TOL = 1e-6                    # fp32 dot-product test, relative
# the reference's published ScatterNet fwd / bwd on (128, 3, 256, 256),
# GTX1080 (BASELINE.md:18, from its docs/scatternet.rst:31-41)
GTX1080_SCAT_S = {"forward": 0.10, "backward": 0.16}
# the paths' inputs (N, C, H, W), and how many images of each ScatLayerj2
# batch the CPU plain run checks
MAIN_SHAPE = (10, 10, 128, 128)        # the reference's DTCWT workload
BANDED_SHAPE = (8, 3, 512, 512)
SCAT_SHAPE = (128, 3, 256, 256)        # the reference's ScatterNet one
COLOUR_SHAPE = (16, 3, 256, 256)
SCAT_CHECK_N, COLOUR_CHECK_N = 8, 4
# (reps, batches) of the ScatLayerj2 timings: the colour step is an
# eighth of the work, so more of both to steady its host-clock times
SCAT_TIMING, COLOUR_TIMING = (3, 5), (10, 15)
PYRAMID_KERNELS = ("apply_row", "apply_col", "q2c_pack", "c2q_unpack")
# the DWT paths: benchmarks/run.py:8 (--dwt --wave db4 -j 3 --size 512
# --batch 32, its defaults --ch 10 and --mode symmetric), and a 1-D run
DWT_SHAPE, DWT_J = (32, 10, 512, 512), 3
DWT1D_SHAPE, DWT1D_J = (16, 8, 65536), 5
DWT_WAVE, DWT_MODE = "db4", "symmetric"
DWT_CHECK_N = 4                       # images checked against the CPU run
DWT_KERNELS = ("afb1d_corr", "sfb1d_conv")
DWT_TOL = K1_TOL                      # K6/K7: fp32 sums in another order
# the role of a K6/K7 call: (kernel, inside the backward) -> role
DWT_ROLES = {("afb1d_corr", False): "analysis",
             ("sfb1d_conv", False): "synthesis",
             ("sfb1d_conv", True): "analysis's backward",
             ("afb1d_corr", True): "synthesis's backward"}

SOURCES = {
    "apply_row": ("banded_apply_row", "banded_apply.cu",
                  "pytorch_wavelets_tpu/ops/banded.py:332"),
    "apply_col": ("banded_apply_col", "banded_apply.cu",
                  "pytorch_wavelets_tpu/ops/banded.py:321"),
    "q2c_pack": ("q2c_pack", "q2c_pack.cu",
                 "pytorch_wavelets_tpu/ops/fused_dtcwt.py:126"),
    "c2q_unpack": ("c2q_unpack", "c2q_unpack.cu",
                   "pytorch_wavelets_tpu/ops/fused_dtcwt.py:290"),
    "scat_mag_fwd": ("scat_mag_fwd", "scat_mag.cu",
                     "pytorch_wavelets_tpu/transforms/scatternet.py:25"),
    "scat_mag_bwd": ("scat_mag_bwd", "scat_mag.cu",
                     "pytorch_wavelets_tpu/transforms/scatternet.py:25"),
    "afb1d_corr": ("dwt_afb", "dwt_afb.cu",
                   "pytorch_wavelets_tpu/ops/afb_sfb.py:125"),
    "sfb1d_conv": ("dwt_sfb", "dwt_sfb.cu",
                   "pytorch_wavelets_tpu/ops/afb_sfb.py:262"),
}
BANDED_REPLACES = "pytorch_wavelets_tpu/ops/banded.py:410"
# the pyramid functions whose kernel calls make up each role, and the JAX
# function each backward role replaces
ROLES = {"_analysis": "forward pyramid", "_synthesis": "inverse pyramid",
         "_analysis_adjoint": "forward pyramid's adjoint (B4)",
         "_synthesis_adjoint": "inverse pyramid's adjoint"}
MAG_ROLE = "magnitudes"
ROLE_REPLACES = {
    "forward pyramid's adjoint (B4)":
        "pytorch_wavelets_tpu/ops/fused_dtcwt.py:224",
    "inverse pyramid's adjoint":
        "pytorch_wavelets_tpu/ops/fused_dtcwt.py:273",
}


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def timed_ms(fn, reps=20, batches=5, device_only=True):
    """Median over batches of the mean CUDA-event time of ``reps``
    back-to-back calls (after a warm-up).  With ``device_only`` the card
    first spins (``torch.cuda._sleep``) while the host enqueues the whole
    batch, so the events time the device work alone, not the host's
    launch rate; without it they time what a caller waits for."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


def shape_str(shape):
    return "x".join(map(str, shape))


def max_err(a, b):
    return float((a.detach().float() - b.detach().float()).abs().max()) \
        if a.numel() else 0.0


def adjoint_error(outs, gs, ins, grads):
    """|<A x, g> - <x, A^T g>| over max(|A x| |g|, |x| |A^T g|), every
    sum in float64: the dot-product test relative to the Cauchy-Schwarz
    scale of its sides, so that products that cancel do not inflate it."""
    def dot(a, b):
        return sum(float((u.detach().double() * v.detach().double()).sum())
                   for u, v in zip(a, b))

    def norm(a):
        return dot(a, a) ** 0.5
    scale = max(norm(outs) * norm(gs), norm(ins) * norm(grads))
    return abs(dot(outs, gs) - dot(ins, grads)) / scale


# ---------------------------------------------------------------------------
# recording the kernel calls of one run
# ---------------------------------------------------------------------------

class Tracer:
    """For one run: wraps the pyramid functions of ROLES and the
    magnitude kernels' wrappers so that each kernel call is tagged with
    the role it serves, and each wrapper's own launch counter is read at
    the role's start and end (launches per role).  With ``record`` it
    also swaps the kernel wrappers that the pyramids and the magnitudes
    call for recording ones, which keep each call's inputs for replay."""

    def __init__(self, ops, fused, scat, record=False):
        self.ops, self.fused, self.scat, self.record = (ops, fused, scat,
                                                        record)
        self.role = None
        self.calls = []
        self.by_role = {}
        self.saved = []

    def _swap(self, module, name, fn):
        self.saved.append((module, name, getattr(module, name)))
        setattr(module, name, fn)

    def _tag(self, role, fn):
        def wrapped(*args, **kwargs):
            prev, self.role = self.role, role
            before = self.ops.launch_counts()
            try:
                return fn(*args, **kwargs)
            finally:
                after = self.ops.launch_counts()
                c = self.by_role.setdefault(role, {})
                for k, v in after.items():
                    c[k] = c.get(k, 0) + v - before[k]
                self.role = prev
        return wrapped

    def __enter__(self):
        for name, role in ROLES.items():
            self._swap(self.fused, name, self._tag(role,
                                                   getattr(self.fused, name)))
        for name in ("scat_mag_fwd", "scat_mag_bwd"):
            self._swap(self.scat, name, self._tag(MAG_ROLE,
                                                  getattr(self.scat, name)))
        if not self.record:
            return self
        calls, f, m = self.calls, self.fused, self.scat
        orig = {n: getattr(f, n) for n in ("apply_row", "apply_col",
                                           "q2c_pack", "c2q_unpack")}
        orig.update({n: getattr(m, n) for n in ("scat_mag_fwd",
                                                "scat_mag_bwd")})

        def apply_row(x, T):
            calls.append(("apply_row", self.role, (x, T)))
            return orig["apply_row"](x, T)

        def apply_col(x, T, out=None, accumulate=True):
            mode = (None if out is None else ("acc", out.clone())
                    if accumulate else ("write", out.size(), out.stride()))
            calls.append(("apply_col", self.role, (x, T, mode)))
            return orig["apply_col"](x, T, out, accumulate)

        def q2c_pack(y, out, orients):
            calls.append(("q2c_pack", self.role,
                          (y, out.size(), out.stride(), orients)))
            return orig["q2c_pack"](y, out, orients)

        def c2q_unpack(h, orients):
            calls.append(("c2q_unpack", self.role, (h, orients)))
            return orig["c2q_unpack"](h, orients)

        def scat_mag_fwd(h, bias, combine=False):
            calls.append(("scat_mag_fwd", MAG_ROLE, (h, bias, combine)))
            return orig["scat_mag_fwd"](h, bias, combine)

        def scat_mag_bwd(h, g, bias, combine=False):
            calls.append(("scat_mag_bwd", MAG_ROLE, (h, g, bias, combine)))
            return orig["scat_mag_bwd"](h, g, bias, combine)

        for name, fn in (("apply_row", apply_row), ("apply_col", apply_col),
                         ("q2c_pack", q2c_pack), ("c2q_unpack", c2q_unpack)):
            self._swap(f, name, fn)
        self._swap(m, "scat_mag_fwd", scat_mag_fwd)
        self._swap(m, "scat_mag_bwd", scat_mag_bwd)
        return self

    def __exit__(self, *exc):
        for module, name, fn in reversed(self.saved):
            setattr(module, name, fn)


class DwtRecorder:
    """For one run: swaps the K6/K7 wrappers (``afb1d_corr``,
    ``sfb1d_conv``) where the DWT Functions and the 2-D compositions call
    them for recording ones, which keep each call's inputs for replay and
    tag it with its role; the caller sets ``backward`` around the
    gradient."""

    def __init__(self, afb, dwt):
        self.modules = (afb, dwt)
        self.calls = []
        self.backward = False
        self.saved = []

    def __enter__(self):
        afb = self.modules[0]
        orig_a, orig_s = afb.afb1d_corr, afb.sfb1d_conv

        def afb1d_corr(x, h0, h1, mode, axis, out_len=None):
            self.calls.append(("afb1d_corr",
                               DWT_ROLES[("afb1d_corr", self.backward)],
                               (x, h0, h1, mode, axis % 4, out_len)))
            return orig_a(x, h0, h1, mode, axis, out_len)

        def sfb1d_conv(lo, hi, g0, g1, mode, axis, out_len=None):
            self.calls.append(("sfb1d_conv",
                               DWT_ROLES[("sfb1d_conv", self.backward)],
                               (lo, hi, g0, g1, mode, axis % 4, out_len)))
            return orig_s(lo, hi, g0, g1, mode, axis, out_len)

        for module in self.modules:
            for name, fn in (("afb1d_corr", afb1d_corr),
                             ("sfb1d_conv", sfb1d_conv)):
                self.saved.append((module, name, getattr(module, name)))
                setattr(module, name, fn)
        return self

    def __exit__(self, *exc):
        for module, name, fn in reversed(self.saved):
            setattr(module, name, fn)


def dwt_call_parts(call, afb, pad):
    """One recorded K6/K7 call: (got, want, run, plain, lib, ops, bytes).
    ``lib`` is cuDNN on the same work where one call does it: for K6
    ``F.conv2d`` of the padded input (padded here, not timed) with the
    two taps stacked, stride 2 along the axis; for K7 ``F.conv_transpose2d``
    of (lo, hi) as two channels (stacked here), stride 2, outside
    'periodization' (whose wrap-add no single call does); else None."""
    import torch.nn.functional as F
    name, _, args = call
    if name == "afb1d_corr":
        x, h0, h1, mode, axis, out_len = args
        got = afb.afb1d_corr(x, h0, h1, mode, axis, out_len)

        def plain():
            y = afb.afb1d_corr_plain(x, h0, h1, mode, axis)
            return y if out_len is None else y.narrow(axis + 1, 0, out_len)
        run = lambda: afb.afb1d_corr(x, h0, h1, mode, axis,   # noqa: E731
                                     out_len)
        L, n = len(h0), x.shape[axis]
        _, front, ne, pmode, shift, fold = afb.afb_plan(n, L, mode)
        lib = None
        if shift == 0 and fold == 0:
            q = 2 * (got.shape[axis + 1] - 1) + L
            idx = pad.pad_index(ne, front, max(q - front - ne, 0), pmode)[:q]
            xp = torch.index_select(x, axis, torch.as_tensor(
                np.clip(idx, 0, n - 1), device=x.device))
            if (idx < 0).any():
                shape = [1] * 4
                shape[axis] = q
                xp = xp * torch.as_tensor(idx >= 0, device=x.device,
                                          dtype=x.dtype).view(shape)
            N, C = x.shape[:2]
            xp = xp.reshape(N * C, 1, *xp.shape[2:]).contiguous()
            w = torch.tensor(np.stack([h0, h1]), dtype=torch.float32,
                             device=x.device)
            w = w.view(2, 1, 1, L) if axis == 3 else w.view(2, 1, L, 1)
            stride = (1, 2) if axis == 3 else (2, 1)
            lib = lambda: F.conv2d(xp, w, stride=stride)      # noqa: E731
        ops = 2.0 * L * got.numel()
        nbytes = 4.0 * (x.numel() + got.numel())
    else:
        lo, hi, g0, g1, mode, axis, out_len = args
        got = afb.sfb1d_conv(lo, hi, g0, g1, mode, axis, out_len)

        def plain():
            y = afb.sfb1d_conv_plain(lo, hi, g0, g1, mode, axis)
            return y if out_len is None else y.narrow(axis, 0, out_len)
        run = lambda: afb.sfb1d_conv(lo, hi, g0, g1, mode,   # noqa: E731
                                     axis, out_len)
        L = len(g0)
        lib = None
        if mode not in ("per", "periodization") and L >= 2:
            N, C, H, W = lo.shape
            xin = torch.stack([lo, hi], dim=2).reshape(N * C, 2, H, W)
            w = torch.tensor(np.stack([g0, g1]), dtype=torch.float32,
                             device=lo.device)
            w = w.view(2, 1, 1, L) if axis == 3 else w.view(2, 1, L, 1)
            stride, padding = (((1, 2), (0, L - 2)) if axis == 3
                               else ((2, 1), (L - 2, 0)))
            lib = lambda: F.conv_transpose2d(                 # noqa: E731
                xin, w, stride=stride, padding=padding)
        ops = 2.0 * L * got.numel()
        nbytes = 4.0 * (lo.numel() + hi.numel() + got.numel())
    want = plain()
    if lib is not None:   # the yardstick computes the same function
        ax = axis + 1 if name == "afb1d_corr" else axis
        ref = lib().reshape(*want.shape[:ax], -1, *want.shape[ax + 1:])
        require(torch.allclose(ref.narrow(ax, 0, want.shape[ax]), want,
                               **DWT_TOL),
                f"{name}: the library yardstick differs from the plain "
                f"version")
    return got, want, run, plain, lib, ops, nbytes


def replay(call, banded, quad, mag, afb, pad):
    """Check one recorded call against its plain version and time it.
    Returns (err, ms, plain_ms, library_ms, bound_ms, op_t, byte_t)."""
    name, _, args = call
    lib = None
    if name in DWT_KERNELS:
        got, want, run, plain, lib, ops, nbytes = dwt_call_parts(call, afb,
                                                                 pad)
        tol = DWT_TOL
    elif name == "apply_row":
        x, T = args
        Td = T.T
        N, C, H, K = x.shape
        got = banded.apply_row(x, T)
        want = banded.apply_row_plain(x, T)
        run = lambda: banded.apply_row(x, T)                  # noqa: E731
        plain = lambda: banded.apply_row_plain(x, T)          # noqa: E731
        lib = lambda: torch.matmul(x, Td.t())                 # noqa: E731
        ops = 2.0 * T.nnz * N * C * H
        nbytes = 4.0 * (x.numel() + Td.numel() + got.numel())
        tol = K1_TOL
    elif name == "apply_col":
        x, T, mode = args
        Td = T.T
        N, C, K, Wc = x.shape
        kind = mode[0] if mode else None
        if kind is None:
            got = banded.apply_col(x, T)
            want = banded.apply_col_plain(x, T)
            run = lambda: banded.apply_col(x, T)              # noqa: E731
            plain = lambda: banded.apply_col_plain(x, T)      # noqa: E731
            lib = lambda: torch.matmul(Td, x)                 # noqa: E731
        elif kind == "acc":
            out = mode[1]
            got = banded.apply_col(x, T, out.clone())
            want = banded.apply_col_plain(x, T, out)
            buf = out.clone()
            run = lambda: banded.apply_col(x, T, buf)         # noqa: E731
            plain = lambda: banded.apply_col_plain(x, T, out)  # noqa: E731
            lib = lambda: torch.matmul(Td, x).add_(out)       # noqa: E731
        else:   # written through the strides of a view (B4's dz blocks)
            buf = torch.empty_strided(mode[1], mode[2], device=x.device)
            pbuf = torch.empty_strided(mode[1], mode[2], device=x.device)
            got = banded.apply_col(x, T, buf, accumulate=False)
            want = banded.apply_col_plain(x, T)
            run = lambda: banded.apply_col(x, T, buf,         # noqa: E731
                                           accumulate=False)
            plain = lambda: banded.apply_col_plain(           # noqa: E731
                x, T, pbuf, accumulate=False)
            lib = lambda: torch.matmul(Td, x)                 # noqa: E731
        ops = 2.0 * T.nnz * N * C * Wc
        nbytes = 4.0 * (x.numel() + Td.numel() + got.numel()
                        * (2 if kind == "acc" else 1))
        tol = K1_TOL
    elif name == "q2c_pack":
        y, size, stride, orients = args
        got = torch.empty_strided(size, stride, device=y.device)
        want = torch.empty_strided(size, stride, device=y.device)
        quad.q2c_pack(y, got, orients)
        quad.q2c_pack_plain(y, want, orients)
        written = [o for pair in orients for o in pair]  # orientations filled
        got, want = got[:, :, written], want[:, :, written]
        buf = torch.empty_strided(size, stride, device=y.device)
        run = lambda: quad.q2c_pack(y, buf, orients)          # noqa: E731
        plain = lambda: quad.q2c_pack_plain(y, buf, orients)  # noqa: E731
        ops = 1.0 * got.numel()           # one add or subtract per value
        nbytes = 4.0 * (y.numel() + got.numel())
        tol = "exact"
    elif name == "c2q_unpack":
        h, orients = args
        got = quad.c2q_unpack(h, orients)
        want = quad.c2q_unpack_plain(h, orients)
        run = lambda: quad.c2q_unpack(h, orients)             # noqa: E731
        plain = lambda: quad.c2q_unpack_plain(h, orients)     # noqa: E731
        ops = 1.0 * got.numel()
        nbytes = 4.0 * 2 * got.numel()    # each read once, each written once
        tol = "exact"
    elif name == "scat_mag_fwd":
        h, bias, combine = args
        got = mag.scat_mag_fwd(h, bias, combine)
        want = mag.scat_mag_fwd_plain(h, bias, combine)
        run = lambda: mag.scat_mag_fwd(h, bias, combine)      # noqa: E731
        plain = lambda: mag.scat_mag_fwd_plain(               # noqa: E731
            h, bias, combine)
        ops = 2.0 * h.numel() + 3.0 * got.numel()
        nbytes = 4.0 * (h.numel() + got.numel())
        tol = MAG_TOL
    else:
        h, g, bias, combine = args
        got = mag.scat_mag_bwd(h, g, bias, combine)
        want = mag.scat_mag_bwd_plain(h, g, bias, combine)
        run = lambda: mag.scat_mag_bwd(h, g, bias, combine)   # noqa: E731
        plain = lambda: mag.scat_mag_bwd_plain(               # noqa: E731
            h, g, bias, combine)
        ops = 4.0 * h.numel() + 2.0 * g.numel()
        nbytes = 4.0 * (2 * h.numel() + g.numel())
        tol = MAG_TOL
    if tol == "exact":
        ok = torch.equal(got, want)
    else:
        ok = torch.allclose(got, want, equal_nan=True, **tol)
    require(ok, f"{name} {tuple(args[0].shape)} disagrees with its plain "
            f"version by {max_err(got, want)}")
    op_t, byte_t = ops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return (max_err(got, want), timed_ms(run), timed_ms(plain),
            None if lib is None else timed_ms(lib), max(op_t, byte_t), op_t,
            byte_t)


def kernel_rows(groups, banded, quad, mag, afb, pad):
    """One row per group (name, replaces, launches, calls): the replays of
    its calls summed; ``per_call`` lists [input shape (by operator
    shape), ms, plain_ms, library_ms, bound_ms] for each call."""
    rows = []
    for name, replaces, launches, calls in groups:
        a = dict(err=0.0, ms=0.0, plain=0.0, lib=0.0, bound=0.0, op=0.0,
                 byte=0.0, haslib=True, per_call=[])
        for call in calls:
            err, ms, plain_ms, lib_ms, bound, op_t, byte_t = replay(
                call, banded, quad, mag, afb, pad)
            a["err"] = max(a["err"], err)
            a["ms"] += ms
            a["plain"] += plain_ms
            a["haslib"] &= lib_ms is not None
            a["lib"] += lib_ms or 0.0
            a["bound"] += bound
            a["op"] += op_t
            a["byte"] += byte_t
            shape = "x".join(map(str, call[2][0].shape))
            if call[0].startswith("apply"):
                shape += " by " + "x".join(map(str, call[2][1].shape))
            elif call[0] in DWT_KERNELS:
                shape += f" axis {call[2][-2]}"
            a["per_call"].append([shape, ms, plain_ms, lib_ms, bound])
        kernel = calls[0][0]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"pytorch_wavelets_tpu_torch/csrc/"
                      f"{SOURCES[kernel][1]}",
            "replaces": replaces, "launches": launches,
            "max_abs_err": a["err"],
            "tolerance": ("exact" if kernel in ("q2c_pack", "c2q_unpack")
                          else MAG_TOL if kernel.startswith("scat_mag")
                          else DWT_TOL if kernel in DWT_KERNELS
                          else K1_TOL),
            "ms": a["ms"], "plain_ms": a["plain"],
            "bound_ms": a["bound"],
            "bound_by": "bytes" if a["byte"] >= a["op"] else "operations",
            "library_ms": a["lib"] if a["haslib"] else None,
            "per_call": a["per_call"]})
    return rows


def role_groups(calls, by_role, roles, label):
    """Groups for :func:`kernel_rows`: per role of ``roles`` and per
    kernel, the calls of that role, named after the path and role."""
    groups = []
    for role in roles:
        for kernel in SOURCES:
            mine = [c for c in calls if c[0] == kernel and c[1] == role]
            if mine:
                groups.append((
                    f"{SOURCES[kernel][0]} ({label}: {role})",
                    ROLE_REPLACES.get(role, SOURCES[kernel][2]),
                    by_role[role][kernel], mine))
    return groups


# ---------------------------------------------------------------------------
# the paths
# ---------------------------------------------------------------------------

def drive(tt, ops, fused, scat, shape, J, phase):
    """One path: CPU plain reference, counted GPU run, checks, timing, and
    the recorded kernel calls.  Returns (counts, calls, fields)."""
    N, C, H, W = shape
    x_cpu = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    t0 = time.perf_counter()
    ref_yl, ref_yh = tt.DTCWTForward(J=J, device="cpu")(x_cpu)
    ref_rec = tt.DTCWTInverse(device="cpu")((ref_yl, ref_yh))
    cpu_s = time.perf_counter() - t0

    fwd = tt.DTCWTForward(J=J, device="cuda")
    inv = tt.DTCWTInverse(device="cuda")
    x = x_cpu.cuda()
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ops.reset_launches()
        yl, yh = fwd(x)
        rec = inv((yl, yh))
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        first_s = time.perf_counter() - t0
        require(all(counts[k] > 0 for k in PYRAMID_KERNELS),
                f"{phase}: a kernel of the path never launched: {counts}")
        outs = [yl, *yh]
        require(all(bool(torch.isfinite(o).all()) for o in outs + [rec]),
                f"{phase}: non-finite output")
        require(tuple(rec.shape) == shape and tuple(yl.shape) ==
                tuple(ref_yl.shape), f"{phase}: wrong output shapes")
        fwd_err = max(max_err(a.cpu(), b) for a, b in
                      zip(outs, [ref_yl, *ref_yh]))
        inv_err = max_err(rec.cpu(), ref_rec)
        pr_err = max_err(rec, x)
        require(fwd_err <= FWD_ATOL and inv_err <= INV_ATOL,
                f"{phase}: GPU differs from the CPU plain run: forward "
                f"{fwd_err}, inverse {inv_err}")
        require(pr_err <= PR_TOL, f"{phase}: reconstruction error {pr_err}")

        # host-clock-bound times vary from batch to batch on a shared
        # host: more batches, and the median
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        both_ms = timed_ms(lambda: inv(fwd(x)), reps=10, batches=15,
                           device_only=False)
        peak = torch.cuda.max_memory_allocated()
        both_dev_ms = timed_ms(lambda: inv(fwd(x)), reps=10)
        fwd_ms = timed_ms(lambda: fwd(x), reps=10, batches=15,
                          device_only=False)
        inv_ms = timed_ms(lambda: inv((yl, yh)), reps=10, batches=15,
                          device_only=False)
        with Tracer(ops, fused, scat, record=True) as r:
            inv(fwd(x))
        torch.cuda.synchronize()
    fields = dict(
        shape=list(shape), J=J, launches=counts,
        max_abs_err_vs_cpu={"forward": fwd_err, "inverse": inv_err},
        tolerance={"forward": FWD_ATOL, "inverse": INV_ATOL},
        reconstruction_err=pr_err, reconstruction_tol=PR_TOL,
        first_call_s=first_s, fwd_inv_ms=both_ms, fwd_ms=fwd_ms,
        inv_ms=inv_ms, mpix_per_s=N * C * H * W / 1e6 / (both_ms / 1e3),
        fwd_inv_device_ms=both_dev_ms,
        device_busy_share=both_dev_ms / both_ms,
        peak_mem_bytes=peak, mem_held_before_bytes=held,
        cpu_reference_s=cpu_s)
    return counts, r.calls, fields


def train_main(tt, ops, fused, scat, shape, J):
    """DTCWT forward -> inverse with gradients: the gradient of
    sum(rec * G0) + sum(yl * G1) + sum(yh_j * G2+j) w.r.t. x, for fixed
    random cotangents G.  Returns (fields, launches per role, calls)."""
    N, C, H, W = shape
    x_cpu = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    fwd_c = tt.DTCWTForward(J=J, device="cpu")
    inv_c = tt.DTCWTInverse(device="cpu")

    def step(fwd, inv, x, cts):
        yl, yh = fwd(x)
        outs = [inv((yl, yh)), yl, *yh]
        return outs, torch.autograd.grad(outs, x, cts)[0]

    with torch.no_grad():
        yl, yh = fwd_c(x_cpu)
    cts_cpu = [torch.randn(t.shape, generator=torch.Generator()
                           .manual_seed(1 + k))
               for k, t in enumerate([x_cpu, yl, *yh])]
    t0 = time.perf_counter()
    _, ref_grad = step(fwd_c, inv_c, x_cpu.clone().requires_grad_(),
                       cts_cpu)
    cpu_s = time.perf_counter() - t0

    fwd = tt.DTCWTForward(J=J, device="cuda")
    inv = tt.DTCWTInverse(device="cuda")
    x = x_cpu.cuda().requires_grad_()
    cts = [c.cuda() for c in cts_cpu]
    with Tracer(ops, fused, scat) as tr:
        torch.cuda.synchronize()
        ops.reset_launches()
        yl, yh = fwd(x)
        outs = [inv((yl, yh)), yl, *yh]
        fwd_counts = ops.launch_counts()
        grad = torch.autograd.grad(outs, x, cts)[0]
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    bwd_counts = {k: counts[k] - fwd_counts[k] for k in counts}
    require(all(fwd_counts[k] > 0 and bwd_counts[k] > 0
                for k in PYRAMID_KERNELS),
            f"train_main: a kernel of the path never launched: forward "
            f"{fwd_counts}, backward {bwd_counts}")
    require(bool(torch.isfinite(grad).all()) and tuple(grad.shape) == shape,
            "train_main: x.grad is not finite or has the wrong shape")
    grad_err = max_err(grad.cpu(), ref_grad)
    require(grad_err <= GRAD_ATOL, f"train_main: x.grad differs from the "
            f"CPU plain run by {grad_err}")

    # the adjoint identity of both pyramids, on the card
    yl, yh = fwd(x)
    fouts = [yl, *yh]
    fgrad = torch.autograd.grad(fouts, x, cts[1:])[0]
    adj_fwd = adjoint_error(fouts, cts[1:], [x], [fgrad])
    leaves = [t.detach().requires_grad_() for t in fouts]
    rec = inv((leaves[0], leaves[1:]))
    igrads = torch.autograd.grad(rec, leaves, cts[0])
    adj_inv = adjoint_error([rec], cts[:1], leaves, igrads)
    require(adj_fwd <= ADJOINT_TOL and adj_inv <= ADJOINT_TOL,
            f"train_main: adjoint identity off by {adj_fwd} (forward), "
            f"{adj_inv} (inverse)")

    run = lambda: step(fwd, inv, x, cts)                      # noqa: E731
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step_ms = timed_ms(run, reps=10, batches=15, device_only=False)
    peak = torch.cuda.max_memory_allocated()
    step_dev_ms = timed_ms(run, reps=10)
    with Tracer(ops, fused, scat, record=True) as rec_tr:
        run()
    torch.cuda.synchronize()
    fields = dict(
        shape=list(shape), J=J,
        launches={"forward": fwd_counts, "backward": bwd_counts},
        launches_by_role=tr.by_role,
        max_abs_err_grad_vs_cpu=grad_err, tolerance=GRAD_ATOL,
        adjoint_rel_err={"forward pyramid": adj_fwd,
                         "inverse pyramid": adj_inv},
        adjoint_tol=ADJOINT_TOL,
        fwd_bwd_ms=step_ms, fwd_bwd_device_ms=step_dev_ms,
        device_busy_share=step_dev_ms / step_ms,
        mpix_per_s=N * C * H * W / 1e6 / (step_ms / 1e3),
        peak_mem_bytes=peak, mem_held_before_bytes=held,
        cpu_reference_s=cpu_s)
    return fields, tr.by_role, rec_tr.calls


def scat_step(tt, ops, fused, scat, shape, check_n, phase, timing, **kw):
    """ScatLayerj2(**kw) forward alone, then forward + backward (the
    gradient of sum(Z * G) for a fixed random G, as grad_outputs), against
    the CPU plain run on the first ``check_n`` images (images are
    independent, so that part is exact).  Returns (fields, launches per
    role, calls of one recorded step).  ``timing`` is (reps, batches)
    for :func:`timed_ms`."""
    N, C, H, W = shape
    x_cpu = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    cout = 51 if kw.get("combine_colour") else 49 * C
    G_cpu = torch.randn((N, cout, H // 4, W // 4),
                        generator=torch.Generator().manual_seed(1))
    t0 = time.perf_counter()
    xc = x_cpu[:check_n].clone().requires_grad_()
    z_ref = tt.ScatLayerj2(device="cpu", **kw)(xc)
    g_ref = torch.autograd.grad(z_ref, xc, G_cpu[:check_n])[0]
    cpu_s = time.perf_counter() - t0

    m = tt.ScatLayerj2(device="cuda", **kw)
    x = x_cpu.cuda().requires_grad_()
    G = G_cpu.cuda()
    with Tracer(ops, fused, scat) as tr:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ops.reset_launches()
        z = m(x)
        fwd_counts = ops.launch_counts()
        grad = torch.autograd.grad(z, x, G)[0]
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        first_s = time.perf_counter() - t0
    bwd_counts = {k: counts[k] - fwd_counts[k] for k in counts}
    need_fwd = ("apply_row", "apply_col", "q2c_pack", "scat_mag_fwd")
    need_bwd = ("apply_row", "apply_col", "c2q_unpack", "scat_mag_bwd")
    require(all(fwd_counts[k] > 0 for k in need_fwd)
            and all(bwd_counts[k] > 0 for k in need_bwd),
            f"{phase}: a kernel of the path never launched: forward "
            f"{fwd_counts}, backward {bwd_counts}")
    require(tuple(z.shape) == tuple(G.shape) and tuple(grad.shape) == shape,
            f"{phase}: wrong shapes {tuple(z.shape)}, {tuple(grad.shape)}")
    require(bool(torch.isfinite(z).all()) and bool(torch.isfinite(grad)
                                                  .all()),
            f"{phase}: non-finite output or gradient")
    z_err = max_err(z[:check_n].detach().cpu(), z_ref.detach())
    g_err = max_err(grad[:check_n].cpu(), g_ref)
    require(z_err <= GRAD_ATOL and g_err <= GRAD_ATOL,
            f"{phase}: GPU differs from the CPU plain run on the first "
            f"{check_n} images: output {z_err}, x.grad {g_err}")
    fields = dict(
        shape=list(shape), options=kw,
        launches={"forward": fwd_counts, "backward": bwd_counts},
        launches_by_role=tr.by_role, checked_images=check_n,
        max_abs_err_vs_cpu={"output": z_err, "x_grad": g_err},
        tolerance=GRAD_ATOL, first_step_s=first_s, cpu_reference_s=cpu_s)
    del z, grad
    step = lambda: torch.autograd.grad(m(x), x, G)            # noqa: E731
    reps, batches = timing
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step_ms = timed_ms(step, reps=reps, batches=batches, device_only=False)
    peak = torch.cuda.max_memory_allocated()
    step_dev_ms = timed_ms(step, reps=reps, batches=batches)
    fwd_ms = timed_ms(lambda: m(x), reps=reps, batches=batches,
                      device_only=False)
    with torch.no_grad():
        infer_ms = timed_ms(lambda: m(x), reps=reps, batches=batches,
                            device_only=False)
    z = m(x)
    bwd_ms = timed_ms(lambda: torch.autograd.grad(z, x, G,
                                                  retain_graph=True),
                      reps=reps, batches=batches, device_only=False)
    del z
    with Tracer(ops, fused, scat, record=True) as rec_tr:
        step()
    torch.cuda.synchronize()
    mpix = N * C * H * W / 1e6
    fields.update(
        fwd_ms=fwd_ms, bwd_ms=bwd_ms, fwd_bwd_ms=step_ms,
        fwd_bwd_device_ms=step_dev_ms, device_busy_share=step_dev_ms /
        step_ms, fwd_no_grad_ms=infer_ms,
        mpix_per_s={"forward": mpix / (fwd_ms / 1e3),
                    "fwd_bwd": mpix / (step_ms / 1e3)},
        timing_reps_batches=[reps, batches], peak_mem_bytes=peak,
        mem_held_before_bytes=held)
    return fields, tr.by_role, rec_tr.calls


def dwt_adjoint(tt, x_cpu, J, one_d):
    """The dot-product test of both DWT Functions on the card in 'zero'
    mode, where the reference's backward is the true adjoint (in the
    other modes it ignores the boundary fold).  Returns (forward,
    inverse) relative errors."""
    fcls, icls = ((tt.DWT1DForward, tt.DWT1DInverse) if one_d
                  else (tt.DWTForward, tt.DWTInverse))
    f = fcls(J=J, wave=DWT_WAVE, mode="zero", device="cuda")
    i = icls(wave=DWT_WAVE, mode="zero", device="cuda")
    x = x_cpu.cuda().requires_grad_()
    yl, yh = f(x)
    outs = [yl, *yh]
    gs = [torch.randn(o.shape, generator=torch.Generator().manual_seed(
        50 + k)).cuda() for k, o in enumerate(outs)]
    gx = torch.autograd.grad(outs, x, gs)[0]
    adj_f = adjoint_error(outs, gs, [x], [gx])
    leaves = [o.detach().requires_grad_() for o in outs]
    rec = i((leaves[0], leaves[1:]))
    g = torch.randn(rec.shape, generator=torch.Generator().manual_seed(
        60)).cuda()
    grads = torch.autograd.grad(rec, leaves, g)
    return adj_f, adjoint_error([rec], [g], leaves, grads)


def dwt_path(tt, ops, afb, dwt, shape, J, one_d, phase):
    """A DWT path (2-D, or 1-D with ``one_d``): forward + inverse, counted,
    checked against the CPU plain run on the first DWT_CHECK_N items and
    for perfect reconstruction, timed; then the training step (the
    gradient of sum(rec * G0) + sum(yl * G1) + sum(yh_j * G2+j) w.r.t. x
    for fixed random G), counted, x.grad checked, timed, and one step
    recorded; the adjoint identity in 'zero' mode.  Returns (fields of
    the forward + inverse, fields of the training step, launches per
    role, recorded calls, the step)."""
    fcls, icls = ((tt.DWT1DForward, tt.DWT1DInverse) if one_d
                  else (tt.DWTForward, tt.DWTInverse))
    kw = dict(wave=DWT_WAVE, mode=DWT_MODE)
    n = DWT_CHECK_N
    x_cpu = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    t0 = time.perf_counter()
    fc, ic = fcls(J=J, device="cpu", **kw), icls(device="cpu", **kw)
    xc = x_cpu[:n].clone().requires_grad_()
    yl, yh = fc(xc)
    outs = [ic((yl, yh)), yl, *yh]
    ref = [o.detach() for o in outs]
    cts_cpu = [torch.randn((shape[0], *o.shape[1:]), generator=torch
                           .Generator().manual_seed(1 + k))
               for k, o in enumerate(outs)]
    ref_grad = torch.autograd.grad(outs, xc, [c[:n] for c in cts_cpu])[0]
    cpu_s = time.perf_counter() - t0
    del yl, yh, outs

    f, i = fcls(J=J, device="cuda", **kw), icls(device="cuda", **kw)
    x = x_cpu.cuda()
    cts = [c.cuda() for c in cts_cpu]
    mpix = x.numel() / 1e6
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ops.reset_launches()
        yl, yh = f(x)
        fwd_counts = ops.launch_counts()
        rec = i((yl, yh))
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        first_s = time.perf_counter() - t0
        inv_counts = {k: counts[k] - fwd_counts[k] for k in counts}
        require(fwd_counts["afb1d_corr"] > 0 and inv_counts["sfb1d_conv"] > 0,
                f"{phase}: a kernel of the path never launched: forward "
                f"{fwd_counts}, inverse {inv_counts}")
        outs = [yl, *yh]
        require(all(bool(torch.isfinite(o).all()) for o in outs + [rec]),
                f"{phase}: non-finite output")
        require(tuple(rec.shape) == shape and all(
            tuple(a.shape[1:]) == tuple(b.shape[1:])
            for a, b in zip([rec, *outs], ref)), f"{phase}: wrong shapes")
        fwd_err = max(max_err(a[:n].cpu(), b) for a, b in zip(outs, ref[1:]))
        inv_err = max_err(rec[:n].cpu(), ref[0])
        pr_err = max_err(rec, x)
        require(fwd_err <= FWD_ATOL and inv_err <= INV_ATOL,
                f"{phase}: GPU differs from the CPU plain run: forward "
                f"{fwd_err}, inverse {inv_err}")
        require(pr_err <= PR_TOL, f"{phase}: reconstruction error {pr_err}")
        del yl, yh, rec, outs
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        both_ms = timed_ms(lambda: i(f(x)), reps=5, batches=10,
                           device_only=False)
        peak = torch.cuda.max_memory_allocated()
        both_dev_ms = timed_ms(lambda: i(f(x)), reps=5, batches=5)
        fwd_ms = timed_ms(lambda: f(x), reps=5, batches=10,
                          device_only=False)
        coeffs = f(x)
        inv_ms = timed_ms(lambda: i(coeffs), reps=5, batches=10,
                          device_only=False)
        del coeffs
    fields = dict(
        shape=list(shape), J=J, wave=DWT_WAVE, mode=DWT_MODE,
        launches={"forward": fwd_counts, "inverse": inv_counts},
        checked_images=n,
        max_abs_err_vs_cpu={"forward": fwd_err, "inverse": inv_err},
        tolerance={"forward": FWD_ATOL, "inverse": INV_ATOL},
        reconstruction_err=pr_err, reconstruction_tol=PR_TOL,
        first_call_s=first_s, fwd_inv_ms=both_ms, fwd_ms=fwd_ms,
        inv_ms=inv_ms, mpix_per_s=mpix / (both_ms / 1e3),
        fwd_inv_device_ms=both_dev_ms,
        device_busy_share=both_dev_ms / both_ms,
        peak_mem_bytes=peak, mem_held_before_bytes=held,
        cpu_reference_s=cpu_s)

    x.requires_grad_()

    def step():
        yl, yh = f(x)
        outs = [i((yl, yh)), yl, *yh]
        return torch.autograd.grad(outs, x, cts)[0]

    torch.cuda.synchronize()
    ops.reset_launches()
    yl, yh = f(x)
    outs = [i((yl, yh)), yl, *yh]
    tf_counts = ops.launch_counts()
    grad = torch.autograd.grad(outs, x, cts)[0]
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    tb_counts = {k: counts[k] - tf_counts[k] for k in counts}
    require(all(tf_counts[k] > 0 and tb_counts[k] > 0 for k in DWT_KERNELS),
            f"{phase} training: a kernel of the path never launched: "
            f"forward {tf_counts}, backward {tb_counts}")
    require(bool(torch.isfinite(grad).all()) and tuple(grad.shape) == shape,
            f"{phase} training: x.grad is not finite or has the wrong shape")
    grad_err = max_err(grad[:n].cpu(), ref_grad)
    require(grad_err <= GRAD_ATOL, f"{phase} training: x.grad differs from "
            f"the CPU plain run by {grad_err}")
    del yl, yh, outs, grad
    adj_f, adj_i = dwt_adjoint(tt, x_cpu[:n], J, one_d)
    require(adj_f <= ADJOINT_TOL and adj_i <= ADJOINT_TOL,
            f"{phase}: adjoint identity ('zero' mode) off by {adj_f} "
            f"(forward), {adj_i} (inverse)")
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step_ms = timed_ms(step, reps=5, batches=10, device_only=False)
    tpeak = torch.cuda.max_memory_allocated()
    step_dev_ms = timed_ms(step, reps=5, batches=5)
    with DwtRecorder(afb, dwt) as r:
        yl, yh = f(x)
        outs = [i((yl, yh)), yl, *yh]
        r.backward = True
        torch.autograd.grad(outs, x, cts)
        torch.cuda.synchronize()
    del yl, yh, outs
    by_role = {"analysis": tf_counts["afb1d_corr"],
               "synthesis": tf_counts["sfb1d_conv"],
               "synthesis's backward": tb_counts["afb1d_corr"],
               "analysis's backward": tb_counts["sfb1d_conv"]}
    tfields = dict(
        shape=list(shape), J=J, wave=DWT_WAVE, mode=DWT_MODE,
        launches={"forward": tf_counts, "backward": tb_counts},
        launches_by_role=by_role, checked_images=n,
        max_abs_err_grad_vs_cpu=grad_err, tolerance=GRAD_ATOL,
        adjoint_rel_err_zero_mode={"forward": adj_f, "inverse": adj_i},
        adjoint_tol=ADJOINT_TOL,
        fwd_bwd_ms=step_ms, fwd_bwd_device_ms=step_dev_ms,
        device_busy_share=step_dev_ms / step_ms,
        mpix_per_s=mpix / (step_ms / 1e3),
        peak_mem_bytes=tpeak, mem_held_before_bytes=held)
    return fields, tfields, by_role, r.calls, step


def dwt_edge_cases(afb, pad):
    """K6/K7 against their plain versions where the main paths do not
    reach: every mode along both axes, odd sizes, db38 (76 taps) at
    periodization's single-fold sizes, strided views as inputs, cropped
    outputs.  Returns (calls checked, max error)."""
    gen = torch.Generator().manual_seed(70)
    calls = []
    for L, n in ((8, 33), (8, 6), (76, 20), (76, 7)):
        taps = torch.randn((4, L), generator=gen, dtype=torch.float64)
        h0, h1, g0, g1 = (t.numpy() / np.sqrt(L) for t in taps)
        for mode in ("zero", "symmetric", "reflect", "periodic",
                     "periodization"):
            for axis in (2, 3):
                shape = [2, 3, 9, 11]
                shape[axis] = n
                wide = torch.randn((shape[0], shape[1], 4, *shape[2:]),
                                   generator=gen).cuda()
                x = wide[:, :, 2]
                m = afb.afb_plan(n, L, mode)[0]
                calls.append(("afb1d_corr", "edge",
                              (x, h0, h1, mode, axis, None)))
                calls.append(("afb1d_corr", "edge",
                              (x, h0, h1, mode, axis, max(m - 1, 1))))
                shape[axis] = m
                stack = torch.randn((shape[0], shape[1], 3, *shape[2:]),
                                    generator=gen).cuda()
                lo, hi = stack[:, :, 2], stack[:, :, 0]
                calls.append(("sfb1d_conv", "edge",
                              (lo, hi, g0, g1, mode, axis, None)))
                calls.append(("sfb1d_conv", "edge",
                              (lo, hi, g0, g1, mode, axis, n)))
    err = 0.0
    for call in calls:
        got, want = dwt_call_parts(call, afb, pad)[:2]
        require(torch.allclose(got, want, **DWT_TOL),
                f"{call[0]} edge case {tuple(call[2][0].shape)} "
                f"{call[2][-3:]} disagrees with its plain version by "
                f"{max_err(got, want)}")
        err = max(err, max_err(got, want))
    torch.cuda.synchronize()
    return len(calls), err


def profile(step, iters):
    """Device time by kernel over a window of ``iters`` steps
    (torch.profiler; its own host overhead inflates the window's wall
    time, so the busy shares come from the path phases instead)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.key_averages():
        # device events only: the autograd Functions' host ranges are
        # credited with the ctypes-launched kernels inside them too
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0 and e.device_type == DeviceType.CUDA:
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.replace("void ", "").split("(")[0][:60]
            by_name[name] = by_name.get(name, 0.0) + us / iters
    total = sum(by_name.values())
    return dict(window_iters=iters,
                device_us_per_iter=total if total else "not measured",
                device_us_per_iter_by_kernel=sorted(
                    by_name.items(), key=lambda kv: -kv[1]))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import pytorch_wavelets_tpu_torch as tt
    from pytorch_wavelets_tpu_torch import ops
    from pytorch_wavelets_tpu_torch.ops import (
        _cuda, afb_sfb, banded, fused_dtcwt, pad, quad, scat_mag,
    )
    from pytorch_wavelets_tpu_torch.transforms import dwt, scatternet

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    require(not torch.backends.cuda.matmul.allow_tf32
            and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    emit("env", nvidia_smi=smi, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), python=sys.version.split()[0],
         torch=torch.__version__, cuda=torch.version.cuda,
         tf32={"matmul": torch.backends.cuda.matmul.allow_tf32,
               "cudnn": torch.backends.cudnn.allow_tf32},
         precision=tt.get_matmul_precision())

    t0 = time.perf_counter()
    log = _cuda.build()
    regs = {n: [ln.strip() for ln in v["log"].splitlines()
                if "registers" in ln or "spill" in ln]
            for n, v in log.items()}
    emit("build", seconds=time.perf_counter() - t0, ptxas=regs)

    kern = (banded, quad, scat_mag, afb_sfb, pad)
    counts, calls, fields = drive(tt, ops, fused_dtcwt, scatternet,
                                  MAIN_SHAPE, 2, "main")
    emit("main_path", **fields)
    bcounts, bcalls, bfields = drive(tt, ops, fused_dtcwt, scatternet,
                                     BANDED_SHAPE, 3, "banded")
    emit("banded_path", **bfields)
    tfields, t_roles, tcalls = train_main(tt, ops, fused_dtcwt, scatternet,
                                          MAIN_SHAPE, 2)
    emit("train_main", **tfields)
    sfields, s_roles, scalls = scat_step(tt, ops, fused_dtcwt, scatternet,
                                         SCAT_SHAPE, SCAT_CHECK_N, "scat_j2",
                                         SCAT_TIMING)
    emit("scat_j2", **sfields, gtx1080_reference_s=dict(
        GTX1080_SCAT_S, source="BASELINE.md:18", hardware="GTX1080"))
    cfields, c_roles, ccalls = scat_step(
        tt, ops, fused_dtcwt, scatternet, COLOUR_SHAPE, COLOUR_CHECK_N,
        "scat_j2_colour", COLOUR_TIMING, combine_colour=True)
    emit("scat_j2_colour", **cfields)
    dfields, dtfields, d_roles, dcalls, dstep = dwt_path(
        tt, ops, afb_sfb, dwt, DWT_SHAPE, DWT_J, False, "dwt_main")
    emit("dwt_main", **dfields)
    emit("dwt_train", **dtfields)
    ofields, otfields, o_roles, ocalls, _ = dwt_path(
        tt, ops, afb_sfb, dwt, DWT1D_SHAPE, DWT1D_J, True, "dwt1d")
    emit("dwt1d", **ofields, training=otfields)
    n_edge, edge_err = dwt_edge_cases(afb_sfb, pad)
    emit("dwt_edge_cases", calls=n_edge, max_abs_err=edge_err,
         tolerance=DWT_TOL)

    groups = [(SOURCES[k][0], SOURCES[k][2], counts[k],
               [c for c in calls if c[0] == k])
              for k in PYRAMID_KERNELS]
    groups += [(f"{SOURCES[k][0]} ({shape_str(BANDED_SHAPE)} J=3)",
                BANDED_REPLACES,
                bcounts[k], [c for c in bcalls if c[0] == k])
               for k in ("apply_row", "apply_col")]
    groups += role_groups(tcalls, t_roles, [
        "forward pyramid's adjoint (B4)", "inverse pyramid's adjoint"],
        f"DTCWT J=2 {shape_str(MAIN_SHAPE)} backward")
    groups += role_groups(scalls, s_roles, [
        "forward pyramid", MAG_ROLE, "forward pyramid's adjoint (B4)"],
        f"ScatLayerj2 {shape_str(SCAT_SHAPE)}")
    groups += role_groups(ccalls, c_roles, [
        "forward pyramid", MAG_ROLE, "forward pyramid's adjoint (B4)"],
        f"ScatLayerj2 combine_colour {shape_str(COLOUR_SHAPE)}")
    for dc, roles, label, line in (
            (dcalls, d_roles, f"DWT J={DWT_J} {shape_str(DWT_SHAPE)}",
             (109, 143)),
            (ocalls, o_roles, f"DWT1D J={DWT1D_J} {shape_str(DWT1D_SHAPE)}",
             (176, 198))):
        for role in ("analysis", "synthesis", "analysis's backward",
                     "synthesis's backward"):
            mine = [c for c in dc if c[1] == role]
            kernel = mine[0][0]
            replaces = {"analysis's backward": line[0],
                        "synthesis's backward": line[1]}.get(role)
            groups.append((
                f"{SOURCES[kernel][0]} ({label}: {role})",
                SOURCES[kernel][2] if replaces is None else
                f"pytorch_wavelets_tpu/transforms/dwt.py:{replaces}",
                roles[role], mine))
    with torch.no_grad():
        rows = kernel_rows(groups, *kern)
    for row in rows:
        emit("kernel", **row)
    del calls, bcalls, tcalls, scalls, ccalls, dcalls, ocalls

    fwd = tt.DTCWTForward(J=2, device="cuda")
    inv = tt.DTCWTInverse(device="cuda")
    x = torch.randn(MAIN_SHAPE,
                    generator=torch.Generator().manual_seed(0)).cuda()
    with torch.no_grad():
        emit("profile", path="main", **profile(lambda: inv(fwd(x)), 10))
    m = tt.ScatLayerj2(device="cuda")
    N, C, H, W = SCAT_SHAPE
    xs = torch.randn(SCAT_SHAPE, generator=torch.Generator().manual_seed(0))
    xs = xs.cuda().requires_grad_()
    G = torch.randn((N, 49 * C, H // 4, W // 4),
                    generator=torch.Generator().manual_seed(1)).cuda()
    emit("profile", path="scat_j2 forward + backward",
         **profile(lambda: torch.autograd.grad(m(xs), xs, G), 3))
    del m, xs, G
    emit("profile", path="dwt_train", **profile(dstep, 3))

    print(json.dumps({"kernels": [{k: v for k, v in r.items()
                                   if k != "per_call"} for r in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
