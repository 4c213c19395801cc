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
7. per kernel: every kernel call of one run of each path, recorded and
   replayed on the same tensors against its plain PyTorch version (with
   the tolerance stated), timed (device time) beside the plain version
   and one PyTorch library call where one computes the same function,
   with the least time the card could take for the call (bound: bytes
   over HBM rate or FLOPs over the fp32 rate, whichever is larger),
   summed per kernel and per role (forward pyramid, its adjoint B4, the
   inverse's adjoint, the magnitudes).
8. profile: device time by kernel of the main path and of one ScatLayerj2
   training step (torch.profiler).

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


def replay(call, banded, quad, mag):
    """Check one recorded call against its plain version and time it.
    Returns (err, ms, plain_ms, library_ms, bound_ms, op_t, byte_t)."""
    name, _, args = call
    lib = None
    if name == "apply_row":
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


def kernel_rows(groups, banded, quad, mag):
    """One row per group (name, replaces, launches, calls): the replays of
    its calls summed; ``per_call`` lists [input shape (by operator
    shape), ms, plain_ms, library_ms, bound_ms] for each call."""
    rows = []
    for name, replaces, launches, calls in groups:
        a = dict(err=0.0, ms=0.0, plain=0.0, lib=0.0, bound=0.0, op=0.0,
                 byte=0.0, haslib=True, per_call=[])
        for call in calls:
            err, ms, plain_ms, lib_ms, bound, op_t, byte_t = replay(
                call, banded, quad, mag)
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
        _cuda, banded, fused_dtcwt, quad, scat_mag,
    )
    from pytorch_wavelets_tpu_torch.transforms import scatternet

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

    kern = (banded, quad, scat_mag)
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
    with torch.no_grad():
        rows = kernel_rows(groups, *kern)
    for row in rows:
        emit("kernel", **row)
    del calls, bcalls, tcalls, scalls, ccalls

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

    print(json.dumps({"kernels": [{k: v for k, v in r.items()
                                   if k != "per_call"} for r in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
