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
5. per kernel: every kernel call of one run of each path, recorded and
   replayed on the same tensors against its plain PyTorch version (with
   the tolerance stated), timed (device time) beside the plain version
   and one PyTorch library call, with the least time the card could take
   for the call (bound: bytes over HBM rate or nonzero FLOPs over the fp32
   rate, whichever is larger), summed over the path's calls.
6. profile: device time by kernel of the main path (torch.profiler).

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

SOURCES = {
    "apply_row": ("banded_apply_row", "banded_apply.cu",
                  "pytorch_wavelets_tpu/ops/banded.py:332"),
    "apply_col": ("banded_apply_col", "banded_apply.cu",
                  "pytorch_wavelets_tpu/ops/banded.py:321"),
    "q2c_pack": ("q2c_pack", "q2c_pack.cu",
                 "pytorch_wavelets_tpu/ops/fused_dtcwt.py:126"),
    "c2q_unpack": ("c2q_unpack", "c2q_unpack.cu",
                   "pytorch_wavelets_tpu/ops/fused_dtcwt.py:290"),
}
BANDED_REPLACES = "pytorch_wavelets_tpu/ops/banded.py:410"


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


def max_err(a, b):
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


# ---------------------------------------------------------------------------
# recording the kernel calls of one run
# ---------------------------------------------------------------------------

class Recorder:
    """Swaps the kernel wrappers that the pyramids call for recording
    ones, for one run; each record keeps the call's input tensors."""

    def __init__(self, fused):
        self.fused = fused
        self.calls = []
        self.saved = {}

    def __enter__(self):
        f = self.fused
        for name in SOURCES:
            self.saved[name] = getattr(f, name)
        calls, orig = self.calls, self.saved

        def apply_row(x, T):
            calls.append(("apply_row", x, T, None))
            return orig["apply_row"](x, T)

        def apply_col(x, T, out=None):
            calls.append(("apply_col", x, T,
                          None if out is None else out.clone()))
            return orig["apply_col"](x, T, out)

        def q2c_pack(y, out, orients):
            calls.append(("q2c_pack", y, (out.size(), out.stride()), orients))
            return orig["q2c_pack"](y, out, orients)

        def c2q_unpack(h, orients):
            calls.append(("c2q_unpack", h, None, orients))
            return orig["c2q_unpack"](h, orients)

        for name, fn in (("apply_row", apply_row), ("apply_col", apply_col),
                         ("q2c_pack", q2c_pack), ("c2q_unpack", c2q_unpack)):
            setattr(f, name, fn)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.fused, name, fn)


def replay(call, banded, quad):
    """Check one recorded call against its plain version and time it.
    Returns (err, ms, plain_ms, library_ms, bound_ms, op_t, byte_t)."""
    name, x, arg, extra = call
    if name in ("apply_row", "apply_col"):
        T = arg
        Td = T.T
        if name == "apply_row":
            N, C, H, K = x.shape
            rows = N * C * H
            got = banded.apply_row(x, T)
            want = banded.apply_row_plain(x, T)
            run = lambda: banded.apply_row(x, T)              # noqa: E731
            plain = lambda: banded.apply_row_plain(x, T)      # noqa: E731
            lib = lambda: torch.matmul(x, Td.t())             # noqa: E731
            ops = 2.0 * T.nnz * rows
            nbytes = 4.0 * (x.numel() + Td.numel() + got.numel())
        else:
            out = extra
            N, C, K, Wc = x.shape
            got = banded.apply_col(x, T,
                                   None if out is None else out.clone())
            want = banded.apply_col_plain(x, T, out)
            buf = None if out is None else out.clone()
            run = lambda: banded.apply_col(x, T, buf)         # noqa: E731
            plain = lambda: banded.apply_col_plain(x, T, out)  # noqa: E731
            if out is None:
                lib = lambda: torch.matmul(Td, x)             # noqa: E731
            else:
                lib = lambda: torch.matmul(Td, x).add_(out)   # noqa: E731
            ops = 2.0 * T.nnz * N * C * Wc
            nbytes = 4.0 * (x.numel() + Td.numel() + got.numel()
                            * (1 if out is None else 2))
        require(torch.allclose(got, want, **K1_TOL),
                f"{name} {tuple(x.shape)} x {tuple(Td.shape)} disagrees with "
                f"its plain version by {max_err(got, want)}")
        err = max_err(got, want)
        lib_ms = timed_ms(lib)
    elif name == "q2c_pack":
        size, stride = arg
        got = torch.empty_strided(size, stride, device=x.device)
        want = torch.empty_strided(size, stride, device=x.device)
        quad.q2c_pack(x, got, extra)
        quad.q2c_pack_plain(x, want, extra)
        written = [o for pair in extra for o in pair]  # orientations filled
        got, want = got[:, :, written], want[:, :, written]
        require(torch.equal(got, want), f"q2c_pack disagrees with its plain "
                f"version by {max_err(got, want)}")
        err = max_err(got, want)
        buf = torch.empty_strided(size, stride, device=x.device)
        run = lambda: quad.q2c_pack(x, buf, extra)            # noqa: E731
        plain = lambda: quad.q2c_pack_plain(x, buf, extra)    # noqa: E731
        lib_ms = None
        ops = 1.0 * got.numel()           # one add or subtract per value
        nbytes = 4.0 * (x.numel() + got.numel())
    else:
        got = quad.c2q_unpack(x, extra)
        want = quad.c2q_unpack_plain(x, extra)
        require(torch.equal(got, want), f"c2q_unpack disagrees with its "
                f"plain version by {max_err(got, want)}")
        err = max_err(got, want)
        run = lambda: quad.c2q_unpack(x, extra)               # noqa: E731
        plain = lambda: quad.c2q_unpack_plain(x, extra)       # noqa: E731
        lib_ms = None
        ops = 1.0 * got.numel()
        nbytes = 4.0 * 2 * got.numel()    # each read once, each written once
    op_t, byte_t = ops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return (err, timed_ms(run), timed_ms(plain), lib_ms, max(op_t, byte_t),
            op_t, byte_t)


def kernel_rows(calls, counts, banded, quad, label=None):
    """Aggregate the replays of one run's calls per kernel; ``per_call``
    lists [input shape (by operator shape), ms, plain_ms, library_ms,
    bound_ms] for each call."""
    agg = {}
    for call in calls:
        err, ms, plain_ms, lib_ms, bound, op_t, byte_t = replay(call, banded,
                                                               quad)
        a = agg.setdefault(call[0], dict(err=0.0, ms=0.0, plain=0.0,
                                         lib=0.0, bound=0.0, op=0.0,
                                         byte=0.0, haslib=True, per_call=[]))
        a["err"] = max(a["err"], err)
        a["ms"] += ms
        a["plain"] += plain_ms
        a["haslib"] &= lib_ms is not None
        a["lib"] += lib_ms or 0.0
        a["bound"] += bound
        a["op"] += op_t
        a["byte"] += byte_t
        shape = "x".join(map(str, call[1].shape))
        if call[0].startswith("apply"):
            shape += " by " + "x".join(map(str, call[2].shape))
        a["per_call"].append([shape, ms, plain_ms, lib_ms, bound])
    rows = []
    for name, a in agg.items():
        kname, src, replaces = SOURCES[name]
        if label:
            kname, replaces = f"{kname} ({label})", BANDED_REPLACES
        rows.append({
            "name": kname, "route": "cuda",
            "source": f"pytorch_wavelets_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": a["err"],
            "tolerance": ("exact" if name in ("q2c_pack", "c2q_unpack")
                          else K1_TOL),
            "ms": a["ms"], "plain_ms": a["plain"],
            "bound_ms": a["bound"],
            "bound_by": "bytes" if a["byte"] >= a["op"] else "operations",
            "library_ms": a["lib"] if a["haslib"] else None,
            "per_call": a["per_call"]})
    return rows


# ---------------------------------------------------------------------------
# the paths
# ---------------------------------------------------------------------------

def drive(tt, ops, fused, shape, J, phase):
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
        require(all(n > 0 for n in counts.values()),
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
        torch.cuda.reset_peak_memory_stats()
        both_ms = timed_ms(lambda: inv(fwd(x)), reps=10, batches=15,
                           device_only=False)
        peak = torch.cuda.max_memory_allocated()
        both_dev_ms = timed_ms(lambda: inv(fwd(x)), reps=10)
        fwd_ms = timed_ms(lambda: fwd(x), reps=10, batches=15,
                          device_only=False)
        inv_ms = timed_ms(lambda: inv((yl, yh)), reps=10, batches=15,
                          device_only=False)
        with Recorder(fused) as r:
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
        peak_mem_bytes=peak, cpu_reference_s=cpu_s)
    return counts, r.calls, fields


def profile_main(tt, shape, J):
    """Device time by kernel over a window of main-path round trips
    (torch.profiler; its own host overhead inflates the window's wall
    time, so the busy share comes from the main-path phase instead)."""
    from torch.profiler import ProfilerActivity, profile
    fwd = tt.DTCWTForward(J=J, device="cuda")
    inv = tt.DTCWTInverse(device="cuda")
    x = torch.randn(shape, generator=torch.Generator().manual_seed(0)).cuda()
    iters = 10
    with torch.no_grad():
        for _ in range(3):
            inv(fwd(x))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                inv(fwd(x))
            torch.cuda.synchronize()
    by_name = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0:
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
    from pytorch_wavelets_tpu_torch.ops import _cuda, banded, fused_dtcwt, quad

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

    counts, calls, fields = drive(tt, ops, fused_dtcwt, (10, 10, 128, 128),
                                  2, "main")
    emit("main_path", **fields)
    bcounts, bcalls, bfields = drive(tt, ops, fused_dtcwt, (8, 3, 512, 512),
                                     3, "banded")
    emit("banded_path", **bfields)

    rows = kernel_rows(calls, counts, banded, quad)
    for row in rows:
        emit("kernel", **row)
    brows = [r for r in kernel_rows(bcalls, bcounts, banded, quad,
                                    label="8x3x512x512 J=3")
             if r["name"].startswith("banded_apply")]
    for row in brows:
        emit("kernel", **row)
    emit("profile", **profile_main(tt, (10, 10, 128, 128), 2))

    print(json.dumps({"kernels": [{k: v for k, v in r.items()
                                   if k != "per_call"}
                                  for r in rows + brows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
