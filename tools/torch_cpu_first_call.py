#!/usr/bin/env python
"""Probe the port's CPU plain path for a first-call fault: does the first
``ScatLayerj2`` call on the CPU in a fresh process give the same output as
the calls after it?

Each of ``--procs`` fresh Python processes runs ``ScatLayerj2(device="cpu")``
three times on one seeded 2x3x64x64 input (torch's default CPU threads),
records the input of every operator product (``apply_row`` /
``apply_col``, K1's plain versions) and the input and output of every
``smooth_mag`` call (K4's), and prints the first recorded tensor where the
first call differs from the third: its name, the largest difference, and
which flattened elements differ.  A last line counts the processes whose
first call differed.  ``--smooth-mag-only`` records the magnitudes alone
(fewer host allocations between the calls).  ``--bisect`` also records
every intermediate of the magnitude's plain version (``re * re``,
``im * im``, their sum, ``+ bias^2``, ``sqrt``, ``- bias``: the same
PyTorch operations in the same order), so that the first operation whose
output differs from the third call's, on inputs that do not, is named.
Run it once with ``OMP_NUM_THREADS=1`` and once with the default threads.

    python tools/torch_cpu_first_call.py --procs 36
    python tools/torch_cpu_first_call.py --procs 40 --bisect

Imports torch, numpy and the port only.
"""
import argparse
import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def child(record_ops, bisect):
    import numpy as np
    import torch

    import pytorch_wavelets_tpu_torch as tt
    from pytorch_wavelets_tpu_torch.ops import fused_dtcwt, scat_mag
    from pytorch_wavelets_tpu_torch.transforms import scatternet

    rec = []
    orig = scatternet.smooth_mag

    def plain_steps(h, bias, combine=False):
        """scat_mag_fwd_plain's operations one by one, each recorded."""
        re, im = h[..., 0], h[..., 1]
        steps = [("re*re", re * re), ("im*im", im * im)]
        s = steps[0][1] + steps[1][1]
        steps.append(("re*re + im*im", s))
        if combine:
            s = s.sum(dim=2, keepdim=True)
            steps.append(("sum over C", s))
        t = s + bias * bias
        r = torch.sqrt(t)
        out = r - bias
        steps += [("+ bias^2", t), ("sqrt", r), ("- bias", out)]
        rec.extend((f"magnitude step {n}", v.clone()) for n, v in steps)
        return out

    if bisect:
        scat_mag.scat_mag_fwd_plain = plain_steps

    def recording(name, fn):
        def wrapped(x, *args, **kwargs):
            rec.append((f"{name} input", x.detach().clone()))
            return fn(x, *args, **kwargs)
        return wrapped

    if record_ops:
        for name in ("apply_row", "apply_col"):
            setattr(fused_dtcwt, name,
                    recording(name, getattr(fused_dtcwt, name)))

    def smooth_mag(h, *args, **kwargs):
        rec.append(("smooth_mag input", h.detach().clone()))
        out = orig(h, *args, **kwargs)
        rec.append(("smooth_mag output", out.detach().clone()))
        return out

    scatternet.smooth_mag = smooth_mag
    x = torch.from_numpy(np.random.RandomState(17).randn(2, 3, 64, 64)
                         .astype(np.float32))
    runs = []
    for _ in range(3):
        rec.clear()
        with torch.no_grad():
            z = tt.ScatLayerj2(device="cpu")(x)
        runs.append((list(rec), z))
    (first, z0), (last, z2) = runs[0], runs[2]
    d = float((z0 - z2).abs().max())
    if d == 0:
        print("same")
        return
    for k, ((name, a), (_, b)) in enumerate(zip(first, last)):
        e = (a - b).abs().flatten()
        if float(e.max()) > 0:
            nz = e.nonzero()
            print(f"differs: output by {d:.3g}; first at record {k} "
                  f"({name}, {tuple(a.shape)}): max {float(e.max()):.3g}, "
                  f"{nz.shape[0]} elements in flat range "
                  f"{int(nz.min())}-{int(nz.max())} of {e.numel()}")
            return
    print(f"differs: output by {d:.3g}; no smooth_mag record differs")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=36)
    ap.add_argument("--smooth-mag-only", action="store_true")
    ap.add_argument("--bisect", action="store_true")
    ap.add_argument("--child", action="store_true")
    args = ap.parse_args()
    if args.child:
        return child(not args.smooth_mag_only, args.bisect)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    counts = Counter()
    for _ in range(args.procs):
        cmd = [sys.executable, __file__, "--child"]
        if args.smooth_mag_only:
            cmd.append("--smooth-mag-only")
        if args.bisect:
            cmd.append("--bisect")
        out = subprocess.run(cmd,
                             capture_output=True, text=True, env=env,
                             check=True, timeout=600).stdout.strip()
        line = out.splitlines()[-1]
        counts["differs" if line.startswith("differs") else "same"] += 1
        if line.startswith("differs"):
            print(line, flush=True)
    print(f"{counts['differs']} of {args.procs} processes: the first CPU "
          f"call differed from the third (torch threads: "
          f"{os.environ.get('OMP_NUM_THREADS', 'default')})")


if __name__ == "__main__":
    main()
