#!/usr/bin/env python
"""Does the first call of a chain of elementwise PyTorch operations on the
CPU, in a fresh process, give the same result as the calls after it?

A reproducer that imports torch and numpy only: each of ``--procs`` fresh
Python processes makes, from one numpy seed, the two band tensors a
ScatLayerj2 on a 2x3x64x64 input hands to its smooth magnitude
((2, 6, 3, 32, 32, 2) and (2, 6, 3, 16, 16, 2), re/im last), runs the
magnitude's operations on them three times (``re * re + im * im``,
``+ bias^2``, ``sqrt``, ``- bias``, on the strided re/im views, as
``pytorch_wavelets_tpu_torch/ops/scat_mag.py:scat_mag_fwd_plain`` does),
and compares the first result with the third, operation by operation.
A last line counts the processes whose first call differed.
``--matmul-first`` runs, before the magnitudes, the multi-threaded
matrix products a ScatLayerj2 forward runs on the CPU (the operator
products of its composed pyramid, as ``torch.einsum`` at the same
shapes), the process state in which the port's probe
(``tools/torch_cpu_first_call.py``) saw the fault.

    OMP_NUM_THREADS=1 python tools/torch_first_call_elementwise.py --procs 40
    python tools/torch_first_call_elementwise.py --procs 40 --matmul-first
"""
import argparse
import os
import subprocess
import sys
from collections import Counter


def child(matmul_first):
    import numpy as np
    import torch

    rs = np.random.RandomState(17)
    if matmul_first:
        # the stage-1 row product and the stage-2 column products of a
        # J=2 pyramid on (2, 3, 64, 64), then the second order's J=1
        x = torch.from_numpy(rs.randn(2, 3, 64, 64).astype(np.float32))
        z = torch.einsum("nchw,kw->nchk", x,
                         torch.from_numpy(rs.randn(224, 64)
                                          .astype(np.float32)))
        for rows, cols in ((64, 32), (64, 64), (32, 64), (64, 32)):
            T = torch.from_numpy(rs.randn(rows, 64).astype(np.float32))
            torch.einsum("mh,nchk->ncmk", T, z[..., :cols])
        u = torch.from_numpy(rs.randn(2, 18, 32, 32).astype(np.float32))
        torch.einsum("nchw,kw->nchk", u,
                     torch.from_numpy(rs.randn(80, 32).astype(np.float32)))
    hs = [torch.from_numpy(rs.randn(2, 6, 3, n, n, 2).astype(np.float32))
          for n in (32, 16)]
    bias = 1e-2
    runs = []
    for _ in range(3):
        steps = []
        for h in hs:
            re, im = h[..., 0], h[..., 1]
            s = re * re + im * im
            t = s + bias * bias
            r = torch.sqrt(t)
            steps += [s, t, r, r - bias]
        runs.append(steps)
    names = ("re*re + im*im", "+ bias^2", "sqrt", "- bias")
    for k, (a, b) in enumerate(zip(runs[0], runs[2])):
        e = (a - b).abs().flatten()
        if float(e.max()) > 0:
            nz = e.nonzero()
            print(f"differs: band {k // 4} at '{names[k % 4]}': max "
                  f"{float(e.max()):.3g}, {nz.shape[0]} elements in flat "
                  f"range {int(nz.min())}-{int(nz.max())} of {e.numel()}")
            return
    print("same")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=40)
    ap.add_argument("--matmul-first", action="store_true")
    ap.add_argument("--child", action="store_true")
    args = ap.parse_args()
    if args.child:
        return child(args.matmul_first)
    counts = Counter()
    cmd = [sys.executable, __file__, "--child"]
    if args.matmul_first:
        cmd.append("--matmul-first")
    for _ in range(args.procs):
        out = subprocess.run(cmd,
                             capture_output=True, text=True, check=True,
                             timeout=600).stdout.strip().splitlines()[-1]
        counts["differs" if out.startswith("differs") else "same"] += 1
        if out.startswith("differs"):
            print(out, flush=True)
    print(f"{counts['differs']} of {args.procs} processes: the first call "
          f"differed from the third (torch threads: "
          f"{os.environ.get('OMP_NUM_THREADS', 'default')}, matmul first: "
          f"{args.matmul_first})")


if __name__ == "__main__":
    main()
