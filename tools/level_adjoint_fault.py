#!/usr/bin/env python
"""How far the dot-product test of ``chip_smoke.py`` separates a right
level-1 backward from one with a boundary fault, by input size.

For a seeded 1x3xSxS input x and random cotangents g of the level-1
forward A = ``fwd_j1_op`` (near_sym_a, 'symmetric'), it prints the test's
relative error (``chip_smoke.adjoint_error``) for A's own backward (the
sound reading, fp32 rounding alone) and for a backward that runs the
level-1 synthesis in 'zero' mode instead: a planted fault that differs
from A's adjoint only near the boundary.  ``LEVEL_ADJOINT_TOL`` in
``chip_smoke.py`` sits between the two at that script's 1x3x9216^2.

    python tools/level_adjoint_fault.py --sides 256 1024 2048 4096
    python tools/level_adjoint_fault.py --device cuda --sides 9216 --seeds 4

One JSON line per (side, seed).  Imports torch and the port only; on the
CPU 4096 takes ~30 s and a few GB; on the card the level runs through
K8 and K2/K3's per-level modes.
"""
import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import pytorch_wavelets_tpu_torch as tt                       # noqa: E402
from chip_smoke import adjoint_error                          # noqa: E402
from pytorch_wavelets_tpu_torch.transforms import dtcwt as lev  # noqa: E402


def readings(side, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(1, 3, side, side, generator=gen, device=device)
    ff = tt.DTCWTForward(J=1, device=device)._filters
    od, rd, _, _ = lev.get_dimensions5(2, -1)
    z = x.requires_grad_()
    outs = lev.fwd_j1_op(z, ff["h0o"], ff["h1o"], False, 2, -1, "symmetric")
    gs = [torch.randn(o.shape, generator=gen, device=device) for o in outs]
    sound = torch.autograd.grad(outs, z, gs)[0]
    with torch.no_grad():
        wrong = lev.inv_j1(gs[0], gs[1], *lev._taps(ff["h0o"], ff["h1o"],
                                                    None), od, rd, "zero")
    return dict(side=side, seed=seed, device=device, n=x.numel(),
                sound=adjoint_error(outs, gs, [z], [sound]),
                zero_mode_backward=adjoint_error(outs, gs, [z], [wrong]))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sides", type=int, nargs="+",
                    default=[256, 1024, 2048, 4096])
    ap.add_argument("--seeds", type=int, default=1,
                    help="seeds 0..N-1 per side")
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    for side in args.sides:
        for seed in range(args.seeds):
            print(json.dumps(readings(side, seed, args.device)), flush=True)


if __name__ == "__main__":
    main()
