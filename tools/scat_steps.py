#!/usr/bin/env python3
"""Device time of chip_smoke.py's training steps and round trips on one
CUDA card, with chip_smoke's timer, inputs and cotangents:

- ``main``: the DTCWT J=2 round trip on 10x10x128x128 (the reference's
  workload; host-bound, so its waited time shows the wrappers' host
  work);
- ``scat_j2``: the ScatLayerj2 training step on 128x3x256x256 (the
  reference's ScatterNet workload) and its forward;
- ``scat_bp``: the same with the bandpass-diagonal filters;
- ``scat_j2_bf16``: the scat_j2 step on bf16 input (prec_scat's bf16 run);
- ``dtcwt_large``: DTCWTForward(J=3) -> DTCWTInverse on 1x3x9216x9216;
- ``swt_long``: SWTForward(J=2, db4, 'periodization') -> SWTInverse on
  1x3x4096x4096 (the FFT merge, K13), its round trip and its training
  step.

    python3 tools/scat_steps.py [--root DIR] [--label NAME]
                                [--paths scat_j2 scat_bp ...]

``--root`` imports ``chip_smoke`` and ``pytorch_wavelets_tpu_torch`` from
another checkout (say an unpacked parent commit), so that two versions
can be timed on one card in one sitting: run it once per root, in turns.
Prints one JSON line (ms) and
the card's name and power limit.  Imports torch and the port only.
"""
import argparse
import json
import subprocess
import sys

import torch

PATHS = ("main", "scat_j2", "scat_bp", "scat_j2_bf16", "dtcwt_large",
         "swt_long")


def scat(cs, tt, res, name, kw, dtype):
    m = tt.ScatLayerj2(device="cuda", **kw)
    N, C, H, W = cs.SCAT_SHAPE
    x = torch.randn(cs.SCAT_SHAPE,
                    generator=torch.Generator().manual_seed(0)).cuda()
    x = x.to(dtype).requires_grad_()
    G = torch.randn((N, 49 * C, H // 4, W // 4),
                    generator=torch.Generator().manual_seed(1)).cuda()
    G = G.to(dtype)

    def step():
        return torch.autograd.grad(m(x), x, G)
    res[name + "_step_device_ms"] = cs.timed_ms(step, 3, 5)
    res[name + "_step_ms"] = cs.timed_ms(step, 3, 5, device_only=False)
    with torch.no_grad():
        res[name + "_fwd_device_ms"] = cs.timed_ms(lambda: m(x), 3, 5)


def main_path(cs, tt, res):
    x = torch.randn(cs.MAIN_SHAPE,
                    generator=torch.Generator().manual_seed(0)).cuda()
    f = tt.DTCWTForward(J=2, device="cuda")
    i = tt.DTCWTInverse(device="cuda")
    with torch.no_grad():
        res["main_round_trip_device_ms"] = cs.timed_ms(lambda: i(f(x)), 10)
        res["main_round_trip_ms"] = cs.timed_ms(
            lambda: i(f(x)), 10, 15, device_only=False)


def dtcwt_large(cs, tt, res):
    x = torch.randn(cs.LARGE_SHAPE, generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    f = tt.DTCWTForward(J=cs.LARGE_J, device="cuda")
    i = tt.DTCWTInverse(device="cuda")
    with torch.no_grad():
        res["dtcwt_large_round_trip_device_ms"] = cs.timed_ms(
            lambda: i(f(x)), 3, 3)
        res["dtcwt_large_round_trip_ms"] = cs.timed_ms(
            lambda: i(f(x)), 3, 3, device_only=False)


def swt_long(cs, tt, res):
    mode, shape = cs.SWT_LONG[0]
    gen = torch.Generator(device="cuda")
    x = torch.randn(shape, generator=gen.manual_seed(0), device="cuda")
    f = tt.SWTForward(J=cs.SWT_LONG_J, wave=cs.SWT_WAVE, mode=mode,
                      device="cuda")
    i = tt.SWTInverse(wave=cs.SWT_WAVE, mode=mode, device="cuda")
    with torch.no_grad():
        res["swt_long_round_trip_device_ms"] = cs.timed_ms(
            lambda: i(f(x)), 2, 3)
        res["swt_long_round_trip_ms"] = cs.timed_ms(
            lambda: i(f(x)), 2, 3, device_only=False)
    cts = [torch.randn(t.shape, generator=gen.manual_seed(1 + k),
                       device="cuda")
           for k, t in enumerate([x] + [x.unsqueeze(2).expand(
               -1, -1, 4, -1, -1)] * cs.SWT_LONG_J)]
    xg = x.requires_grad_()

    def step():
        ys = f(xg)
        return torch.autograd.grad([i(ys), *ys], xg, cts)[0]
    res["swt_long_step_device_ms"] = cs.timed_ms(step, 2, 3)
    res["swt_long_step_ms"] = cs.timed_ms(step, 2, 3, device_only=False)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=".")
    p.add_argument("--label", default=None)
    p.add_argument("--paths", nargs="+", choices=PATHS,
                   default=["scat_j2", "scat_bp"])
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("scat_steps: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    import pytorch_wavelets_tpu_torch as tt
    from pytorch_wavelets_tpu_torch.ops import _cuda
    _cuda.build()
    res = {"tree": args.label or args.root, "package": tt.__file__}
    for name in args.paths:
        if name == "main":
            main_path(cs, tt, res)
        elif name == "dtcwt_large":
            dtcwt_large(cs, tt, res)
        elif name == "swt_long":
            swt_long(cs, tt, res)
        else:
            scat(cs, tt, res, name, cs.BP if name == "scat_bp" else {},
                 torch.bfloat16 if name.endswith("bf16") else torch.float32)
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
