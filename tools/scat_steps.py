#!/usr/bin/env python3
"""Device time of chip_smoke.py's ScatLayerj2 training steps on one CUDA
card: scat_j2 (the reference's ScatterNet workload, 128x3x256x256) and
scat_bp (the same with the bandpass-diagonal filters), each step and
forward timed with chip_smoke's timer, inputs and cotangent.

    python3 tools/scat_steps.py [--root DIR] [--label NAME]

``--root`` imports ``chip_smoke`` and ``pytorch_wavelets_tpu_torch`` from
another checkout (say an unpacked parent commit), so that two versions
can be timed on one card in one sitting: run it once per root, in turns.
Prints one JSON line (ms) and the card's name and power limit.  Imports
torch and the port only.
"""
import argparse
import json
import subprocess
import sys

import torch


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=".")
    p.add_argument("--label", default=None)
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
    for name, kw in (("scat_j2", {}), ("scat_bp", cs.BP)):
        m = tt.ScatLayerj2(device="cuda", **kw)
        N, C, H, W = cs.SCAT_SHAPE
        x = torch.randn(cs.SCAT_SHAPE,
                        generator=torch.Generator().manual_seed(0)).cuda()
        x.requires_grad_()
        G = torch.randn((N, 49 * C, H // 4, W // 4),
                        generator=torch.Generator().manual_seed(1)).cuda()

        def step():
            return torch.autograd.grad(m(x), x, G)
        res[name + "_step_device_ms"] = cs.timed_ms(step, 3, 5)
        res[name + "_step_ms"] = cs.timed_ms(step, 3, 5, device_only=False)
        with torch.no_grad():
            res[name + "_fwd_device_ms"] = cs.timed_ms(lambda: m(x), 3, 5)
        del m, x, G
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
