"""Time the joint-Jacobian and VPoser-tail kernels of one or more
checkouts of this repository on one GPU, in turns.

    python3 tools/time_joint_kernels.py                   # this checkout
    python3 tools/time_joint_kernels.py --trees OLD .     # OLD . . OLD

Each turn runs in a process of its own (the checkouts' packages share a
name) with its tree first on `sys.path`; it builds that tree's kernels
under the tree's own `build/` and times them with that tree's
`chip_smoke.cuda_ms` (CUDA events around calls queued behind a spin
kernel) on the same seeded inputs: the joint Jacobian for smpl and
smpllsp, the tail on z ~ N(0, 0.6) and N(0, 1e-3) (the larger time), at
B=512 (the batched fit), 8 ([collide]) and 2 ([multi]).  With two trees
the turns go first, second, second, first.  Prints one JSON line per
turn, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

BATCHES = (512, 8, 2)


def child(tree: str) -> None:
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke
    from mvsmplfitting_tpu_torch.models import vposer as V
    from mvsmplfitting_tpu_torch.models.assets import synthetic_smpl
    from mvsmplfitting_tpu_torch.models.joint_model import with_joint_model
    from mvsmplfitting_tpu_torch.ops import joint_kernel as JK
    from mvsmplfitting_tpu_torch.ops import vposer_kernel as VK
    from mvsmplfitting_tpu_torch.synthetic import VPOSER_NPZ

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    ms = {}
    for model_type in ("smpl", "smpllsp"):
        jm = with_joint_model(synthetic_smpl(model_type,
                                             device=dev)).joint_model
        for B in BATCHES:
            theta = t(rng.normal(0, 0.4, (B, 72)))
            betas = t(rng.normal(0, 1.0, (B, 10)))
            scale = t(rng.uniform(0.7, 1.5, (B,)))
            ms[f"joint_jacobian/{model_type}/B{B}"] = chip_smoke.cuda_ms(
                lambda: JK.joint_jacobian_cuda(jm, theta, betas, scale),
                reps=50)
    w = V.load_npz(VPOSER_NPZ, device=dev)
    for B in BATCHES:
        worst = 0.0
        for sigma in (0.6, 1e-3):
            o, Do = V.mlp_head(w, t(rng.normal(0, sigma, (B, 32))))
            o, Do = o.contiguous(), Do.contiguous()
            worst = max(worst, chip_smoke.cuda_ms(
                lambda: VK.tail_cuda(o, Do), reps=50))
        ms[f"vposer_tail/B{B}"] = worst
    print(json.dumps({"tree": tree, "ms": ms}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(os.path.abspath(args.child))
        return 0
    trees = [os.path.abspath(p) for p in args.trees]
    turns = trees + trees[::-1] if len(trees) > 1 else trees
    for tree in turns:
        done = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--child", tree], capture_output=True,
                              text=True, timeout=900)
        sys.stderr.write(done.stderr[-4000:])
        if done.returncode != 0:
            print(f"turn in {tree} failed (rc {done.returncode})")
            return 1
        print(done.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
