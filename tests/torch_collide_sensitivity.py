"""How far a 1e-6 change of the keypoints moves the single-person
collision fit's stage losses, in the JAX package or in the PyTorch port
(on the CPU).

    python tests/torch_collide_sensitivity.py --package jax|torch \
        [--iters 3] [--init-lambda 1e-3] [--stages 4]

The problem is 2 frames of the synthetic fixture (`make_problem(6, 2,
seed=1)`), the collision term on at G=16, chol and classic LM with
`--iters` iterations per stage; `--stages 3` stops after the first
collision stage (coll weight 1000), `--stages 4` runs the demo schedule
to the end (4500).  The keypoints are scaled by (1 + eps) for eps in
(1e-6, -1e-6, 3e-7) and each stage's largest relative loss change over
the frames is printed, one line per eps.  A fit whose card and CPU runs
are compared at rtol 1e-3 needs these far below 1e-3 in both packages.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]     # the repo, the helpers

EPS = (1e-6, -1e-6, 3e-7)
G = 16
WEIGHTS = dict(pose_weights=(404.0, 404.0, 57.4, 4.78),
               shape_weights=(100.0, 50.0, 10.0, 5.0),
               coll_weights=(0.0, 0.0, 1000.0, 4500.0))


def schedule(stages: int) -> dict:
    return {k: v[:stages] for k, v in WEIGHTS.items()}


def torch_losses(args):
    import torch

    from mvsmplfitting_tpu_torch.fitting.energy import EnergySpec
    from mvsmplfitting_tpu_torch.fitting.lm import LMOptions
    from mvsmplfitting_tpu_torch.fitting.stages import FitConfig
    from mvsmplfitting_tpu_torch.parallel.batched import (
        BatchedFitInputs, batched_fit_frames)
    from mvsmplfitting_tpu_torch.synthetic import make_problem

    torch.set_num_threads(4)     # a shared CPU: more threads stall
    cfg = FitConfig(spec=EnergySpec(interpenetration=True,
                                    coll_grid_size=G),
                    lm=LMOptions(max_iters=args.iters, linsolve="chol",
                                 speculative=False,
                                 init_lambda=args.init_lambda),
                    **schedule(args.stages))
    assets, vw, cam, obs = make_problem(6, 2, seed=1, device="cpu")

    def run(eps):
        o = obs.__class__(**{**obs.__dict__, "gt2d": obs.gt2d * (1 + eps)})
        return batched_fit_frames(
            cfg, assets, cam, BatchedFitInputs(o, torch.full((2,), 1080.0)),
            vposer_w=vw, device="cpu").stage_losses.numpy()
    return run


def jax_losses(args):
    import jax
    import jax.numpy as jnp

    from mvsmplfitting_tpu.fitting import FitConfig
    from mvsmplfitting_tpu.fitting import energy as JE
    from mvsmplfitting_tpu.fitting.initialize import init_guess
    from mvsmplfitting_tpu.fitting.lm import LMOptions
    from mvsmplfitting_tpu.fitting.stages import fit_frame
    from mvsmplfitting_tpu.models.camera import Camera
    from mvsmplfitting_tpu_torch.synthetic import make_problem
    from torch_port_helpers import jax_assets, vposer_pair

    cfg = FitConfig(spec=JE.EnergySpec(interpenetration=True,
                                       coll_grid_size=G),
                    lm=LMOptions(max_iters=args.iters, linsolve="chol",
                                 speculative=False,
                                 init_lambda=args.init_lambda),
                    **schedule(args.stages))
    _, _, tc, to = make_problem(6, 2, seed=1, device="cpu")
    assets, vw = jax_assets("smpl"), vposer_pair()[0]
    cam = Camera(**{f: jnp.asarray(getattr(tc, f).numpy())
                    for f in ("rotation", "translation", "focal", "center")})
    fields = {f: jnp.asarray(getattr(to, f).numpy())
              for f in ("gt2d", "conf", "view_mask", "joint_weights")}

    def one(obs):
        guess = init_guess(assets, cam, obs.gt2d, obs.conf, obs.view_mask,
                           est_scale=True)
        return fit_frame(cfg, assets, cam, obs, guess.params, guess.z,
                         vposer_w=vw, img_height=1080.0).stage_losses
    fit = jax.jit(jax.vmap(one))

    def run(eps):
        obs = JE.Observations(**{**fields,
                                 "gt2d": fields["gt2d"] * (1 + eps)})
        return np.asarray(fit(obs))
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--init-lambda", type=float, default=1e-3)
    ap.add_argument("--stages", type=int, choices=(3, 4), default=4)
    args = ap.parse_args()
    run = (jax_losses if args.package == "jax" else torch_losses)(args)
    t0 = time.perf_counter()
    base = run(0.0)
    print(f"package={args.package} iters={args.iters} "
          f"init_lambda={args.init_lambda} stages={args.stages} G={G} "
          f"stage_losses={np.round(base, 1).tolist()}", flush=True)
    for eps in EPS:
        rel = (np.abs(run(eps) - base) / np.abs(base)).max(0)
        print(f"eps={eps:+.0e} max_rel_change_per_stage="
              f"{[float(f'{r:.2e}') for r in rel]}", flush=True)
    print(f"seconds={time.perf_counter() - t0:.1f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
