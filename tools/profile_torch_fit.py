"""Where the time of the PyTorch port's fits goes, on one GPU.

    python3 tools/profile_torch_fit.py [--frames 512] [--iters N] \
        [--classic] [--fused] [--solver lm|lbfgs|adam] \
        [--model smpl|smplh|smplx]
    python3 tools/profile_torch_fit.py --schur [--frames 512]
    python3 tools/profile_torch_fit.py --multi [--grid 128]
    python3 tools/profile_torch_fit.py --multi --engine points \
        [--points-jac ad|analytic]

Runs the port's main path (`batched_fit_frames`, 6 views, smpl, library
defaults; `--classic` turns speculative LM off, `--fused` runs all stages
in one LM loop, `FitConfig.fused`, which is classic LM; `--solver lbfgs`
or `adam` runs `chip_smoke.py` [lbfgs]'s or [grad]'s configuration
instead; `--model smplx|smplh` fits `chip_smoke.py` [smplx]'s or
[smplh]'s configuration (every tail block, the AD Jacobian); `--schur`
runs [schur]'s shared-shape sequence fit (`schur_sequence_fit` on
`synthetic.make_person_sequence`); `--iters` is the per-stage budget, by default 40 LM iterations,
120 L-BFGS iterations or 150 adam steps: the profiler records every op,
so profile those solvers over a few iterations), or with `--multi`
the two-person collision fit on the dx0=0.2 fixture (`fit_people`):
with the grid engine (the default here), the hybrid schedule, the
weights of `cfg_files/fit_multi_person_sdf.yaml` and LM max_iters 60;
with `--engine points`, JAX's default engine and refinement (15
iterations, annealed, two starts) under the library's stage weights and
LM max_iters 40 (`chip_smoke.py` [points]), once to warm up, then once
timed without the profiler and once under `torch.profiler`, with the
fit's layers wrapped in `record_function` ranges (by patching module
attributes here; the package itself carries no instrumentation).
Prints, one JSON object per line: the card, the timed run (wall,
frames/s, LM iterations, wall per iteration), the device-busy share of
the profiled run (sum of the device kernels' and copies' times over its
wall), the device time by kernel category, the top device kernels, and
host time per layer range.  `--trace PATH` also writes the Chrome trace.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

LAYERS = (
    ("fitting.stages", "fit_frame"),
    ("fitting.lm", "ad_jacobian"),
    ("ops.sdf_kernel", "sdf_grid_fast"),
    ("ops.sdf_kernel", "cull_tables"),
    ("ops.sdf", "collision_sums_sampled"),
    ("ops.sdf", "_sdf_at_points_impl"),
    ("fitting.energy", "residual_jacobian"),
    ("fitting.energy", "residuals"),
    ("fitting.energy", "total_energy"),
    ("fitting.energy", "_analytic_core"),
    ("fitting.lm", "_normal_step"),
    ("fitting.lm", "_spd_inv"),
    ("fitting.lbfgs", "_strong_wolfe"),
    ("fitting.lbfgs", "_direction"),
    ("fitting.gradient", "_update"),
    ("ops.vposer_kernel", "decode_jac_batched"),
    ("ops.joint_kernel", "joint_jacobian_batched"),
    ("fitting.initialize", "init_guess"),
)


def _wrap_layers():
    import importlib
    for mod_name, fn_name in LAYERS:
        mod = importlib.import_module("mvsmplfitting_tpu_torch." + mod_name)
        fn = getattr(mod, fn_name)

        def wrapped(*a, __fn=fn, __name=f"{mod_name}.{fn_name}", **kw):
            with record_function(__name):
                return __fn(*a, **kw)
        functools.update_wrapper(wrapped, fn)
        setattr(mod, fn_name, wrapped)
    # Modules that imported a layer by name keep their own reference.
    from mvsmplfitting_tpu_torch.fitting import (initialize, lm,
                                                 multi_person, stages)
    from mvsmplfitting_tpu_torch.parallel import batched
    batched.init_guess = initialize.init_guess
    batched.fit_frame = stages.fit_frame
    multi_person.init_guess = initialize.init_guess
    multi_person.fit_frame = stages.fit_frame
    multi_person.ad_jacobian = lm.ad_jacobian
    stages.ad_jacobian = lm.ad_jacobian
    # The points refinement's closed-form Jacobian is a closure of
    # `make_points_forms`: time the closures it returns.
    make = multi_person.make_points_forms

    def make_points_forms(*a, **kw):
        residual_fn, jac_fn = make(*a, **kw)

        def timed(fn, name):
            def inner(*x, **k):
                with record_function(name):
                    return fn(*x, **k)
            return inner
        return (timed(residual_fn, "points_forms.residual_fn"),
                timed(jac_fn, "points_forms.jac_fn"))
    multi_person.make_points_forms = make_points_forms
    from mvsmplfitting_tpu_torch.parallel import schur
    schur._spd_inv = lm._spd_inv
    schur.ad_jacobian = lm.ad_jacobian


def _category(name: str) -> str:
    if "joint_jacobian_kernel" in name:
        return "joint_jacobian kernel"
    if "vposer_tail_kernel" in name:
        return "vposer_tail kernel"
    if "sdf_" in name and "_kernel" in name:
        return "voxelizer kernels"
    low = name.lower()
    if "sort" in low:
        return "sorts"
    if "gemm" in low or "gemv" in low or "cutlass" in low or "dot" in low:
        return "matmul (cuBLAS)"
    if "reduce" in low:
        return "reductions"
    if "elementwise" in low or "vectorized" in low or "unrolled" in low:
        return "elementwise"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=512)
    ap.add_argument("--iters", type=int, default=None,
                    help="iterations per stage (default: LM 40, L-BFGS "
                    "120, adam 150)")
    ap.add_argument("--classic", action="store_true",
                    help="classic LM (speculative=False) for the B-frame fit")
    ap.add_argument("--fused", action="store_true",
                    help="FitConfig.fused for the B-frame fit")
    ap.add_argument("--solver", choices=("lm", "lbfgs", "adam"),
                    default="lm", help="the B-frame fit's solver: LM, or "
                    "chip_smoke.py [lbfgs]'s (smpllsp, parity options) or "
                    "[grad]'s (adam) configuration")
    ap.add_argument("--model", choices=("smpl", "smplh", "smplx"),
                    default="smpl", help="the B-frame LM fit's body model "
                    "(smplh/smplx: chip_smoke.py [smplh]/[smplx]'s spec)")
    ap.add_argument("--schur", action="store_true",
                    help="profile the shared-shape sequence fit instead")
    ap.add_argument("--multi", action="store_true",
                    help="profile the two-person collision fit instead")
    ap.add_argument("--grid", type=int, default=128,
                    help="collision grid size of --multi (grid engine)")
    ap.add_argument("--engine", choices=("grid", "points"), default="grid",
                    help="collision engine of --multi")
    ap.add_argument("--points-jac", choices=("ad", "analytic"),
                    default="ad", help="refinement Jacobian of --engine "
                    "points")
    ap.add_argument("--trace", default=None,
                    help="write the Chrome trace of the profiled fit here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_fit: needs a CUDA GPU", file=sys.stderr)
        return 2

    _wrap_layers()
    from mvsmplfitting_tpu_torch.device import resolve_device
    from mvsmplfitting_tpu_torch.fitting.lm import LMOptions
    from mvsmplfitting_tpu_torch.fitting.stages import FitConfig, FitResult
    from mvsmplfitting_tpu_torch.parallel.batched import (
        BatchedFitInputs, batched_fit_frames)
    from mvsmplfitting_tpu_torch.synthetic import make_problem

    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__}), flush=True)

    if args.multi:
        from mvsmplfitting_tpu_torch.fitting.energy import EnergySpec
        from mvsmplfitting_tpu_torch.fitting.multi_person import fit_people
        from mvsmplfitting_tpu_torch.synthetic import make_people_problem
        B = 2
        assets, vw, cam, obs = make_people_problem(0.2, device=dev)
        if args.engine == "grid":
            cfg = FitConfig(
                spec=EnergySpec(interpenetration=True,
                                coll_grid_size=args.grid),
                pose_weights=(404.0, 404.0, 57.4, 4.78),
                shape_weights=(100.0, 50.0, 10.0, 5.0),
                coll_weights=(0.0, 0.0, 1000.0, 4500.0),
                lm=LMOptions(max_iters=60))
        else:
            cfg = FitConfig(spec=EnergySpec(interpenetration=True),
                            lm=LMOptions(max_iters=40))

        def fit():
            res, _ = fit_people(cfg, assets, cam, obs, vposer_w=vw,
                                sdf_engine=args.engine,
                                points_jac=args.points_jac, device=dev)
            torch.cuda.synchronize()
            return res
    elif args.schur:
        from mvsmplfitting_tpu_torch.fitting.initialize import init_guess
        from mvsmplfitting_tpu_torch.parallel.schur import schur_sequence_fit
        from mvsmplfitting_tpu_torch.synthetic import make_person_sequence
        B = args.frames
        assets, vw, cam, obs, _ = make_person_sequence(B, seed=0, device=dev)
        cfg = FitConfig(lm=LMOptions(max_iters=args.iters or 40))

        def fit():
            g = init_guess(assets, cam, obs.gt2d, obs.conf, obs.view_mask)
            _, _, losses, _, iters = schur_sequence_fit(
                cfg, assets, cam, obs, g.params, g.z, vposer_w=vw,
                device=dev)
            torch.cuda.synchronize()
            return FitResult(params=None, z=None, body_pose=None,
                             loss=losses, stage_losses=None,
                             lm_iters=torch.tensor([iters]))
    else:
        from mvsmplfitting_tpu_torch.fitting.energy import EnergySpec
        from mvsmplfitting_tpu_torch.fitting.gradient import GradientOptions
        from mvsmplfitting_tpu_torch.fitting.lbfgs import LBFGSOptions
        B = args.frames
        model = "smpllsp" if args.solver == "lbfgs" else args.model
        assets, vw, cam, obs = make_problem(6, B, seed=0, device=dev,
                                            model_type=model)
        batch = BatchedFitInputs(obs, torch.full((B,), 1080.0, device=dev))
        if args.solver == "lbfgs":
            cfg = FitConfig(solver="lbfgs", coll_weights=(0.0,) * 4,
                            lbfgs=LBFGSOptions(max_iters=args.iters or 120))
        elif args.solver == "adam":
            cfg = FitConfig(solver="adam", grad=GradientOptions(
                lr=1e-2, max_iters=args.iters or 150))
        else:
            spec = EnergySpec(**{
                "smpl": {}, "smplh": dict(hand_dim=6),
                "smplx": dict(hand_dim=6, num_expr=10, opt_face=True),
            }[model])
            cfg = FitConfig(spec=spec,
                            lm=LMOptions(max_iters=args.iters or 40,
                                         speculative=not args.classic),
                            fused=args.fused)

        def fit():
            res = batched_fit_frames(cfg, assets, cam, batch, vposer_w=vw,
                                     device=dev)
            torch.cuda.synchronize()
            return res

    fit()                                                  # warm-up
    t0 = time.perf_counter()
    res = fit()
    wall = time.perf_counter() - t0
    # --multi: the refinement's iterations (the solo fits' are not kept);
    # --schur: the sequence's LM iterations.
    iters = int(res.lm_iters.amax(dim=0).sum().item())
    print(json.dumps({"timed": {
        "frames": B, "wall_s": wall, "fps": B / wall, "lm_iterations": iters,
        "ms_per_iteration": 1e3 * wall / iters,
        "final_loss_mean": float(res.loss.mean().item())}}), flush=True)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fit()
        prof_wall = time.perf_counter() - t0
    events = prof.key_averages()

    def dev_self(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    layer_names = {f"{m}.{f}" for m, f in LAYERS} | {
        "points_forms.residual_fn", "points_forms.jac_fn"}
    # Device activity (kernels, copies) has no host time of its own; the
    # host ops that launched it and the layer ranges are left out.
    kernels = [e for e in events if dev_self(e) > 0
               and e.cpu_time_total == 0 and e.key not in layer_names]
    busy_us = sum(dev_self(e) for e in kernels)
    cats = {}
    for e in kernels:
        c = _category(e.key)
        cats[c] = cats.get(c, 0.0) + dev_self(e)
    print(json.dumps({"profiled": {
        "wall_s": prof_wall, "device_busy_s": busy_us / 1e6,
        "device_busy_share": busy_us / 1e6 / prof_wall,
        "device_ms_by_category": {k: v / 1e3 for k, v in sorted(
            cats.items(), key=lambda kv: -kv[1])}}}), flush=True)
    top = sorted(kernels, key=lambda e: -dev_self(e))[:15]
    print(json.dumps({"top_device_ops": [
        {"name": e.key[:90], "device_ms": dev_self(e) / 1e3,
         "calls": e.count} for e in top]}), flush=True)
    print(json.dumps({"layers": [
        {"name": e.key, "calls": e.count,
         "host_ms": e.cpu_time_total / 1e3,
         "device_ms": getattr(e, "device_time_total",
                              getattr(e, "cuda_time_total", 0.0)) / 1e3}
        for e in events if e.key in layer_names
        and e.cpu_time_total > 0]}), flush=True)
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
