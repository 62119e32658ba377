"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero):
  1. device and environment: torch version, card name and power limit,
     TF32 off;
  2. build: both CUDA kernels from `mvsmplfitting_tpu_torch/csrc` with
     nvcc for sm_90a, in parallel, with the seconds it took;
  3. kernels at B=512: each kernel against its plain PyTorch version on
     the card (joint Jacobian for smpl and smpllsp at RTOL 3e-5 / ATOL
     1e-5; VPoser tail at z~N(0,0.6) and z~N(0,1e-3), aa at 3e-5 / 1e-5,
     D at 3e-4 / 3e-4 max|D|), with device times per call (CUDA events
     around queued calls; the tail's is the larger of its two batches)
     and bounds;
  4. short fit parity: an 8-frame batched fit (init + 4 stages, chol,
     classic LM, 3 iterations) on the card and on the CPU plain path,
     stage losses at rtol 1e-3;
  5. the slice at full width: `batched_fit_frames` on 512 distinct
     synthetic frames (6 views, smpl, library defaults, max_iters=40),
     launch counters reset just before and read just after;
then the card line, the kernels JSON line and the result line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# Published H100 SXM peaks used for the bounds (dense, full power).
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
B_KERNEL = 512
B_FIT = 512


def log(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device milliseconds per call of `fn`: one event pair around `reps`
    calls, with the stream held by a spin kernel while the host queues
    them all, so the host's launch time does not show as device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # Spin twice the host's queueing time (at up to 2 GHz SM clock).
    torch.cuda._sleep(int(2 * host_s * 2e9) + 1000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def joint_kernel_work(jm, tables, B: int):
    """(bytes, flops) the joint-Jacobian function needs for B frames:
    inputs and the kernel's constant tables read once, outputs written
    once; multiply-adds that touch a non-zero constant only: the rest
    joints take the fold's JB columns, the Kv vertex slots the fold's
    full rows, the pose-corrective and beta products; chain slots take
    their joint's ancestors only.  Rodrigues and other per-joint scalar
    work (a few hundred operations per frame) is left out."""
    from mvsmplfitting_tpu_torch.models.joint_jac import _ancestry
    J, K, NB, Kv = 24, tables.K, tables.NB, tables.Kv
    P9 = 9 * (J - 1)
    anc = _ancestry(jm.parents)
    chain = (jm.chain_mask > 0).cpu().numpy()
    cidx = jm.chain_idx.cpu().numpy()
    macs = 3 * J * NB + Kv * 3 * J * (NB + P9)                # fold
    macs += J * 12 * 3                                        # chain walk
    macs += J * 3 * 27 + J * 9 * (9 + 9 + 6)                  # generators
    for k in range(K):
        if chain[k]:
            n_anc = int(anc[:, cidx[k]].sum())
            macs += 3 * n_anc * 3 * 4                         # pose/orient
            macs += 3 * NB * n_anc * 4                        # betas
        else:
            macs += J * 3 * 4 + J * 3 * J + J * 3             # contrib, Y
            macs += 3 * J * 3 * 4                             # rigid pose
            macs += 3 * (J - 1) * 9 * (3 * J + 3)             # corrective
            macs += 3 * NB * (3 * J + J * 4)                  # betas
    io = B * (3 * J + NB + 1) + B * (K * 3 * (1 + 3 * J + NB + 1))
    return tables.nbytes() + 4.0 * io, 2.0 * B * macs


def vposer_tail_work(B: int):
    """(bytes, flops): o and Do read, aa and D written; the 6-term
    composition per D element plus the dual-number tail (about 90
    operations on 7-float duals per joint)."""
    nbytes = 4.0 * B * (138 + 138 * 32 + 69 + 69 * 32)
    flops = 2.0 * B * 69 * 32 * 6 + B * 23 * 90 * 14
    return nbytes, flops


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA GPU", file=sys.stderr)
        return 2

    from mvsmplfitting_tpu_torch.device import resolve_device
    from mvsmplfitting_tpu_torch.fitting.lm import LMOptions
    from mvsmplfitting_tpu_torch.fitting.stages import FitConfig
    from mvsmplfitting_tpu_torch.models import vposer as V
    from mvsmplfitting_tpu_torch.models.assets import synthetic_smpl
    from mvsmplfitting_tpu_torch.models.joint_model import with_joint_model
    from mvsmplfitting_tpu_torch.ops import cuda_build
    from mvsmplfitting_tpu_torch.ops import joint_kernel as JK
    from mvsmplfitting_tpu_torch.ops import vposer_kernel as VK
    from mvsmplfitting_tpu_torch.parallel.batched import (
        BatchedFitInputs, batched_fit_frames)
    from mvsmplfitting_tpu_torch.synthetic import VPOSER_NPZ, make_problem

    # ---- 1. device and environment --------------------------------
    dev = resolve_device("cuda")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    card = card_line()
    log("device", torch=torch.__version__, cuda=torch.version.cuda,
        name=repr(torch.cuda.get_device_name(0)), nvidia_smi=repr(card),
        tf32="off")

    # ---- 2. build --------------------------------------------------
    t0 = time.perf_counter()
    logs = cuda_build.build()
    for name in cuda_build.KERNEL_SOURCES:
        cuda_build.load(name)
    ptxas = [ln.strip() for text in logs.values() for ln in text.splitlines()
             if "registers" in ln or "spill" in ln]
    log("build", seconds=f"{time.perf_counter() - t0:.2f}",
        sources=",".join(cuda_build.KERNEL_SOURCES),
        ptxas=repr(" | ".join(ptxas)))

    # ---- 3. kernels against their plain versions, B=512 -----------
    rng = np.random.default_rng(0)
    B = B_KERNEL
    kernels = {}

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    jj_err, jj_ms, jj_plain, jj_bound = 0.0, None, None, None
    for model_type in ("smpl", "smpllsp"):
        jm = with_joint_model(synthetic_smpl(model_type,
                                             device=dev)).joint_model
        theta = t(rng.normal(0, 0.4, (B, 72)))
        betas = t(rng.normal(0, 1.0, (B, 10)))
        scale = t(rng.uniform(0.7, 1.5, (B,)))
        gj, gb = JK.joint_jacobian_cuda(jm, theta, betas, scale)
        torch.cuda.synchronize()
        wj, wb = JK.joint_jacobian_plain(jm, theta, betas, scale)
        torch.testing.assert_close(gj, wj, rtol=3e-5, atol=1e-5)
        err = (gj - wj).abs().max().item()
        for k in wb:
            torch.testing.assert_close(gb[k], wb[k], rtol=3e-5, atol=1e-5,
                                       msg=f"{model_type} block {k}")
            err = max(err, (gb[k] - wb[k]).abs().max().item())
        ms = cuda_ms(lambda: JK.joint_jacobian_cuda(jm, theta, betas, scale))
        plain = cuda_ms(lambda: JK.joint_jacobian_plain(jm, theta, betas,
                                                        scale), reps=10)
        bnd, by = bound_ms(*joint_kernel_work(
            jm, JK.kernel_tables(jm, dev), B))
        log("kernel", name="joint_jacobian", model=model_type, B=B,
            max_abs_err=f"{err:.3e}", ms=f"{ms:.4f}",
            plain_ms=f"{plain:.4f}", bound_ms=f"{bnd:.5f}", bound_by=by)
        jj_err = max(jj_err, err)
        if model_type == "smpl":   # the main path's model
            jj_ms, jj_plain, jj_bound = ms, plain, (bnd, by)
    kernels["joint_jacobian"] = dict(
        name="joint_jacobian", route="cuda",
        source="mvsmplfitting_tpu_torch/csrc/joint_jacobian.cu",
        replaces="mvsmplfitting_tpu/ops/joint_kernel.py:503",
        max_abs_err=jj_err, ms=jj_ms, plain_ms=jj_plain,
        bound_ms=jj_bound[0], bound_by=jj_bound[1], library_ms=None)

    # Timed on both batches (the near-identity one takes one Shepperd
    # branch in every thread); the larger time is reported.
    w = V.load_npz(VPOSER_NPZ, device=dev)
    vt_err, vt_ms, vt_plain = 0.0, 0.0, 0.0
    vt_bound = bound_ms(*vposer_tail_work(B))
    for sigma in (0.6, 1e-3):
        z = t(rng.normal(0, sigma, (B, 32)))
        o, Do = V.mlp_head(w, z)
        o, Do = o.contiguous(), Do.contiguous()
        aa1, D1 = VK.tail_cuda(o, Do)
        torch.cuda.synchronize()
        aa0, D0 = VK.tail_plain(o, Do)
        torch.testing.assert_close(aa1, aa0, rtol=3e-5, atol=1e-5)
        sc = max(D0.abs().max().item(), 1.0)
        torch.testing.assert_close(D1, D0, rtol=3e-4, atol=3e-4 * sc)
        err = max((aa1 - aa0).abs().max().item(),
                  (D1 - D0).abs().max().item())
        ms = cuda_ms(lambda: VK.tail_cuda(o, Do))
        plain = cuda_ms(lambda: VK.tail_plain(o, Do), reps=10)
        log("kernel", name="vposer_tail", z_sigma=sigma, B=B,
            max_abs_err=f"{err:.3e}", ms=f"{ms:.4f}",
            plain_ms=f"{plain:.4f}", bound_ms=f"{vt_bound[0]:.5f}",
            bound_by=vt_bound[1])
        vt_err, vt_ms, vt_plain = (max(vt_err, err), max(vt_ms, ms),
                                   max(vt_plain, plain))
    kernels["vposer_tail"] = dict(
        name="vposer_tail", route="cuda",
        source="mvsmplfitting_tpu_torch/csrc/vposer_tail.cu",
        replaces="mvsmplfitting_tpu/ops/vposer_kernel.py:181",
        max_abs_err=vt_err, ms=vt_ms, plain_ms=vt_plain,
        bound_ms=vt_bound[0], bound_by=vt_bound[1], library_ms=None)

    # ---- 4. short fit parity: card vs CPU plain path ----------------
    short = FitConfig(lm=LMOptions(max_iters=3, linsolve="chol",
                                   speculative=False))
    losses = {}
    for name in ("cuda", "cpu"):
        d = dev if name == "cuda" else "cpu"
        assets, vw, cam, obs = make_problem(6, 8, seed=1, device=d)
        batch = BatchedFitInputs(obs, torch.full((8,), 1080.0, device=d))
        res = batched_fit_frames(short, assets, cam, batch, vposer_w=vw,
                                 device=d)
        losses[name] = res.stage_losses.cpu()
    torch.testing.assert_close(losses["cuda"], losses["cpu"], rtol=1e-3,
                               atol=0.0)
    rel = ((losses["cuda"] - losses["cpu"]).abs()
           / losses["cpu"].abs()).max().item()
    log("parity", frames=8, stage_losses_max_rel=f"{rel:.3e}",
        final_loss_mean=f"{losses['cuda'][:, -1].mean().item():.3f}")

    # ---- 5. the slice at full width ---------------------------------
    assets, vw, cam, obs = make_problem(6, B_FIT, seed=0, device=dev)
    batch = BatchedFitInputs(obs, torch.full((B_FIT,), 1080.0, device=dev))
    cfg = FitConfig(lm=LMOptions(max_iters=40))
    torch.cuda.synchronize()
    JK.LAUNCHES = 0
    VK.LAUNCHES = 0
    t0 = time.perf_counter()
    res = batched_fit_frames(cfg, assets, cam, batch, vposer_w=vw,
                             device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"joint_jacobian": JK.LAUNCHES,
                "vposer_tail": VK.LAUNCHES}
    assert res.stage_losses.shape == (B_FIT, 4)
    assert res.body_pose.shape == (B_FIT, 69)
    assert bool(torch.isfinite(res.stage_losses).all()), "non-finite loss"
    lm_iters = int(res.lm_iters.amax(dim=0).sum().item())
    for name, n in launches.items():
        assert n >= lm_iters, f"{name}: {n} launches < {lm_iters} LM iters"
    losses_np = res.loss.cpu().numpy()
    assert len(np.unique(np.round(losses_np, 3))) > 1, \
        "distinct frames gave identical losses"
    log("fit", frames=B_FIT, views=6, model="smpl",
        fps=f"{B_FIT / wall:.1f}", wall_s=f"{wall:.3f}",
        lm_iterations=lm_iters,
        final_loss_mean=f"{float(losses_np.mean()):.3f}",
        launches=json.dumps(launches).replace(" ", ""))
    for name in kernels:
        kernels[name]["launches"] = launches[name]

    log("done", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(card_line(), flush=True)
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: kv[k] for k in keys}
                                  for kv in kernels.values()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
