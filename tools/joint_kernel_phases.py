"""Where the joint-Jacobian kernel's time goes, phase by phase, on one GPU.

    python3 tools/joint_kernel_phases.py [--batches 8,512]

Builds variants of `mvsmplfitting_tpu_torch/csrc/joint_jacobian.cu`
that return after each phase (a block returns before the comment line
that opens the next phase; the chain block's phases are cut inside its
own branch) and times each variant with `chip_smoke.cuda_ms` on the
same seeded inputs, for smpl and smpllsp.  Before it returns, a
variant reads all of its block's shared memory into a store that never
happens, so the compiler keeps every phase before the cut.  The
difference between consecutive variants is that phase's share of the
kernel's time: at B=8 one tile (one block per slot, a block's latency),
at B=512 the whole grid.  smpllsp has no chain slots, so its numbers
are the vertex blocks' alone; smpl's include the chain block, which
runs in full when only the vertex path is cut.  Prints one JSON line per
model and batch: the cumulative ms per cut, then the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# (name, the source line the cut goes before); vertex path, then chain.
CUTS = (
    ("rodrigues", "  // ---- rest joints = j0 + JB beta"),
    ("rest joints", "  // ---- kinematic chain:"),
    ("chain walk", "  const float* W = s_W + f * J * 12;"),
    ("betas", "    // offsets[f][col] = sum_q in[q][f] fold[v]"),
    ("fold", "  const float* h0 = c.H0 + ((size_t)v * J + j) * 4;"),
    ("contributions", "  // ---- joints and scale column (vertex"),
    ("joints", "  // ---- pose-corrective product P[f][a]"),
    ("pose-corrective", "  // ---- pose and orient block"),
    ("chain: joints", "    // This thread's generators;"),
    ("chain: generators", "    float* s_T = smem;    // [f][l][a][bt]"),
    ("chain: beta terms", "    // A chain joint's beta block"),
    ("chain: beta sums", "    // Output rows, a warp per row"),
    ("chain: beta rows", "    float* s_G = smem;    // [f][l][A][12]"),
    ("chain: staged generators", "    for (int fe = 0; fe < F && b0 + fe < B;"),
)
KEEP = ("{ float sum_ = 0.0f; for (int i_ = threadIdx.x; i_ < SMEM_FLOATS; "
        "i_ += THREADS) sum_ += smem[i_]; if (B < 0) joints[threadIdx.x] = "
        "sum_; return; }")


def variant_source(src: str, cut: int) -> str:
    """The source with a return before CUTS[cut]'s line (cut = len(CUTS):
    the whole kernel, with the same shared-memory read at its end)."""
    if cut == len(CUTS):
        end = src.index("}\n\n}  // namespace")
        return src[:end] + f"  {KEEP}\n" + src[end:]
    line = CUTS[cut][1]
    if src.count(line) != 1:
        raise SystemExit(f"cut line not found once in the source: {line!r}")
    at = src.index(line)
    return src[:at] + f"  {KEEP}\n" + src[at:]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", default="8,512")
    args = ap.parse_args()
    import numpy as np
    import torch

    import chip_smoke
    from mvsmplfitting_tpu_torch.models.assets import synthetic_smpl
    from mvsmplfitting_tpu_torch.models.joint_model import with_joint_model
    from mvsmplfitting_tpu_torch.ops import cuda_build
    from mvsmplfitting_tpu_torch.ops import joint_kernel as JK

    if not torch.cuda.is_available():
        print("joint_kernel_phases: needs a CUDA GPU", file=sys.stderr)
        return 2
    src = (cuda_build.CSRC_DIR / "joint_jacobian.cu").read_text()
    names = [c[0] for c in CUTS] + ["whole"]
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for i in range(len(names)):
            cu = os.path.join(tmp, f"v{i}.cu")
            with open(cu, "w") as fh:
                fh.write(variant_source(src, i))
            so = os.path.join(tmp, f"libv{i}.so")
            procs.append((i, so, subprocess.Popen(
                [cuda_build.nvcc_path(), *cuda_build.flags("joint_jacobian"),
                 "-I", str(cuda_build.CSRC_DIR), "-o", so, cu],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        for i, so, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise SystemExit(f"nvcc failed for cut {names[i]}:\n{out}")
            libs[i] = JK.bind(ctypes.CDLL(so))

        dev = torch.device("cuda", 0)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rng = np.random.default_rng(0)
        for model_type in ("smpl", "smpllsp"):
            jm = with_joint_model(synthetic_smpl(model_type,
                                                 device=dev)).joint_model
            tb = JK.kernel_tables(jm, dev)
            for B in (int(b) for b in args.batches.split(",")):
                theta, betas, scale = (torch.as_tensor(
                    a, dtype=torch.float32, device=dev) for a in (
                        rng.normal(0, 0.4, (B, 72)),
                        rng.normal(0, 1.0, (B, 10)),
                        rng.uniform(0.7, 1.5, (B,))))
                ms = {}
                for i, name in enumerate(names):
                    ms[name] = chip_smoke.cuda_ms(
                        lambda: JK.call(libs[i], tb, theta, betas, scale,
                                        stream), reps=50)
                print(json.dumps({"model": model_type, "B": B,
                                  "cumulative_ms": ms}), flush=True)
    print(chip_smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
