"""Time the keypoint detector's forward on one GPU in each precision.

    python3 tools/time_detector.py [--views 6] [--reps 3]

YOLOX-X at the reference's 800x1440 letterbox on a batch of `--views`
random frames (weights from seed 0, the BaseConv convolutions at half
gain as `chip_smoke.py` [keypoints] sets them): CUDA-event milliseconds
per batch and TFLOP/s (conv FLOPs counted from the modules' shapes) in
fp32 with TF32 off (the port's math), with and without cuDNN's
autotuner, NCHW and channels-last; in TF32; and in bfloat16. Then the
fp32 forward's ten largest device kernels (`torch.profiler`).  Prints
the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from mvsmplfitting_tpu_torch.detect.weights import random_state_dict  # noqa
from mvsmplfitting_tpu_torch.detect.yolox import YOLOX  # noqa: E402
from mvsmplfitting_tpu_torch.device import (resolve_device,  # noqa: E402
                                            set_fp32_math)
from mvsmplfitting_tpu_torch.utils.profiling import conv_flops  # noqa


def event_ms(fn, reps: int) -> float:
    with torch.inference_mode():
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--views", type=int, default=6)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    dev = resolve_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    sd = random_state_dict(YOLOX(), torch.Generator().manual_seed(0))
    for k in sd:
        if k.endswith(".conv.weight"):
            sd[k] *= 0.5
    model = YOLOX().eval()
    model.load_state_dict(sd)
    model = model.to(dev)
    x = 255 * torch.rand(args.views, 3, 800, 1440, device=dev,
                         generator=torch.Generator(dev).manual_seed(0))
    flops = args.views * conv_flops(YOLOX().to("meta"), torch.zeros(
        1, 3, 800, 1440, device="meta"))
    nhwc = torch.channels_last
    runs = []

    def run(name, m, inp, tf32=False, bench=False):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cudnn.benchmark = bench
        ms = event_ms(lambda: m(inp), args.reps)
        set_fp32_math()
        torch.backends.cudnn.benchmark = False
        runs.append(name)
        print(f"{name}: {ms:.2f} ms for {args.views} views, "
              f"{flops / ms / 1e9:.2f} TFLOP/s", flush=True)

    run("fp32_nchw", model, x)
    run("fp32_nchw_cudnn_benchmark", model, x, bench=True)
    m_nhwc = model.to(memory_format=nhwc)
    x_nhwc = x.contiguous(memory_format=nhwc)
    run("fp32_nhwc", m_nhwc, x_nhwc)
    run("fp32_nhwc_cudnn_benchmark", m_nhwc, x_nhwc, bench=True)
    model = model.to(memory_format=torch.contiguous_format)
    run("tf32_nchw", model, x, tf32=True)
    m16 = model.to(torch.bfloat16)
    run("bf16_nchw", m16, x.to(torch.bfloat16))

    from torch.profiler import ProfilerActivity, profile
    m32 = m16.float()
    with torch.inference_mode():
        m32(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            m32(x)
            torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total",
                                    row_limit=10, max_name_column_width=70))
    return 0


if __name__ == "__main__":
    sys.exit(main())
