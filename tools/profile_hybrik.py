"""Where the time of HybrIK's SMPL regression goes, on one GPU.

    python3 tools/profile_hybrik.py [--people 4] [--reps 10] [--trace PATH]

Builds `detect.predictor.SmplPoseEstimator` (256x256 crops, weights from
seed 0, the synthetic SMPL body) on the card and runs `regress` (the
net) and `bodies` (uvd to xyz, the twist-and-swing IK and the skinning)
on `--people` random crops: the first call of each (cold: library
handles, cuDNN's choice), then the median of `--reps` calls (host clock
around synchronized work), then one call of each under
`torch.profiler`.  Prints one JSON object per line: the card, the cold
and steady seconds, the host and device time of the profiled `bodies`
call, and its top ops by host time and by device time.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def timed(fn, reps: int):
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def top(events, key: str, n: int = 12):
    rows = sorted(events, key=lambda e: getattr(e, key), reverse=True)[:n]
    return [{"op": e.key, "calls": e.count,
             "host_ms": round(e.self_cpu_time_total / 1e3, 3),
             "device_ms": round(e.self_device_time_total / 1e3, 3)}
            for e in rows]


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--people", type=int, default=4)
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--trace", default=None)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("profile_hybrik: needs a CUDA GPU", file=sys.stderr)
        return 2
    from mvsmplfitting_tpu_torch.detect.predictor import SmplPoseEstimator
    dev = torch.device("cuda")
    print(json.dumps({"card": card(), "torch": torch.__version__}))
    est = SmplPoseEstimator(device=dev)
    crops = torch.rand((args.people, 3, 256, 256),
                       generator=torch.Generator().manual_seed(0)).to(dev)
    out = {}

    def net():
        out.update(est.regress(crops))

    def ik():
        est.bodies(out)

    cold = {}
    for name, fn in (("net", net), ("ik", ik)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        cold[name] = time.perf_counter() - t0
    steady = {name: timed(fn, args.reps) for name, fn in (("net", net),
                                                          ("ik", ik))}
    print(json.dumps({"people": args.people, "cold_s": cold,
                      "steady_s": steady}))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ik()
        torch.cuda.synchronize()
    events = prof.key_averages()
    host = sum(e.self_cpu_time_total for e in events) / 1e3
    device = sum(e.self_device_time_total for e in events) / 1e3
    print(json.dumps({"bodies_profiled": {"host_ms": round(host, 3),
                                          "device_ms": round(device, 3),
                                          "ops": sum(e.count
                                                     for e in events)}}))
    print(json.dumps({"top_by_host": top(events, "self_cpu_time_total")}))
    print(json.dumps({"top_by_device": top(events,
                                           "self_device_time_total")}))
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
