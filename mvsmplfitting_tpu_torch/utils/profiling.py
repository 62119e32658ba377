"""Profiling and structured metrics (port of `utils/profiling.py`).

Device-synchronized stage timers, `torch.profiler` traces on demand and
a structured metrics sink (JSON lines).  CUDA work is asynchronous, so a
timer given a CUDA tensor synchronizes its device before it stops the
clock.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch


@dataclass
class StageTimer:
    """Device-synchronized named timers."""

    timings: Dict[str, List[float]] = field(default_factory=dict)
    events: Dict[str, list] = field(default_factory=dict)

    @contextlib.contextmanager
    def time(self, name: str, sync_value=None):
        """Context manager; pass a tensor as `sync_value` (or set
        ``box["sync"]`` inside) to wait for its device before stopping
        the clock."""
        t0 = time.perf_counter()
        box = {}
        try:
            yield box
        finally:
            v = box.get("sync", sync_value)
            if isinstance(v, torch.Tensor) and v.is_cuda:
                torch.cuda.synchronize(v.device)
            self.timings.setdefault(name, []).append(
                time.perf_counter() - t0)

    @contextlib.contextmanager
    def device(self, name: str, device: torch.device):
        """CUDA events around the block on `device`'s current stream
        (nothing on the CPU); `device_totals` reads them."""
        if device.type != "cuda":
            yield
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end.record()
            self.events.setdefault(name, []).append((start, end))

    def device_totals(self) -> Dict[str, float]:
        """Device seconds per name, summed over the `device` blocks."""
        if self.events:
            torch.cuda.synchronize()
        return {k: sum(s.elapsed_time(e) for s, e in v) / 1e3
                for k, v in self.events.items()}

    def summary(self) -> Dict[str, float]:
        return {k: sum(v) / len(v) for k, v in self.timings.items() if v}

    def totals(self) -> Dict[str, float]:
        return {k: sum(v) for k, v in self.timings.items()}


@contextlib.contextmanager
def trace_profile(log_dir: Optional[str]):
    """A `torch.profiler` trace (CPU, and CUDA where there is a card)
    written to `log_dir/trace.json` when `log_dir` is set; no-op
    otherwise."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Metrics:
    """Append-only JSON-lines metrics sink."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def log(self, **kv) -> None:
        kv.setdefault("ts", time.time())
        line = json.dumps(kv, default=float)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")
        else:
            print(line)


def set_seed(seed: int = 0) -> torch.Generator:
    """Determinism helper (`module_utils.py:51-63` analogue): seeds numpy
    and torch's global generators and returns a fresh `torch.Generator`
    seeded with `seed`."""
    import numpy as np

    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def conv_flops(model: torch.nn.Module, *inputs) -> int:
    """Floating-point operations (2 per multiply-add) of the convolutions,
    transposed convolutions and dense layers of one `model(*inputs)`
    call, counted from the shapes each layer sees (forward hooks); the
    call runs once, without gradients.  A deformable convolution counts
    its contraction as the dense convolution of the same shape."""
    from ..detect.deform_conv import DeformConv2d
    total = [0]

    def hook(mod, args, out):
        x = args[0]
        if isinstance(mod, DeformConv2d):
            w = mod.weight
            total[0] += 2 * out.numel() * w.shape[1] * w.shape[2] * w.shape[3]
        elif isinstance(mod, torch.nn.Conv2d):
            k = mod.kernel_size[0] * mod.kernel_size[1]
            total[0] += 2 * out.numel() * (mod.in_channels // mod.groups) * k
        elif isinstance(mod, torch.nn.ConvTranspose2d):
            k = mod.kernel_size[0] * mod.kernel_size[1]
            total[0] += (2 * x.numel() * (mod.out_channels // mod.groups)
                         * k)
        else:
            total[0] += 2 * out.numel() * mod.in_features

    kinds = (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.Linear,
             DeformConv2d)
    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, kinds)]
    try:
        with torch.inference_mode():
            model(*inputs)
    finally:
        for h in handles:
            h.remove()
    return total[0]
