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
