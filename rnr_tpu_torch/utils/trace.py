"""Step timing and tracing (port of rnr_tpu/utils/trace.py).

`StepTimer` times steps: on the card by CUDA events recorded around the
step (`stop` waits for the end event), on the CPU by the host clock.
`trace_context` runs `torch.profiler` over a scope and writes a Chrome
trace into a log directory.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


class StepTimer:
    """Per-step times in seconds and their summary.  device: the device the
    steps run on; a CUDA device times them by events on its current
    stream, anything else by the host clock."""

    def __init__(self, device=None):
        self.times: list[float] = []
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self._t0 = None

    def start(self) -> None:
        if self.cuda:
            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t0.record()
        else:
            self._t0 = time.perf_counter()

    def stop(self) -> float:
        """End the interval: on the card, wait for the work queued since
        `start` and take the events' time."""
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            dt = self._t0.elapsed_time(end) / 1e3
        else:
            dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    @contextlib.contextmanager
    def measure(self):
        self.start()
        yield
        self.stop()

    def summary(self, skip_warmup: int = 1) -> dict:
        t = np.asarray(self.times[skip_warmup:] or self.times)
        return {"mean_s": float(t.mean()),
                "p50_s": float(np.percentile(t, 50)),
                "p90_s": float(np.percentile(t, 90)),
                "steps": len(t)}


@contextlib.contextmanager
def trace_context(log_dir: str, enabled: bool = True):
    """torch.profiler over the scope (CPU, and CUDA where a card is
    present); the Chrome trace goes to `log_dir/trace.json`."""
    if not enabled:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
