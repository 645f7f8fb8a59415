"""Tracing / profiling / metrics (counterpart of
mixmogam_tpu/utils/profiling.py): per-phase timers, throughput metrics, a
torch.profiler hook, and a JSON metrics artifact per run."""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Any, Dict, Optional

logger = logging.getLogger("mixmogam_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter(
        "%(asctime)s %(name)s %(levelname)s %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(os.environ.get("MIXMOGAM_LOGLEVEL", "INFO"))
    # we attached our own handler; propagating to root would print
    # every line twice under logging.basicConfig()/pytest capture
    logger.propagate = False


class RunMetrics:
    """Per-run phase timings + throughput metrics, dumpable to JSON.

    A phase must end on host values (the facade's all do: a parsed
    matrix, a float64 kinship, a scan's p-values), so that the copy from
    the device has waited for its kernels; a phase that leaves work queued
    on the card would have it counted in the next one."""

    def __init__(self, run_name: str = "run"):
        self.run_name = run_name
        self.phases: Dict[str, float] = {}
        self.metrics: Dict[str, Any] = {}
        self._t0 = time.time()

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            self.phases[name] = self.phases.get(name, 0.0) + dt
            logger.info("phase %-12s %8.3f s", name, dt)

    def set(self, key: str, value) -> None:
        self.metrics[key] = value

    def throughput(self, key: str, count: int, phase: str) -> float:
        rate = count / max(self.phases.get(phase, 0.0), 1e-12)
        self.metrics[key] = rate
        return rate

    def as_dict(self) -> Dict[str, Any]:
        return {"run": self.run_name, "total_s": time.time() - self._t0,
                "phases_s": {k: round(v, 4) for k, v in self.phases.items()},
                "metrics": self.metrics}

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.as_dict(), f, indent=2, default=float)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """torch.profiler trace (CPU, and CUDA when there is a card) around a
    region, written as a Chrome trace to log_dir/trace_<pid>.json (open in
    chrome://tracing or Perfetto); no-op when log_dir is None."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}.json"))
