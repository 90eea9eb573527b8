"""Stage timing, structured run logging and the profiler hook (port of
``graphlap_tpu/utils/timing.py``).

``StageTimer`` accumulates named wall-clock spans (PETSc's -log_view
stages), ``log_run`` appends one JSON record a run to the file it is
given, and ``maybe_profile`` wraps a block in ``torch.profiler`` (CPU and,
where a card is present, CUDA activities) and writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path


class StageTimer:
    """Accumulates named wall-clock spans (PetscLogStagePush/Pop analogue)."""

    def __init__(self):
        self.walls: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.walls[name] = self.walls.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.walls.values())
        lines = [f"{'stage':<12} {'seconds':>9}  {'share':>6}"]
        for k, v in sorted(self.walls.items(), key=lambda kv: -kv[1]):
            share = v / total if total else 0.0
            lines.append(f"{k:<12} {v:9.4f}  {share:5.1%}")
        lines.append(f"{'total':<12} {total:9.4f}")
        return "\n".join(lines)


def log_run(record: dict, path: Path | str) -> None:
    """Append one structured JSON record to ``path`` (its folder made)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    record = dict(record)
    record.setdefault("ts", time.time())
    with path.open("a") as f:
        f.write(json.dumps(record) + "\n")


@contextlib.contextmanager
def maybe_profile(trace_dir: str | None):
    """Wrap a block in ``torch.profiler.profile`` when a directory is given,
    and write its Chrome trace there as ``trace.json``."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))
