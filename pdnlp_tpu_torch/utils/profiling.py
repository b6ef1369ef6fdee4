"""Profiling and step rates (``pdnlp_tpu/utils/profiling.py``).

- :class:`Profiler` wraps a window of training steps in a
  ``torch.profiler`` trace (host and, on the card, CUDA activity) written
  as a Chrome trace under ``--profile_dir``; the window skips the first
  steps, so the trace shows steady state, not the kernels' build.  A
  captured step's replay shows as one graph launch: its device time is the
  graph's, not split kernel by kernel.
- :class:`StepStats` turns the epoch's wall clock into the rates line.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

from pdnlp_tpu_torch.utils.logging import rank0_print


class Profiler:
    """Trace steps ``[start, start + steps)`` of training into
    ``profile_dir``."""

    def __init__(self, profile_dir: Optional[str], start_step: int = 10,
                 num_steps: int = 10):
        self.dir = profile_dir
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self._prof = None
        self._done = False
        self.path: Optional[str] = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def step(self, gstep: int) -> None:
        """Call once per dispatch with the global step count.  Boundary
        crossings, not equality, so a K-step dispatch that jumps over
        ``start_step`` or ``stop_step`` still opens or closes the window;
        one that jumps the whole window opens it for the next dispatch."""
        if not self.dir or self._done:
            return
        if gstep >= self.start_step and self._prof is None:
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            try:
                self._prof = torch.profiler.profile(activities=acts)
                self._prof.__enter__()
            except Exception as e:     # a build without profiler support
                rank0_print(f"[profiler] trace unavailable: {e}")
                self._prof, self.dir = None, None
                return
            rank0_print(f"[profiler] tracing from step {gstep} (window "
                        f"{self.start_step}..{self.stop_step}) -> {self.dir}")
        elif gstep >= self.stop_step and self._prof is not None:
            self.close()

    def close(self) -> None:
        """Stop the trace and write ``trace_proc<rank>.pt.trace.json``."""
        if self._prof is None:
            return
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        self._done = True
        os.makedirs(self.dir, exist_ok=True)
        rank = (torch.distributed.get_rank()
                if torch.distributed.is_available()
                and torch.distributed.is_initialized() else 0)
        self.path = os.path.join(self.dir, f"trace_proc{rank}.pt.trace.json")
        prof.export_chrome_trace(self.path)


@dataclasses.dataclass
class StepStats:
    """Rates of the timed epoch(s)."""

    steps: int
    examples: int
    minutes: float

    @property
    def steps_per_second(self) -> float:
        return self.steps / (self.minutes * 60) if self.minutes else 0.0

    @property
    def examples_per_second(self) -> float:
        return self.examples / (self.minutes * 60) if self.minutes else 0.0

    def line(self) -> str:
        return (f"steps/s：{self.steps_per_second:.2f}  "
                f"samples/s：{self.examples_per_second:.1f}")
