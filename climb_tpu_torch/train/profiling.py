"""``--profile_dir`` and ``--memory_profile`` over one task's train steps
(the counterpart of ``climb_tpu/train/trainers.py:455-481``).

- ``--profile_dir``: ``torch.profiler`` over global steps 6-10 (started when
  5 steps are done, stopped after the 10th, as JAX's trace is), recording CPU
  activity, and CUDA activity on the card; written as a Chrome-trace JSON,
  ``<dir>/<task>.pt.trace.json`` (chrome://tracing or Perfetto). A task of
  fewer steps writes what the window recorded when its loop ends. The trace
  carries the port's ``climb.*`` spans (``utils/tracing.py``) as
  ``user_annotation`` ranges: each step's phases (``climb.train_step``,
  ``climb.forward``, ``climb.backward``, ``climb.optimizer``, ...), the wait
  on the loader (``climb.data_wait``), the copies to the card
  (``climb.h2d_copy``) and the logging that waits for the device
  (``climb.log``).
- ``--memory_profile``: what is live on the card after step 5, as a CUDA
  memory snapshot (``torch.cuda.memory._dump_snapshot``: PyTorch's pickle
  format, not JAX's pprof), recorded from the trainer's start so that the
  step's allocations carry their Python stacks; view it with
  ``python -m torch.cuda._memory_viz`` or pytorch.org/memory_viz. On the CPU
  it warns and writes nothing, as JAX's trainer does where its backend
  cannot profile. Each task writes the same path, so the last task's
  snapshot stays.

Under torchrun each rank writes its own files (``.rank<r>`` after the name).
"""

import logging
import os
from typing import Optional

import torch

logger = logging.getLogger(__name__)

PROFILE_START, PROFILE_STOP = 5, 10  # steps done when the trace starts / stops
MEMORY_AT = 5  # steps done when the memory snapshot is written
MEMORY_HISTORY_ENTRIES = 100_000


class StepProfiler:
    def __init__(self, profile_dir, memory_profile, device: torch.device, name: str,
                 rank: Optional[int] = None):
        if rank is not None:
            name = f"{name}.rank{rank}"
            memory_profile = None if memory_profile is None else f"{memory_profile}.rank{rank}"
        self.profile_dir, self.memory_profile = profile_dir, memory_profile
        self.device, self.name = device, name
        self._trace = None
        if memory_profile is not None:
            if device.type == "cuda":
                torch.cuda.memory._record_memory_history(
                    max_entries=MEMORY_HISTORY_ENTRIES, stacks="python")
            else:
                logger.warning("--memory_profile: the CPU has no device memory snapshot; "
                               "nothing is written to %s", memory_profile)
                self.memory_profile = None

    def before_step(self, steps_done: int):
        if self.profile_dir is not None and steps_done == PROFILE_START:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._trace = torch.profiler.profile(activities=activities)
            self._trace.start()

    def after_step(self, steps_done: int):
        if self._trace is not None and steps_done == PROFILE_STOP:
            self._write_trace()
        if self.memory_profile is not None and steps_done == MEMORY_AT:
            torch.cuda.synchronize(self.device)
            os.makedirs(os.path.dirname(self.memory_profile) or ".", exist_ok=True)
            torch.cuda.memory._dump_snapshot(self.memory_profile)
            torch.cuda.memory._record_memory_history(enabled=None)
            logger.info("CUDA memory snapshot -> %s", self.memory_profile)
            self.memory_profile = None

    def close(self):
        """Write a trace the loop left open; stop the memory history."""
        if self._trace is not None:
            self._write_trace()
        if self.memory_profile is not None:
            torch.cuda.memory._record_memory_history(enabled=None)
            self.memory_profile = None

    def _write_trace(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._trace.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        path = os.path.join(self.profile_dir, f"{self.name}.pt.trace.json")
        self._trace.export_chrome_trace(path)
        logger.info("torch.profiler trace -> %s", path)
        self._trace, self.profile_dir = None, None
