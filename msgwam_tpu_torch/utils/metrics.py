"""Structured metrics / progress logging.

Replaces the reference's single carriage-return progress print
(``raytracer.py:191``) with a cadence-controlled logger that can emit
human-readable lines and/or JSONL records of the scientific observables
(flux profiles, wind extrema, active-ray counts)."""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import Optional


class MetricsLogger:
    def __init__(
        self,
        total_steps: int,
        every: int = 50,
        jsonl_path: Optional[str] = None,
        logger: Optional[logging.Logger] = None,
    ):
        self.total_steps = total_steps
        self.every = max(1, every)
        self.jsonl = open(jsonl_path, "a") if jsonl_path else None
        self.log = logger or logging.getLogger("msgwam_tpu_torch")
        self._t0 = time.time()
        self._last_t = self._t0
        self._last_step = 0

    def record(self, step: int, **scalars) -> None:
        if step % self.every and step != self.total_steps:
            return
        now = time.time()
        dsteps = max(1, step - self._last_step)
        rate = dsteps / max(1e-9, now - self._last_t)
        self._last_t, self._last_step = now, step
        payload = {
            "step": step,
            "progress": step / self.total_steps,
            "steps_per_sec": rate,
            "elapsed_sec": now - self._t0,
            **{k: float(v) for k, v in scalars.items()},
        }
        if self.jsonl:
            self.jsonl.write(json.dumps(payload) + "\n")
            self.jsonl.flush()
        self.log.info(
            "step %d/%d (%.1f%%) %.1f steps/s %s",
            step, self.total_steps, 100 * payload["progress"], rate,
            " ".join(f"{k}={v:.4g}" for k, v in scalars.items()),
        )

    def progress_print(self, step: int) -> None:
        """The reference's exact progress line (``raytracer.py:191``)."""
        print(
            "progress: {0:.2f}%".format(step / self.total_steps * 100),
            end="\r", file=sys.stdout,
        )

    def close(self) -> None:
        if self.jsonl:
            self.jsonl.close()
