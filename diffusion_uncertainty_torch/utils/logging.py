"""Text logging and the JSON metrics sink of the CLIs.

JAX counterpart: ``diffusion_uncertainty_tpu/utils/logging.py``
(``get_logger``, ``MetricsSink``, ``Timer``, :24-65): stdlib logging for
text, result files as JSON lists of records, appended to by every run, and
a wall-clock timer.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from pathlib import Path
from typing import Any

__all__ = ["get_logger", "MetricsSink", "Timer"]

_FORMAT = "%(asctime)s %(levelname).1s %(name)s] %(message)s"


def get_logger(name: str = "du_torch", level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        logger.addHandler(h)
        logger.setLevel(level)
        logger.propagate = False
    return logger


class MetricsSink:
    """Append records (with a ``ts`` timestamp) to a JSON file holding a list
    of records; an unreadable file starts a new list."""

    def __init__(self, path: str | Path):
        self.path = Path(path)

    def append(self, record: dict[str, Any]) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        records: list[dict[str, Any]] = []
        if self.path.exists():
            try:
                records = json.loads(self.path.read_text())
            except json.JSONDecodeError:
                records = []
        records.append({"ts": time.time(), **record})
        self.path.write_text(json.dumps(records, indent=1))


class Timer:
    """Wall-clock context manager (``elapsed`` seconds after the block);
    call ``torch.cuda.synchronize()`` before the block ends to time work on
    the card."""

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.start
