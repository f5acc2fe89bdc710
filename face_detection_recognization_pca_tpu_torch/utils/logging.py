"""Structured logging + counters (the port's own copy of the JAX
package's ``utils/logging.py``).

The reference observes itself with ``print()`` lines and ad-hoc
counters (recognition stats and rate at ``useless/scan.py:380,417-427``,
per-person detection counts at ``scan-template-v4.py:456-463``).  This
module provides the same signals as named counters plus a summary
formatter with the reference's wording, on top of standard logging.
"""

from __future__ import annotations

import logging
import sys
from collections import Counter
from typing import Dict

_FORMAT = "%(asctime)s %(name)s %(levelname)s %(message)s"


def get_logger(name: str = "fdrp", level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(h)
        logger.setLevel(level)
        logger.propagate = False
    return logger


class Counters:
    """Named counters with a reference-style summary."""

    def __init__(self) -> None:
        self._c: Counter = Counter()

    def inc(self, name: str, n: int = 1) -> None:
        self._c[name] += n

    def get(self, name: str) -> int:
        return self._c[name]

    def as_dict(self) -> Dict[str, int]:
        return dict(self._c)

    def recognition_summary(self) -> str:
        """Matches the reference's end-of-run stats block
        (useless/scan.py:417-427)."""
        total = self._c["frames"]
        det = self._c["frames_with_detection"]
        rec = self._c["frames_recognized"]
        rate = (rec / det * 100.0) if det else 0.0
        return (
            f"Total frames processed: {total}\n"
            f"Frames with faces detected: {det}\n"
            f"Frames with recognized faces: {rec}\n"
            f"Recognition rate: {rate:.1f}%"
        )
