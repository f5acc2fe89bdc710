"""Frame annotation (host-side cv2 drawing).

Reproduces the reference's overlay styles:

* v4 live scanner: green box for recognized, red for unknown, label
  ``"{name} (T:{t:.2f}, P:{p:.2f})"`` above the box
  (``scan-template-v4.py:405-410``);
* guided video scanner: ``"{name} ({conf:.2f})"`` label
  (``scripts/manual/scan-template-v2.py:552-561``);
* v1 dual scanner: square red box of side max(w, h), cyan label when
  recognized (``useless/scan.py:270-330``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

GREEN = (0, 255, 0)
RED = (0, 0, 255)
CYAN = (255, 255, 0)


def draw_v4(
    frame: np.ndarray,
    box: Tuple[int, int, int, int],
    name: str,
    template_conf: float,
    pca_conf: float,
) -> None:
    import cv2

    x, y, w, h = box
    color = GREEN if name != "unknown" else RED
    cv2.rectangle(frame, (x, y), (x + w, y + h), color, 2)
    label = f"{name} (T:{template_conf:.2f}, P:{pca_conf:.2f})"
    cv2.putText(
        frame, label, (x, y - 10), cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 2
    )


def draw_guided(
    frame: np.ndarray,
    box: Tuple[int, int, int, int],
    name: str,
    confidence: float,
) -> None:
    import cv2

    x, y, w, h = box
    color = GREEN if name != "unknown" else RED
    cv2.rectangle(frame, (x, y), (x + w, y + h), color, 2)
    cv2.putText(
        frame,
        f"{name} ({confidence:.2f})",
        (x, y - 10),
        cv2.FONT_HERSHEY_SIMPLEX,
        0.5,
        color,
        2,
    )


def draw_live_guided(
    frame: np.ndarray,
    box: Tuple[int, int, int, int],
    name: str,
    confidence: float,
    template_conf: float,
) -> None:
    """Guided live overlay: ``"{name} ({conf:.2f}) TM:{tm:.2f}"`` in 0.6pt
    (``scripts/manual/scan-template-v2.py:401-408``)."""
    import cv2

    x, y, w, h = box
    color = GREEN if name != "unknown" else RED
    cv2.rectangle(frame, (x, y), (x + w, y + h), color, 2)
    label = f"{name} ({confidence:.2f}) TM:{template_conf:.2f}"
    cv2.putText(
        frame, label, (x, y - 10), cv2.FONT_HERSHEY_SIMPLEX, 0.6, color, 2
    )


def draw_v1_square(
    frame: np.ndarray,
    box: Tuple[int, int, int, int],
    name: Optional[str],
    confidence: float,
) -> None:
    import cv2

    x, y, w, h = box
    side = max(w, h)
    cx, cy = x + w // 2, y + h // 2
    x0, y0 = cx - side // 2, cy - side // 2
    cv2.rectangle(frame, (x0, y0), (x0 + side, y0 + side), RED, 2)
    if name and name != "unknown":
        cv2.putText(
            frame,
            f"{name} ({confidence:.2f})",
            (x0, y0 - 10),
            cv2.FONT_HERSHEY_SIMPLEX,
            0.6,
            CYAN,
            2,
        )
