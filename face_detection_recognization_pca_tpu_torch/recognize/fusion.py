"""Decision fusion policies of the live v4 scanner, as pure functions.

Reference semantics (``scan-template-v4.py:352-401``):

* multi-face arbitration: ``0.5 * min(area / 200^2, 1) + 0.5 * pca_conf``
  picks one detection when template matching fires more than once;
* name fusion: keep the template-matching identity when PCA agrees or
  PCA is weak (< 0.5); otherwise trust PCA; force "unknown" whenever
  PCA < 0.8 or template < 0.7.

And the v1 dual-model OR rule (``useless/scan.py:134-166``): recognize
with the dark and light models independently, keep the higher
confidence.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from face_detection_recognization_pca_tpu_torch.config import RecognizeConfig

UNKNOWN = "unknown"


def arbitration_score(
    width: float,
    height: float,
    pca_confidence: float,
    cfg: Optional[RecognizeConfig] = None,
) -> float:
    """Size/PCA combined score (scan-template-v4.py:367-371)."""
    cfg = cfg or RecognizeConfig()
    normalized_size = min(
        (width * height) / float(cfg.size_norm * cfg.size_norm), 1.0
    )
    return normalized_size * cfg.size_weight + pca_confidence * cfg.pca_weight


def fuse_template_pca(
    template_name: str,
    template_confidence: float,
    pca_name: str,
    pca_confidence: float,
    cfg: Optional[RecognizeConfig] = None,
) -> Tuple[str, float]:
    """Name fusion rules (scan-template-v4.py:391-401).

    Returns (final_name, final_confidence); the confidence reported is
    the one backing the chosen identity, even when the identity is then
    forced to "unknown" (matching the reference's drawing/logging).
    """
    cfg = cfg or RecognizeConfig()
    if pca_name == template_name or pca_confidence < cfg.pca_low_confidence:
        final_name, final_conf = template_name, template_confidence
    else:
        final_name, final_conf = pca_name, pca_confidence
    if pca_confidence < cfg.pca_gate or template_confidence < cfg.template_gate:
        final_name = UNKNOWN
    return final_name, final_conf


def dual_model_or(
    results: Sequence[Tuple[int, str, float]]
) -> Tuple[int, str, float]:
    """v1 dual dark/light OR logic: best confidence wins
    (useless/scan.py:134-166)."""
    best = (-1, UNKNOWN, 0.0)
    for r in results:
        if r[2] > best[2]:
            best = r
    return best


def annotation_filter(
    name: str,
    confidence: float,
    width: float,
    height: float,
    cfg: Optional[RecognizeConfig] = None,
) -> bool:
    """v1 drawing filter (useless/scan.py:270-330): drop low-confidence
    unknowns and boxes smaller than 200x200."""
    cfg = cfg or RecognizeConfig()
    if name == UNKNOWN and confidence < cfg.min_unknown_confidence:
        return False
    if width < cfg.min_annotation_box or height < cfg.min_annotation_box:
        return False
    return True
