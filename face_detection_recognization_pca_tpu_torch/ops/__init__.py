"""Compute ops: resize, similarity, DFT correlation and the fused match kernel."""
