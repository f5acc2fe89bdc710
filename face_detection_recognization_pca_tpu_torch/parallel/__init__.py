"""Multi-stream serving."""
