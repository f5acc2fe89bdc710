"""Host-clock ms per 16-frame batch of ``HaarDetector.detect_multi_scale_batch``
(the device half, the download of the accepted windows and the grouping
on the host), recorded by the proxy the benchmark passes as the scan's
``detector``; mean over the timed window (outside the profiler)."""


def read(run):
    spans = run.spans.get("haar.detect")
    return None if spans is None or not len(spans) else float(spans.mean() * 1e3)
