"""Host ms per call spent in ``MultiStreamRecognizer.process_batch``, from
the call to its return: the step's enqueue, on the host clock, mean over
the timed window's calls (outside the profiler)."""


def read(run):
    spans = run.spans.get("multistream.process_batch")
    return None if spans is None or not len(spans) else float(spans.mean() * 1e3)
