"""Host-clock ms per call outside the detector's span: the frames' copy to
the card and gray, the host crops, one recognition per face (each waits
for its result) and the records; the call's time less its detector span,
mean over the timed window."""


def read(run):
    calls, detect = run.spans.get("bench.call"), run.spans.get("haar.detect")
    if calls is None or detect is None or len(calls) != len(detect):
        return None
    return float((calls - detect).mean() * 1e3)
