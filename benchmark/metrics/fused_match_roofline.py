"""The fused match's share of its roofline: the least time its work needs
on the card (``roofline.fused_match``: B crops of the template's pixels,
k components, N gallery rows) over the time its two kernels
(``fused_match_products``, then ``fused_match_finish``) cover together
per call in the profiled window, in %.  Prints which bound applies."""

import sys

from benchmark import roofline
from benchmark.timeline import union_s


def read(run):
    tl = run.timeline
    calls = len(tl.kernels("fused_match_products")) if tl is not None else 0
    if not calls:
        return None
    bound = roofline.fused_match(run.traffic["streams"], run.config["template"] ** 2,
                                 run.config["components"], run.config["gallery"])
    print(f"fused_match_roofline: the bound is {bound.seconds * 1e6:.3f} us per call, by "
          f"{bound.by}", file=sys.stderr)
    return 100.0 * bound.seconds * calls / union_s(tl.kernels("fused_match_"))
