"""The transforms' share of their roofline, in %: the least time of their
counted work (``roofline.transform_work``: plan-free, from length, batch and
coset) over their device time by the benchmark's CUDA events around each
transform call."""

import roofline


def read(rec):
    calls = rec["timed"]["transform"]
    ms = sum(t for t, _ in calls)
    if not ms:
        return None
    return 100.0 * sum(roofline.least_ms(*roofline.transform_work(*w)) for _, w in calls) / ms
