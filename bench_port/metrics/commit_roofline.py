"""The commit's share of its roofline, in %: the least time of the calls'
counted work (``roofline.commit_work``: plan-free, from N and the batch)
over their device time by the benchmark's CUDA events around each MSM call."""

import roofline


def read(rec):
    calls = rec["timed"]["msm"]
    ms = sum(t for t, _ in calls)
    if not ms:
        return None
    return 100.0 * sum(roofline.least_ms(*roofline.commit_work(n)) for _, n in calls) / ms
