"""The 95th percentile, by nearest rank, of every commit call of the window,
each timed from the call until its affine points are on the host (host
clock)."""

import math


def read(rec):
    lat = sorted(rec["commit_latency_s"])
    if not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3
