"""The device's idle share of the profiled stretch, in %: 1 - (union of its
intervals / the stretch), from torch.profiler (``devtrace.reduce``)."""


def read(rec):
    prof = rec["profile"]
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"]) if prof else None
