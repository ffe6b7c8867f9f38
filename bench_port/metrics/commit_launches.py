"""Kernel launches a commit call makes, counted in the profiled stretch (a
round of the commit mixes is one call; copies and fills not counted)."""


def read(rec):
    prof = rec["profile"]
    return prof["launches"] / prof["rounds"] if prof else None
