"""Scalars committed over the window's seconds: N times the batch for every
commit call that completed in the window (host clock)."""


def read(rec):
    if not rec["commit_calls"]:
        return None
    return rec["commit_points"] / rec["window_s"]
