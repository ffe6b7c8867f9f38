"""The window's seconds over the prover rounds it completed (host clock)."""


def read(rec):
    return rec["window_s"] / rec["rounds"] if rec["rounds"] else None
