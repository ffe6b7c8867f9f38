"""Device ms a prover round spends in its transform calls, by the
benchmark's CUDA events around each."""


def read(rec):
    calls = rec["timed"]["transform"]
    return sum(t for t, _ in calls) / rec["rounds"] if calls and rec["rounds"] else None
