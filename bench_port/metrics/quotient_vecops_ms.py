"""Device ms a round spends in its gate's ``vector_mul`` and ``vector_add``
calls, by the benchmark's CUDA events around the gate."""


def read(rec):
    calls = rec["timed"]["vecops"]
    return sum(t for t, _ in calls) / rec["rounds"] if calls and rec["rounds"] else None
