"""Device ms a prover round spends in its MSM calls, by the benchmark's CUDA
events around each."""


def read(rec):
    calls = rec["timed"]["msm"]
    return sum(t for t, _ in calls) / rec["rounds"] if calls and rec["rounds"] else None
