"""Whole runs on the CPU at a small size: sound, they come out correct; with
the timed path broken underneath, or with the control in the program's
place, ``correct`` comes out false.

Each fault is one that its cell can have: a step that returns its state
unchanged, half of the batch left out, an answer altered where it is
produced.  (No cell has an exchange between chips.)  The sizes are small
(2^6 points and rows, the extended domain 2^8, 16 distinct bases); the
program runs its plain versions on the CPU.
"""

import time

import pytest
import torch

import generator
import harness
from port import PortSystem
from reference.system import ControlSystem

SMALL = {"srs_log_n": 6, "domain_log_n": 6, "extended_log_n": 8, "distinct_bases": 16}


class StateUnchanged(PortSystem):
    """The MSM's accumulator never leaves the identity; the coset transform
    returns its input."""

    def msm(self, scalars):
        X, Y, Z = super().msm(scalars)
        return X, Y, torch.zeros_like(Z)

    def coset_ntt(self, x):
        return x


class HalfLeftOut(PortSystem):
    """Half of the scalars (one set) or of the sets (a batch) left out; the
    gate with half of its columns left out."""

    def msm(self, scalars):
        if scalars.shape[1] > 1:
            half = super().msm(scalars[:, :scalars.shape[1] // 2])
            return tuple(torch.cat((c, c), dim=-1) for c in half)
        cut = scalars.clone()
        cut[..., scalars.shape[-1] // 2:] = 0
        return super().msm(cut)

    def gate(self, ext):
        mul, FR = self._vecops.vector_mul, self._fr
        return mul(FR, mul(FR, ext[:, 0], ext[:, 1]), self.zh_inv).unsqueeze(1)


class Altered(PortSystem):
    """One limb of a result flipped where it is produced."""

    def to_host(self, P):
        out = super().to_host(P)
        out[0, 0] ^= 1
        return out

    def coset_intt(self, x):
        y = super().coset_intt(x).clone()
        y[0, 0, 5] ^= 1
        return y


def run(cell, system_cls=None, columns=None):
    spec = harness.load_spec()
    c = harness.find_cell(spec, cell)
    config = {**harness.load_config(spec, c), **SMALL}
    traffic = generator.load_traffic(c["traffic"])
    for pool in traffic["inputs"].values():
        pool["sets"] = 2
        if columns and pool["columns"] > columns:
            pool["columns"] = columns
    return harness.run_cell(cell, 2 ** 31 + 77, 0.0, False, "cpu", t_start=time.perf_counter(),
                            spec=spec, config=config, traffic=traffic, system_cls=system_cls)


CASES = [
    ("plonk-k20.commit", None, True), ("plonk-k20.commit", StateUnchanged, False),
    ("plonk-k20.commit", HalfLeftOut, False), ("plonk-k20.commit", Altered, False),
    ("plonk-k20.commit", ControlSystem, False),
    ("plonk-k16.batch_commit", None, True), ("plonk-k16.batch_commit", HalfLeftOut, False),
    ("plonk-k16.batch_commit", StateUnchanged, False), ("plonk-k16.batch_commit", Altered, False),
    ("plonk-k16.batch_commit", ControlSystem, False),
    ("plonk-k20.quotient", None, True), ("plonk-k20.quotient", StateUnchanged, False),
    ("plonk-k20.quotient", HalfLeftOut, False), ("plonk-k20.quotient", Altered, False),
    ("plonk-k20.quotient", ControlSystem, False),
    ("plonk-k20.prove_round", None, True), ("plonk-k20.prove_round", Altered, False),
    ("plonk-k20.prove_round", ControlSystem, False),
]


@pytest.mark.parametrize("cell,system_cls,sound", CASES,
                         ids=[f"{c}-{s.__name__ if s else 'sound'}" for c, s, _ in CASES])
def test_a_run_is_correct_only_when_sound(cell, system_cls, sound):
    result = run(cell, system_cls, columns=4)
    assert result["correct"] is sound, result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    if not sound:
        assert any(c["value"] > c["limit"] for c in result["checks"].values())
    assert list(result)[-2:] == ["checks", "_compared"]


def test_a_round_that_raises_is_failed_and_not_correct():
    class Raises(PortSystem):
        calls = 0

        def coset_ntt(self, x):
            Raises.calls += 1
            if Raises.calls > 1:                     # the warm round passes
                raise RuntimeError("planted")
            return super().coset_ntt(x)

    result = run("plonk-k20.quotient", Raises)
    assert result["correct"] is False and result["failed"] == 1
    assert result["checks"]["failed_rounds"]["value"] == 1
