"""On a card: a short run of each cell is correct and prints the result line
run.py documents, and the control at the cell's own size is found not
correct on three seeds.  Skipped where there is no card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
CELLS = ["plonk-k20.commit", "plonk-k20.quotient", "plonk-k16.batch_commit",
         "plonk-k20.prove_round"]


def _run(script, *args):
    proc = subprocess.run([sys.executable, str(BENCH / script), *args], capture_output=True,
                          text=True, timeout=1200, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct(card, cell):
    for trace in ("0", "1"):
        out = _run("run.py", "--workload", cell, "--seed", "4294967311", "--seconds", "2",
                   "--trace", trace)[-1]
        assert out["correct"] is True and out["failed"] == 0
        assert list(out)[-1] == "checks" and out["metrics"]
        assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
        if trace == "1":
            assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_at_the_cells_size_is_not_correct(card, cell):
    seeds = [a for s in ("11", "2147483659", "9007199254740993") for a in ("--seed", s)]
    lines = _run("control.py", "--workload", cell, "--seconds", "5", *seeds)
    assert len(lines) == 3 and not any(line["correct"] for line in lines)
