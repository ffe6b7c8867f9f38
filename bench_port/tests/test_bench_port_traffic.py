"""The generator: seeded, the same sizes for every seed, canonical values;
every mix and configuration that BENCHMARK.json names is there and valid."""

import json
from pathlib import Path

import pytest
import torch

import generator
import harness
from reference import fr, g1
from rounds import TRANSFORM_OPS, Tally, run_round

ROOT = Path(__file__).resolve().parents[2]
OPS = set(TRANSFORM_OPS) | {"commit", "gate", "pad", "split"}
SMALL = {"srs_log_n": 6, "domain_log_n": 6, "extended_log_n": 8, "distinct_bases": 16}


def spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def small(cell):
    s = spec()
    c = harness.find_cell(s, cell)
    config = {**harness.load_config(s, c), **SMALL}
    return config, generator.load_traffic(c["traffic"])


def test_every_cell_has_its_files_and_valid_steps():
    s = spec()
    for c in s["workloads"]:
        config = harness.load_config(s, c)
        traffic = generator.load_traffic(c["traffic"])
        names = set(traffic["inputs"])
        for step in traffic["round"]:
            assert step["op"] in OPS and step["in"] in names
            names.add(step.get("out", step["in"]))
        for pool in traffic["inputs"].values():
            assert pool["log_n"] in config and pool["sets"] >= 1
        assert config["reduced"] == []
    for cfg in s["configs"]:
        assert generator.load_json(ROOT / cfg["file"])["name"] == cfg["name"]


@pytest.mark.parametrize("cell", ["plonk-k20.commit", "plonk-k20.prove_round"])
def test_equal_seeds_give_equal_inputs(cell):
    config, traffic = small(cell)
    seed = 2 ** 31 + 12345
    a = generator.make_inputs(traffic, config, seed, "cpu")
    b = generator.make_inputs(traffic, config, seed, "cpu")
    c = generator.make_inputs(traffic, config, -seed, "cpu")
    assert torch.equal(a.ks, b.ks) and all(torch.equal(x, y) for x, y in zip(a.bases, b.bases))
    for name in a.pools:
        assert torch.equal(a.pools[name], b.pools[name])
        assert a.pools[name].shape == c.pools[name].shape
        assert not torch.equal(a.pools[name], c.pools[name])
    assert not torch.equal(a.ks, c.ks)


def test_values_are_canonical_and_bases_are_the_multiples():
    config, traffic = small("plonk-k20.prove_round")
    inp = generator.make_inputs(traffic, config, 99, "cpu")
    for pool in inp.pools.values():
        flat = pool.permute(1, 0, 2, 3).reshape(fr.LIMBS, -1)
        assert int(flat.min()) >= 0 and int(flat.max()) < 1 << 16
        assert max(fr.ints_of(flat[:, :64])) < fr.R
        assert int(pool[:, fr.LIMBS - 1].max()) < 1 << 14
    assert len(set(inp.ks.tolist())) == config["distinct_bases"]
    x, y, inf = inp.bases
    assert x.shape == (24, 1 << config["srs_log_n"]) and not inf.any()
    for j in (0, 5, 16 + 5):
        k = int(inp.ks[j % len(inp.ks)])
        got = [sum(int(t[i, j]) << (16 * i) for i in range(24)) * pow(g1.FQ_MONT, -1, g1.P) % g1.P
               for t in (x, y)]
        assert tuple(got) == g1.multiple(k)
    zh = fr.vanishing_inverse(config["domain_log_n"], config["extended_log_n"])
    assert fr.ints_of(inp.zh_inv[:, :8]) == zh + zh


def test_a_round_through_the_reference_follows_the_mix():
    from reference.system import ReferenceSystem

    config, traffic = small("plonk-k20.prove_round")
    inp = generator.make_inputs(traffic, config, 5, "cpu")
    tally = Tally()
    out = run_round(ReferenceSystem(inp), traffic, inp, config, 3, tally, keep=True)
    assert sorted(out.points) == [0, 7, 8] and list(out.kept) == [5]
    assert [p.shape[1] for p in out.points.values()] == [4, 4, 1]
    assert out.kept[5].shape == (16, 1, 1 << config["extended_log_n"])
    n, ext = 1 << config["domain_log_n"], 1 << config["extended_log_n"]
    assert tally.transform_elems == 4 * n + 4 * ext + ext
    assert tally.commit_points == 9 * n and len(tally.commit_latency_s) == 3
    # Round 3 takes set 3 mod 4 of each pool.
    assert torch.equal(run_round(ReferenceSystem(inp), traffic, inp, config, 7, Tally()).points[8],
                       out.points[8])
