"""The one traffic generator: reads a traffic mix (``traffic/<name>.json``)
and a configuration (``configs/<name>.json``) and makes, from the seed, every
input that the mix's rounds use.

A mix is data only.  ``inputs`` names pools of Fr vectors: ``columns``
vectors of 2^``log_n`` elements a set (``log_n`` is a key of the
configuration), ``sets`` sets drawn once and cycled through, round i taking
set i mod ``sets``.  ``round`` lists the steps of one closed-loop round (one
caller, each step awaited): ``rounds.py`` says what each ``op`` does.
``sample_rounds`` is how many rounds of a window the reference recomputes
whole; ``profile_rounds`` how many rounds a traced run profiles.

Every seed gets the same sizes and the same steps: only the values change.
The bases are ``distinct_bases`` multiples k_j G of the G1 generator
(16-bit k_j from the seed, made on the host), tiled to 2^``srs_log_n``
points.  The pools are drawn on the device in one call each: limbs below
2^16, the top limb below 2^14, so every value is a canonical Montgomery
image below 2^254 < r.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from reference import fr, g1

HERE = Path(__file__).resolve().parent
SEED_BITS = 63


@dataclass
class Inputs:
    ks: torch.Tensor | None = None            # (m,) int64, on the host
    bases: tuple | None = None                # affine (x, y, inf) limbs on the device
    pools: dict = field(default_factory=dict)  # name -> (sets, 16, columns, n) int32
    zh_inv: torch.Tensor | None = None        # (16, n_ext) int32, Montgomery
    coset_shift: int = fr.GENERATOR


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def seed_words(seed: int, stream: int) -> list[int]:
    """Any whole number, negative or above 2^63 too, as a numpy seed."""
    return [seed % (1 << SEED_BITS), int(seed < 0), stream]


def device_seed(seed: int, stream: int) -> int:
    return int(np.random.default_rng(seed_words(seed, stream)).integers(0, 1 << SEED_BITS))


def ops_of(traffic: dict) -> set:
    return {step["op"] for step in traffic["round"]}


def fq_mont_limbs(values) -> np.ndarray:
    out = np.empty((g1.FQ_LIMBS, len(values)), dtype=np.int32)
    for j, v in enumerate(values):
        m = v * g1.FQ_MONT % g1.P
        for i in range(g1.FQ_LIMBS):
            out[i, j] = (m >> (16 * i)) & 0xFFFF
    return out


def multiples(ks) -> list:
    """k G for each k of ``ks`` (affine): walked in increasing order, each
    the last plus (k - k_last) G from a table of small multiples."""
    table = [g1.IDENTITY, g1.from_affine(g1.G)]
    for _ in range(2, 256):
        table.append(g1.add(table[-1], table[1]))
    jac, last, acc = {}, 0, g1.IDENTITY
    for k in sorted(set(int(k) for k in ks)):
        d = k - last
        acc = g1.add(acc, table[d] if d < len(table) else g1.scalar_mul(d))
        jac[k], last = acc, k
    order = sorted(jac)
    aff = dict(zip(order, g1.to_affine_many([jac[k] for k in order])))
    return [aff[int(k)] for k in ks]


def make_bases(ks: np.ndarray, log_n: int, device):
    """k_j G for each k of ``ks``, tiled to 2^log_n affine points."""
    pts = multiples(ks)
    x = torch.from_numpy(fq_mont_limbs([p[0] for p in pts])).to(device)
    y = torch.from_numpy(fq_mont_limbs([p[1] for p in pts])).to(device)
    n = 1 << log_n
    reps = -(-n // len(pts))
    return (x.repeat(1, reps)[:, :n].contiguous(), y.repeat(1, reps)[:, :n].contiguous(),
            torch.zeros(n, dtype=torch.bool, device=device))


def make_pool(spec: dict, config: dict, seed: int, stream: int, device) -> torch.Tensor:
    n = 1 << config[spec["log_n"]]
    gen = torch.Generator(device=device)
    gen.manual_seed(device_seed(seed, stream))
    pool = torch.randint(0, 1 << 16, (spec["sets"], fr.LIMBS, spec["columns"], n),
                         generator=gen, dtype=torch.int32, device=device)
    pool[:, fr.LIMBS - 1] &= (1 << 14) - 1
    return pool


def make_inputs(traffic: dict, config: dict, seed: int, device) -> Inputs:
    inputs = Inputs(coset_shift=config["coset_shift"])
    ops = ops_of(traffic)
    if "commit" in ops:
        rng = np.random.default_rng(seed_words(seed, 0))
        ks = rng.choice(np.arange(1, 1 << 16), size=config["distinct_bases"], replace=False)
        inputs.ks = torch.from_numpy(ks.astype(np.int64))
        inputs.bases = make_bases(ks, config["srs_log_n"], device)
    for stream, (name, spec) in enumerate(sorted(traffic["inputs"].items()), start=1):
        inputs.pools[name] = make_pool(spec, config, seed, stream, device)
    if "gate" in ops:
        vals = fr.vanishing_inverse(config["domain_log_n"], config["extended_log_n"],
                                    config["coset_shift"])
        col = torch.from_numpy(np.stack([np.array([(v >> (16 * i)) & 0xFFFF
                                                   for i in range(fr.LIMBS)], dtype=np.int32)
                                         for v in vals], axis=1))
        reps = (1 << config["extended_log_n"]) // len(vals)
        inputs.zh_inv = col.to(device).repeat(1, reps).contiguous()
    return inputs
