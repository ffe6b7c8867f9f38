"""The G1 lane scan of the PyTorch/CUDA port (``cuda_g1.padd_scan``), on the CPU.

On the card the MSM tail's lane scans (the stitch and the triangle) run as
one scan kernel: a thread folds a run of lanes, a block scans the run totals,
a small pass scans the block totals and a last pass walks the runs again.
That is another association than the JAX package's Hillis-Steele steps, so
its sums are the same points with other coordinates.  Here its plain version
``padd_scan_plain``, which follows the kernel's association step by step
(``chip_smoke.py`` holds the kernel to it with ``torch.equal``), is held by
value against the Hillis-Steele scans (``projective.proj_lane_scan``, the
JAX package's order), against the big-int oracle, and, with the router forced
onto it, through a window's tail and whole MSMs against the oracle and the
golden vectors.  The MSM's G1 tile on the card is checked under a stand-in
H100 profile.  Small sizes only: no JAX MSM compile.
"""

import dataclasses
import json
import os
import random

import numpy as np
import pytest
import torch

from tpu_bls12_381_torch import oracle
from tpu_bls12_381_torch.curves import cuda_g1, cuda_g2, g1, projective as pj
from tpu_bls12_381_torch.curves.field_adapters import FQ2_ADAPTER, FQ_ADAPTER, FQ_PLAIN
from tpu_bls12_381_torch.fields import FR
from tpu_bls12_381_torch.fields.limbs import ints_to_limbs
from tpu_bls12_381_torch.msm import msm_geometry, pippenger as pip
from tpu_bls12_381_torch import tuning

torch.set_num_threads(1)

VEC_DIR = os.path.join(os.path.dirname(__file__), "vectors")
MODES = [dict(reverse=r, exclusive=e) for r in (False, True) for e in (False, True)]


@pytest.fixture(scope="module")
def host_points():
    rng = random.Random(0x5CA)
    G = oracle.g1_generator()
    return [oracle.jac_to_affine(
        oracle.scalar_mul(rng.randrange(1, 1 << 40), G, oracle.FQ_OPS),
        oracle.FQ_OPS) for _ in range(48)]


def _proj(points, shape):
    """Projective (24, *shape) points with Z != 1 (doubled affine points)."""
    A = g1.affine_from_ints(points, device="cpu")
    P = pj.proj_double(FQ_PLAIN, pj.affine_to_proj(FQ_PLAIN, A))
    return tuple(c.reshape((24,) + shape).contiguous() for c in P)


def _ints(P):
    """Affine ints (None for the identity) of every lane, rows flattened."""
    return g1.jacobian_to_ints(
        tuple(c.reshape(24, -1) for c in pj.proj_to_jac(FQ_PLAIN, P)))


def _oracle_scan(points, reverse, exclusive):
    """Prefix (suffix) sums of affine points by the big-int oracle."""
    seq = points[::-1] if reverse else points
    acc, out = None, []
    for p in seq:
        before = acc
        acc = oracle.jac_add_affine(acc, p, oracle.FQ_OPS)
        out.append(before if exclusive else acc)
    out = [None if s is None else oracle.jac_to_affine(s, oracle.FQ_OPS) for s in out]
    return out[::-1] if reverse else out


@pytest.mark.parametrize("shape,run,threads,modes", [
    ((13,), 4, None, MODES),             # L not a multiple of the run; all modes
    ((2, 17), 3, 2, MODES[3:]),          # a batch row, 3 blocks, the last part empty
    ((3, 1, 1), 4, None, MODES[:1]),     # two batch axes, L = 1
    ((129,), 1, 1, MODES[1:2]),          # 129 blocks: the carry pass folds runs of 2
])
def test_scan_plain_equals_hillis_steele(host_points, shape, run, threads, modes):
    n = int(np.prod(shape))
    P = _proj((host_points * 3)[:n], shape)
    for mode in modes:
        want = pj.proj_lane_scan(FQ_PLAIN, P, **mode)
        got = cuda_g1.padd_scan_plain(P, run=run, threads=threads, **mode)
        assert all(tuple(c.shape) == tuple(P[0].shape) for c in got)
        assert _ints(got) == _ints(want), mode
    total = cuda_g1.padd_scan_plain(P, total=True, run=run, threads=threads)
    assert tuple(total[0].shape) == (24,) + shape[:-1]
    S = pj.proj_lane_scan(FQ_PLAIN, P, reverse=True)
    assert _ints(total) == _ints(tuple(c[..., 0] for c in S))


@pytest.mark.parametrize("shape", [(2, 13)])   # a batch row, odd L (each shape compiles)
def test_scans_against_the_jax_lane_scans(host_points, shape):
    """The JAX package's G1 lane scans (its pippenger's Hillis-Steele helpers,
    on the CPU) on the same points, in all four modes and the total: the
    port's ``proj_lane_scan`` limb for limb where JAX has the same steps, by
    value where the mode is made of two JAX calls, and ``padd_scan_plain``,
    the kernel's association, by value in every mode."""
    import jax.numpy as jnp

    from tpu_bls12_381.curves.field_adapters import FQ_ADAPTER as JF
    from tpu_bls12_381.msm import pippenger as jpip

    P = _proj((host_points * 3)[:int(np.prod(shape))], shape)
    jP = tuple(jnp.asarray(c.numpy().astype(np.uint32)) for c in P)
    back = lambda T: tuple(torch.from_numpy(np.asarray(c).astype(np.int32)) for c in T)
    excl = jpip._lane_prefix_exclusive(JF, jP)
    suf = jpip._lane_suffix_inclusive(JF, jP)
    jax_scan = {  # (reverse, exclusive) -> (the JAX result, limbs in the port's order)
        (False, True): (excl, True),
        (True, False): (suf, True),
        (True, True): (jpip._shift_dyn(JF, suf, jnp.int32(1), "left"), True),
        (False, False): (jpip.g_add(JF, excl, jP), False),
    }
    for mode in MODES:
        want, same_steps = jax_scan[(mode["reverse"], mode["exclusive"])]
        want = back(want)
        port = pj.proj_lane_scan(FQ_PLAIN, P, **mode)
        if same_steps:
            assert all(torch.equal(a, b) for a, b in zip(port, want)), mode
        assert _ints(port) == _ints(want), mode
        got = cuda_g1.padd_scan_plain(P, run=3, threads=2, **mode)
        assert _ints(got) == _ints(want), mode
    want = back(jpip._sum_last_axis(JF, jP))
    port = tuple(c[..., 0] for c in pj.proj_lane_scan(FQ_PLAIN, P, reverse=True))
    assert all(torch.equal(a, b) for a, b in zip(port, want))
    total = cuda_g1.padd_scan_plain(P, total=True, run=3, threads=2)
    assert _ints(total) == _ints(want)


def test_scan_against_the_oracle_with_identities_and_negatives(host_points):
    """Lanes holding the identity, and P next to -P, against the oracle's
    prefix and suffix sums, inclusive and exclusive."""
    pts = list(host_points[:21])
    pts[0] = pts[4] = pts[20] = None                  # identities, first and last
    pts[9] = (pts[8][0], (-pts[8][1]) % oracle.Q)     # -P right after P
    pts[15] = (pts[3][0], (-pts[3][1]) % oracle.Q)    # -P of an earlier lane
    A = g1.affine_from_ints([p if p is not None else (0, 0) for p in pts], device="cpu")
    A = (A[0], A[1], torch.tensor([p is None for p in pts]))
    P = pj.affine_to_proj(FQ_PLAIN, A)
    for mode in MODES:
        got = cuda_g1.padd_scan_plain(P, run=2, threads=4, **mode)
        assert _ints(got) == _oracle_scan(pts, **mode), mode
    pair = tuple(c[:, 8:10].contiguous() for c in P)
    assert not cuda_g1.padd_scan_plain(pair, total=True)[2].any()   # P + (-P): Z = 0


def test_wrapper_takes_the_plain_version_on_the_cpu_and_checks(host_points):
    P = _proj(host_points[:10], (2, 5))
    for mode in MODES + [dict(total=True)]:
        got = cuda_g1.padd_scan(P, run=2, **mode)
        want = cuda_g1.padd_scan_plain(P, run=2, **mode)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError):
        cuda_g1.padd_scan(P, threads=3)               # not a power of two
    with pytest.raises(ValueError):
        cuda_g1.padd_scan(P, threads=256)             # above the kernel's block
    with pytest.raises(ValueError):
        cuda_g1.padd_scan(tuple(c.transpose(1, 2) for c in P))   # not contiguous
    assert cuda_g1.LAUNCHES["padd_scan"] == 0         # the CPU launches nothing


def test_scan_geometry():
    assert cuda_g1.scan_threads(1) == 1
    assert cuda_g1.scan_threads(13, 4) == 4
    assert cuda_g1.scan_threads(1 << 15) == cuda_g1.SCAN_MAX_THREADS
    # 2^15 lanes: 64 blocks of 128 threads of 4 lanes, one carry block of 64
    assert cuda_g1.scan_geometry(1 << 15, 4, 128) == (64, 64, 1)
    # more blocks than a carry block holds: runs of block totals
    assert cuda_g1.scan_geometry(1 << 18, 4, 128) == (512, 128, 4)


@pytest.fixture
def scan_on_the_cpu(monkeypatch):
    """Route G1 lane scans to ``padd_scan_plain`` for CPU tensors, as they go
    to the kernel on the card, and count the calls as the wrapper counts its
    launches (3 a scan, 2 a total) and the adds."""
    counts = {"padd_scan": 0, "padd": 0}

    def scan(P, **kw):
        counts["padd_scan"] += 2 if kw.get("total") else 3
        return cuda_g1.padd_scan_plain(P, **kw)

    add = pj.proj_add_fast

    def counted_add(F, P, Q):
        counts["padd"] += F is FQ_ADAPTER
        return add(F, P, Q)

    monkeypatch.setattr(pj, "lane_scan_kernel",
                        lambda F, device: scan if F is FQ_ADAPTER else None)
    monkeypatch.setattr(pj, "proj_add_fast", counted_add)
    monkeypatch.setattr(pip, "g_add", counted_add)
    return counts


def test_window_tail_through_the_scan(host_points, scan_on_the_cpu):
    """One window's tail (stitch, boundary, triangle, combine) over a small
    sorted tile through the scan: the signed-digit window sum by the oracle,
    and the plan's 12 scan launches and 5 adds."""
    n, w = 40, 5
    rng = np.random.default_rng(3)
    A = g1.affine_from_ints(host_points[:n], device="cpu")
    abs_d = torch.from_numpy(rng.integers(0, 1 << (w - 1), size=n) + 1).long()
    abs_d[::7] = 0                                    # zero digits: sentinels
    keys = pip._keys_from_digits(abs_d, torch.from_numpy(rng.integers(0, 2, size=n) == 1))
    nb = 1 << (w - 1)
    lb_bits = pip.triangle_lb(nb).bit_length() - 1
    R, L = 5, 8
    em = pip._stage_pack_rows(FQ_ADAPTER, A[0], A[1])
    ks, xr, yr, sr, ir = pip._stage_sort_tile(FQ_ADAPTER, keys, R, L, em, A[2])
    total, prefix = pip._stage_scan(FQ_ADAPTER, xr, yr, sr, ir)
    got = pip._stage_window_tail(FQ_ADAPTER, ks, total, nb, lb_bits, prefix)
    assert scan_on_the_cpu["padd_scan"] == pip.TAIL_SCAN_LAUNCHES
    assert scan_on_the_cpu["padd"] == pip.TAIL_ADDS
    # the window sum by the oracle: sum_i signed digit_i * A_i
    acc = None
    signs = (keys & 1).bool()
    for i in range(n):
        if abs_d[i] == 0:
            continue
        d = int(abs_d[i]) * (-1 if signs[i] else 1) % oracle.R
        acc = oracle.jac_add(acc, oracle.scalar_mul(d, host_points[i], oracle.FQ_OPS),
                             oracle.FQ_OPS)
    want = oracle.jac_to_affine(acc, oracle.FQ_OPS)
    assert _ints(tuple(c[:, None] for c in got)) == [want]


def test_msm_through_the_scan_equals_the_vectors(scan_on_the_cpu, monkeypatch):
    """The golden n = 1024 vector through the MSM, GLV on, in two point
    pieces, with every G1 lane scan on ``padd_scan_plain``: the vector's
    point, and the scan and add counts of the plan (12 scan launches and 5
    adds a window, one add to fold the second piece, T - 1 in Horner)."""
    with open(os.path.join(VEC_DIR, "msm_g1_vectors.json")) as f:
        case = next(c for c in json.load(f)["cases"] if c["n"] == 1024)
    vals = [int(v, 16) for v in case["scalars"]]
    pts = [(int(p["x"], 16), int(p["y"], 16)) for p in case["points"]]
    A = g1.affine_from_ints(pts, device="cpu")
    sv = torch.from_numpy(ints_to_limbs([FR.to_mont(v) for v in vals], 16).astype(np.int32))
    bpp = pip._msm_bytes_per_point(FQ_ADAPTER)
    monkeypatch.setattr(pip, "_available_budget", lambda device: 1500 * bpp)
    plan = msm_geometry(len(vals), True, device="cpu", window_bits=11)
    assert plan["pieces"] == 2
    P = pip.msm_g1(sv, A, glv=True, window_bits=11)
    got = g1.jacobian_to_ints(tuple(c[:, None] for c in P))[0]
    assert got == (int(case["expected"]["x"], 16), int(case["expected"]["y"], 16))
    assert scan_on_the_cpu == plan["tail_launches"]
    assert plan["tail_launches"] == {"padd_scan": 12 * 2 * plan["T"],
                                     "padd": 5 * 2 * plan["T"] + 1 + plan["T"] - 1}


def test_plan_counts_the_tail_only_on_the_scan_route(scan_on_the_cpu):
    """``tail_launches`` follows ``projective.lane_scan_kernel``: given where
    G1's lane scans take the scan kernel, None where they take the
    Hillis-Steele steps (G2 here; the CPU below, unpatched)."""
    assert msm_geometry(1 << 12, False, device="cpu")["tail_launches"] is not None
    assert msm_geometry(1 << 12, False, FQ2_ADAPTER, device="cpu")["tail_launches"] is None


def test_plan_has_no_tail_counts_for_the_hillis_steele_route():
    """The CPU takes the Hillis-Steele steps for both curves, and its plan has
    no tail counts; the card takes the scan kernel of each curve."""
    assert pj.lane_scan_kernel(FQ_ADAPTER, "cpu") is None
    assert pj.lane_scan_kernel(FQ2_ADAPTER, "cpu") is None
    assert pj.lane_scan_kernel(FQ_ADAPTER, "cuda") is cuda_g1.padd_scan
    assert pj.lane_scan_kernel(FQ2_ADAPTER, "cuda") is cuda_g2.padd2_scan
    assert msm_geometry(1 << 12, False, device="cpu")["tail_launches"] is None


def test_g1_lane_tile_on_a_stand_in_h100(monkeypatch):
    """The card's profile widens the G1 tile to its floor where 16 rows stay;
    the CPU's and G2's tiles do not move."""
    h100 = dataclasses.replace(tuning._CPU, name="NVIDIA H100 80GB HBM3",
                               msm_g1_lane_tile_log_min=tuning._CUDA_G1_LANE_TILE_LOG_MIN)
    floor = 1 << tuning._CUDA_G1_LANE_TILE_LOG_MIN
    cpu = {n: (pip.lane_tile_for(n, FQ_ADAPTER, "cpu"), pip.lane_tile_for(n, FQ2_ADAPTER, "cpu"))
           for n in (1 << 10, 1 << 16, 1 << 20, 1 << 21, 1 << 22, 1 << 23)}
    monkeypatch.setattr(pip, "chip_profile", lambda device=None: h100)
    assert pip.lane_tile_for(1 << 21, FQ_ADAPTER) == floor          # the single shot
    assert pip.lane_tile_for(1 << 21) == floor
    assert pip.lane_tile_for(1 << 22, FQ_ADAPTER) == max(floor, 1 << 15)
    assert pip.lane_tile_for(1 << 10, FQ_ADAPTER) == cpu[1 << 10][0]   # 16 rows stay
    for n, (t1, t2) in cpu.items():
        assert pip.lane_tile_for(n, FQ2_ADAPTER) == t2
        assert pip.lane_tile_for(n, FQ_ADAPTER) >= t1
    # the CPU profile itself has no floor
    assert tuning._CPU.msm_g1_lane_tile_log_min == 3
