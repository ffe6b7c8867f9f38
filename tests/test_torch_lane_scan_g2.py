"""The G2 lane scan of the PyTorch/CUDA port (``cuda_g2.padd2_scan``), on the CPU.

On the card the G2 MSM tail's lane scans run as one scan kernel, the same
reduce-then-scan as G1's ``padd_scan`` over Fq2 points (``csrc/lane_scan.cuh``),
so its sums are the Hillis-Steele scans' points with other coordinates.  Here
its plain version ``padd2_scan_plain`` (the kernel's association, which
``chip_smoke.py`` holds the kernel to with ``torch.equal``) is held by value
against the Hillis-Steele scans over ``FQ2_PLAIN`` and against the big-int
oracle, with identities and negatives among the lanes; one G2 window tail
runs with the router forced onto it and is held against the Hillis-Steele
tail; and the G2 plan on a stand-in H100 is checked (its lane tile's floor,
its tail launches under G2's kernel names).  Plain Fq2 additions are slow on
the CPU: rows of a few lanes only, and no MSM.
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

from tpu_bls12_381_torch import oracle, tuning
from tpu_bls12_381_torch.curves import cuda_g2, g2, projective as pj
from tpu_bls12_381_torch.curves.field_adapters import FQ2_ADAPTER, FQ2_PLAIN
from tpu_bls12_381_torch.msm import msm_geometry, pippenger as pip

torch.set_num_threads(1)

MODES = [dict(reverse=r, exclusive=e) for r in (False, True) for e in (False, True)]


@pytest.fixture(scope="module")
def host_points():
    rng = random.Random(0x6CA)
    G = oracle.g2_generator()
    return [oracle.jac_to_affine(
        oracle.scalar_mul(rng.randrange(1, 1 << 24), G, oracle.FQ2_OPS),
        oracle.FQ2_OPS) for _ in range(24)]


def _proj(points, shape):
    """Projective (24, 2, *shape) points with Z != 1 (doubled affine points)."""
    A = g2.affine_from_ints(points, device="cpu")
    P = pj.proj_double(FQ2_PLAIN, pj.affine_to_proj(FQ2_PLAIN, A))
    return tuple(c.reshape((24, 2) + shape).contiguous() for c in P)


def _ints(P):
    """Affine ints (None for the identity) of every lane, rows flattened."""
    return g2.jacobian_to_ints(
        tuple(c.reshape(24, 2, -1) for c in pj.proj_to_jac(FQ2_PLAIN, P)))


def _oracle_scan(points, reverse, exclusive):
    """Prefix (suffix) sums of affine G2 points by the big-int oracle."""
    seq = points[::-1] if reverse else points
    acc, out = None, []
    for p in seq:
        before = acc
        acc = oracle.jac_add_affine(acc, p, oracle.FQ2_OPS)
        out.append(before if exclusive else acc)
    out = [None if s is None else oracle.jac_to_affine(s, oracle.FQ2_OPS) for s in out]
    return out[::-1] if reverse else out


@pytest.mark.parametrize("shape,run,threads,modes", [
    ((11,), 2, 2, MODES),                # 3 blocks, the last part empty; all modes
    ((2, 5), 1, 2, MODES[1:3]),          # a batch row, 3 blocks of runs of 1
])
def test_scan2_plain_equals_hillis_steele(host_points, shape, run, threads, modes):
    n = int(np.prod(shape))
    P = _proj(host_points[:n], shape)
    for mode in modes:
        want = pj.proj_lane_scan(FQ2_PLAIN, P, **mode)
        got = cuda_g2.padd2_scan_plain(P, run=run, threads=threads, **mode)
        assert all(tuple(c.shape) == tuple(P[0].shape) for c in got)
        assert _ints(got) == _ints(want), mode
    total = cuda_g2.padd2_scan_plain(P, total=True, run=run, threads=threads)
    assert tuple(total[0].shape) == (24, 2) + shape[:-1]
    S = pj.proj_lane_scan(FQ2_PLAIN, P, reverse=True)
    assert _ints(total) == _ints(tuple(c[..., 0] for c in S))


def test_scan2_against_the_oracle_with_identities_and_negatives(host_points):
    """Lanes holding the identity, and P next to -P, against the oracle's
    prefix and suffix sums, inclusive and exclusive."""
    neg = lambda p: (p[0], ((-p[1][0]) % oracle.Q, (-p[1][1]) % oracle.Q))
    pts = list(host_points[:10])
    pts[0] = pts[6] = pts[9] = None                   # identities, first and last
    pts[4] = neg(pts[3])                              # -P right after P
    pts[8] = neg(pts[1])                              # -P of an earlier lane
    zero = ((0, 0), (0, 0))
    A = g2.affine_from_ints([p if p is not None else zero for p in pts], device="cpu")
    A = (A[0], A[1], torch.tensor([p is None for p in pts]))
    P = pj.affine_to_proj(FQ2_PLAIN, A)
    for mode in MODES:
        got = cuda_g2.padd2_scan_plain(P, run=2, threads=2, **mode)
        assert _ints(got) == _oracle_scan(pts, **mode), mode
    pair = tuple(c[..., 3:5].contiguous() for c in P)
    assert not cuda_g2.padd2_scan_plain(pair, total=True)[2].any()   # P + (-P): Z = 0


def test_padd2_scan_wrapper_takes_the_plain_version_on_the_cpu_and_checks(host_points):
    P = _proj(host_points[:6], (2, 3))
    for mode in [dict(exclusive=True), dict(total=True)]:
        got = cuda_g2.padd2_scan(P, run=2, **mode)
        want = cuda_g2.padd2_scan_plain(P, run=2, **mode)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError):
        cuda_g2.padd2_scan(P, threads=3)              # not a power of two
    with pytest.raises(ValueError):
        cuda_g2.padd2_scan(P, threads=256)            # above the kernel's block
    with pytest.raises(ValueError):
        cuda_g2.padd2_scan(tuple(c.transpose(2, 3) for c in P))   # not contiguous
    with pytest.raises(ValueError):
        cuda_g2.padd2_scan(tuple(c[:, 0] for c in P))  # not (24, 2, *batch, L)
    assert cuda_g2.LAUNCHES["padd2_scan"] == 0        # the CPU launches nothing
    assert cuda_g2.SCAN_LAUNCHES == {}


def test_g2_window_tail_through_the_scan(host_points, monkeypatch):
    """One G2 window's tail (stitch, boundary, triangle, combine) over a small
    sorted tile: through the scan's plain version, as the card routes it,
    and through the Hillis-Steele steps the same point by value; the scan
    route makes the plan's 12 scan launches and 5 adds."""
    n, w = 12, 3
    rng = np.random.default_rng(5)
    A = g2.affine_from_ints(host_points[:n], device="cpu")
    abs_d = torch.from_numpy(rng.integers(0, 1 << (w - 1), size=n) + 1).long()
    abs_d[::5] = 0                                    # zero digits: sentinels
    keys = pip._keys_from_digits(abs_d, torch.from_numpy(rng.integers(0, 2, size=n) == 1))
    nb = 1 << (w - 1)
    lb_bits = pip.triangle_lb(nb).bit_length() - 1
    R, L = 3, 4
    em = pip._stage_pack_rows(FQ2_ADAPTER, A[0], A[1])
    ks, xr, yr, sr, ir = pip._stage_sort_tile(FQ2_ADAPTER, keys, R, L, em, A[2])
    total, prefix = pip._stage_scan(FQ2_ADAPTER, xr, yr, sr, ir)
    want = pip._stage_window_tail(FQ2_ADAPTER, ks, total, nb, lb_bits, prefix)

    counts = {"padd2_scan": 0, "padd2": 0}

    def scan(P, **kw):
        counts["padd2_scan"] += 2 if kw.get("total") else 3
        return cuda_g2.padd2_scan_plain(P, **kw)

    add = pj.proj_add_fast

    def counted_add(F, P, Q):
        counts["padd2"] += F is FQ2_ADAPTER
        return add(F, P, Q)

    monkeypatch.setattr(pj, "lane_scan_kernel",
                        lambda F, device: scan if F is FQ2_ADAPTER else None)
    monkeypatch.setattr(pj, "proj_add_fast", counted_add)
    monkeypatch.setattr(pip, "g_add", counted_add)
    got = pip._stage_window_tail(FQ2_ADAPTER, ks, total, nb, lb_bits, prefix)
    assert counts == {"padd2_scan": pip.TAIL_SCAN_LAUNCHES, "padd2": pip.TAIL_ADDS}
    got_ints = _ints(tuple(c[..., None] for c in got))
    assert got_ints == _ints(tuple(c[..., None] for c in want))
    # the window sum by the oracle: sum_i signed digit_i * A_i
    acc = None
    signs = (keys & 1).bool()
    for i in range(n):
        if abs_d[i] == 0:
            continue
        d = int(abs_d[i]) * (-1 if signs[i] else 1) % oracle.R
        acc = oracle.jac_add(acc, oracle.scalar_mul(d, host_points[i], oracle.FQ2_OPS),
                             oracle.FQ2_OPS)
    assert got_ints == [oracle.jac_to_affine(acc, oracle.FQ2_OPS)]


def test_g2_plan_on_a_stand_in_h100(monkeypatch):
    """On a stand-in H100 (its profile, the card's lane-scan route, 80 GB) a
    2^20-point G2 MSM takes the G2 tile's floor (2^14 lanes), and its tail
    makes 12 ``padd2_scan`` launches and 5 ``padd2`` a window (240 and 119
    at T = 20; the factor-2 cached call 120 and 59 at T' = 10); the CPU's plan
    has no tail counts and the JAX package's tile."""
    cpu = msm_geometry(1 << 20, F=FQ2_ADAPTER, device="cpu")
    assert cpu["tail_launches"] is None
    assert (cpu["L"], cpu["R"]) == (1 << 14, 64)      # the JAX package's G2 tile
    small = pip.lane_tile_for(1 << 10, FQ2_ADAPTER, "cpu")
    h100 = dataclasses.replace(
        tuning._CPU, name="NVIDIA H100 80GB HBM3",
        msm_g1_lane_tile_log_min=tuning._CUDA_G1_LANE_TILE_LOG_MIN,
        msm_g2_lane_tile_log_min=tuning._CUDA_G2_LANE_TILE_LOG_MIN)
    kernel = pj.lane_scan_kernel
    monkeypatch.setattr(pip, "chip_profile", lambda device=None: h100)
    monkeypatch.setattr(pip, "_available_budget", lambda device: 80 << 30)
    monkeypatch.setattr(pj, "lane_scan_kernel", lambda F, device: kernel(F, "cuda"))
    single = msm_geometry(1 << 20, F=FQ2_ADAPTER, device="cpu")
    floor = 1 << tuning._CUDA_G2_LANE_TILE_LOG_MIN
    assert (single["T"], single["L"], single["R"]) == (20, floor, (1 << 20) // floor)
    assert single["tail_launches"] == {"padd2_scan": 240, "padd2": 5 * 20 + 19}
    cached = msm_geometry(1 << 20, False, FQ2_ADAPTER, "cpu", single["w"], factor=2,
                          cached=True)
    assert cached["T"] == 10
    assert cached["tail_launches"] == {"padd2_scan": 120, "padd2": 5 * 10 + 9}
    # G2's floor leaves 16 rows; a small MSM keeps the CPU's tile
    assert pip.lane_tile_for(1 << 10, FQ2_ADAPTER) == small
    assert tuning._CPU.msm_g2_lane_tile_log_min == 3
