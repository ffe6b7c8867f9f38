"""Pippenger multi-scalar multiplication for G1, single shot.

Counterpart of the JAX package's ``msm/pippenger.py`` as far as the main path
goes: ``msm_g1(scalars, A)`` in one piece.  The pipeline is the JAX package's,
stage by stage, because it needs no atomics and no scatter and has the same
shape for every scalar distribution:

1. **Signed-digit windows**: w-bit digits in [-(2^(w-1)-1), 2^(w-1)], bucket
   id |d| in 1..2^(w-1); zero digits go to a sentinel key.
2. **Sort by bucket** (``torch.sort`` on the keys, then one row gather of the
   element-major point table).
3. **Prefix-sum bucket extraction**: the sorted points are laid column-major
   into an (R, L) tile; one scan down the R rows (the hot loop, N signed mixed
   adds in all) gives per-column inclusive prefix sums; a log2(L) lane scan
   stitches the column carries.  Because the curve is a group, each bucket
   sum is S[end_b] - S[start_b - 1].
4. **Weighted triangle reduction** sum_b b * bucket_b by suffix scans over an
   (Rb, Lb) bucket tile.
5. **Horner window combine** with w doublings per window.

Accumulation runs in homogeneous projective coordinates with the RCB16
complete formulas (curves/projective.py); the result converts to Jacobian at
the public boundary.

On CUDA tensors the group-law calls (the scan's signed mixed adds, ``g_add``,
``g_double``) and the field products go to the CUDA kernels of
``curves/cuda_g1.py`` and ``fields/cuda_ops.py``; sort, gather, searchsorted,
rolls and selects are plain PyTorch.  The scan is ONE launch per window: each
thread owns a column and walks its R rows (``cuda_g1.pmadd_signed_rows``).
The stitch, boundary, triangle and Horner stages call ``padd`` / ``pdbl`` many
times on few lanes; that part is bound by launch latency and is left so.

Not ported yet: chunking past one shot (``msm`` raises
``NotImplementedError`` where the JAX package would split the point set),
precomputed bases, the shared-bases batch, G2.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants
from ..tuning import chip_profile
from ..curves import cuda_g1
from ..curves import projective as pj
from ..curves.field_adapters import FQ_ADAPTER
from ..fields import FQ, FR, fast
from ..fields.ops import LIMB_DTYPE
from ..runtime.tracing import stage

# Accumulation group ops: homogeneous projective with the RCB16 complete
# formulas, routed to the fused kernels for CUDA tensors.
g_identity = pj.proj_identity
g_add = pj.proj_add_fast
g_cmov = pj.proj_cmov
g_neg = pj.proj_neg
g_double = pj.proj_double_fast

FR_BITS = 255
# curves/glv.GLV_HALF_BITS mirrored statically (a lattice fact, not tunable).
GLV_HALF_BITS_STATIC = 128

_KEY_DTYPE = torch.int64


def window_bits_for(n: int, F=None, device=None) -> int:
    """Window size heuristic: push w as high as the profile's cap allows
    (the total work scales with the window count T = ceil(255/w)+1, while
    the 2^(w-1)-bucket tile work runs on wide lanes)."""
    if n <= 0:
        return 4
    prof = chip_profile(device)
    ln = max(1, n).bit_length() - 1
    cap = (prof.msm_window_cap_large if ln >= prof.msm_large_log_n
           else prof.msm_window_cap_small)
    if F is not None and getattr(F, "fq_muls_per_mul", 1) > 1:
        cap -= 1
    return int(np.clip(ln - 1, 4, cap))


def triangle_lb(nb: int) -> int:
    """Lane width Lb of the (Rb, Lb) triangle-reduction bucket tile.

    Rb must not exceed Lb (rows are padded up to Lb lanes for the batched
    weighted-sum pass), so grow Lb past 128 once nb > 2^14."""
    return max(min(128, nb), 1 << (nb.bit_length() // 2))


def lane_tile_for(n: int, F=None, device=None) -> int:
    """Lane width L for the bucket-accumulation tile (R = ceil(n/L) rows).

    The row scan is R dependent mixed adds per lane, the column stitch is
    log2(L) lane adds: L ~ sqrt(256 n), within the profile's cap."""
    ln = max(4, n).bit_length() - 1
    cap = chip_profile(device).msm_lane_tile_log_cap
    if F is not None and getattr(F, "limb_planes", 1) > 1:
        cap -= 1
    return 1 << int(np.clip((ln + 8) // 2, 3, cap))


def num_windows(w: int, num_bits: int = FR_BITS) -> int:
    """Window count for scalars of ``num_bits``.  Full Fr keeps
    ceil(255/w)+1; shorter scalars (the GLV halves) use the tight
    ceil((num_bits+1)/w): the +1 bit is the signed-digit carry."""
    if num_bits >= FR_BITS:
        return -(-FR_BITS // w) + 1
    return -(-(num_bits + 1) // w)


def decompose_signed_digits(scalars_std, w: int, num_bits: int = FR_BITS):
    """Standard-form Fr scalars (16, N) -> (T, N) |digit| and sign tensors.

    T = ceil(255 / w) + 1 (the +1 absorbs the final carry).  Digits are in
    [-(2^(w-1)-1), 2^(w-1)]; returns (abs_digit int64, sign bool).

    ``num_bits < FR_BITS`` (the GLV halves) uses the tight window count
    ceil((num_bits+1)/w): the top window's raw value plus carry is then
    <= 2^(w-1), so it can neither flip sign nor carry out.
    """
    n_win = num_windows(w, num_bits)
    n_shape = tuple(scalars_std.shape[1:])
    # pad two zero limb rows for cross-boundary extraction
    z = torch.zeros((2,) + n_shape, dtype=_KEY_DTYPE, device=scalars_std.device)
    s = torch.cat([scalars_std.to(_KEY_DTYPE), z], dim=0)
    wmask = (1 << w) - 1
    half = 1 << (w - 1)
    full = 1 << w

    abs_digits = []
    signs = []
    carry = torch.zeros(n_shape, dtype=_KEY_DTYPE, device=scalars_std.device)
    for t in range(n_win):
        o = w * t
        i0, sh = o >> 4, o & 15
        raw = s[i0] >> sh
        if sh:
            raw = raw | (s[i0 + 1] << (16 - sh))
        raw = raw & wmask
        v = raw + carry  # <= 2^w
        is_neg = v > half
        abs_digits.append(torch.where(is_neg, full - v, v))  # |d|
        carry = is_neg.to(_KEY_DTYPE)
        signs.append(is_neg)
    return torch.stack(abs_digits), torch.stack(signs)


# Sort keys: bucket id in the bits above bit 0, digit sign in bit 0 (sorting
# by the combined key still groups buckets contiguously; the sign rides along
# and is recovered from the sorted tile).  SENT2 marks zero digits and points
# at infinity; PAD2 marks tile padding.  Both decode to bucket ids far above
# any real bucket (w <= 16 -> bucket <= 2^15).  The values are the JAX
# package's uint32 ones, held in int64: they do not fit int32, and PyTorch has
# no ordered uint32 on the CPU.
_SENT2 = 0xFFFFFFFE
_PAD2 = 0xFFFFFFFF


def _keys_from_digits(abs_d, signs):
    key2 = (abs_d << 1) | signs.to(_KEY_DTYPE)
    return torch.where(abs_d == 0, _SENT2, key2)


def decompose_window_keys(scalars_std, w: int, num_bits: int = FR_BITS):
    """Standard-form Fr scalars (16, N) -> (T, N) int64 sort keys
    (bucket << 1 | sign; zero digits -> sentinel)."""
    return _keys_from_digits(
        *decompose_signed_digits(scalars_std, w, num_bits))


def _stage_pack_rows(F, x, y):
    """Affine coordinates (limbs-first) -> (n, 48) element-major rows.

    Runs once per MSM; the per-window gather then moves whole point rows
    (192 contiguous bytes) instead of 48 separate limb planes.
    """
    return torch.cat([x, y], dim=0).T.contiguous()


def _shift_dyn(F, P, d: int, direction: str):
    """Shift a lane-batched point by d along the last axis, filling vacated
    slots with the identity (roll + mask)."""
    L = P[0].shape[-1]
    idx = torch.arange(L, device=P[0].device)
    ident = g_identity(F, F.batch_shape(P[0]), P[0].device)
    if direction == "right":  # element l takes value from l-d
        rolled = tuple(torch.roll(c, d, dims=-1) for c in P)
        mask = idx >= d
    else:  # element l takes value from l+d
        rolled = tuple(torch.roll(c, -d, dims=-1) for c in P)
        mask = idx < (L - d)
    return g_cmov(F, mask, rolled, ident)


def _scan_steps(L: int) -> int:
    return max(L - 1, 1).bit_length() if L > 1 else 0


def _lane_prefix_exclusive(F, P):
    """Exclusive prefix point-sums along the last axis (Hillis-Steele)."""
    L = P[0].shape[-1]
    acc = P
    for i in range(_scan_steps(L)):
        acc = g_add(F, acc, _shift_dyn(F, acc, 1 << i, "right"))
    return _shift_dyn(F, acc, 1, "right")


def _lane_suffix_inclusive(F, P):
    L = P[0].shape[-1]
    acc = P
    for i in range(_scan_steps(L)):
        acc = g_add(F, acc, _shift_dyn(F, acc, 1 << i, "left"))
    return acc


def _sum_last_axis(F, P):
    """Point sum along the last axis (suffix scan, take slot 0)."""
    S = _lane_suffix_inclusive(F, P)
    return tuple(c[..., 0] for c in S)


def _gather_jac_rows(P_rows, r_idx, l_idx):
    """Gather from scan-stacked rows: coordinates (R, K, L) -> (K, B)."""
    return tuple(c[r_idx, :, l_idx].T.contiguous() for c in P_rows)


def _weighted_index_sum(F, P):
    """sum_j j * P[j] over the last axis via suffix sums (log depth).

    sum_j j*P_j = sum_{k>=1} S_k where S_k = sum_{j>=k} P_j.
    Returns (weighted_sum, plain_sum): the plain sum (= S_0) falls out free.
    """
    S = _lane_suffix_inclusive(F, P)
    total_tail = _sum_last_axis(F, S)  # sum_k S_k  (k >= 0)
    S0 = tuple(c[..., 0] for c in S)
    return g_add(F, total_tail, g_neg(F, S0)), S0


def _double_n(F, P, times: int):
    for _ in range(times):
        P = g_double(F, P)
    return P


# -----------------------------------------------------------------------------
# Stages.  PyTorch runs eagerly, so a stage is a plain function; the names are
# the JAX package's.
# -----------------------------------------------------------------------------


def _stage_sort_tile(F, key2, R: int, L: int, em_rows, inf):
    """Sort by bucket key, row-gather the element-major point table, and tile
    column-major into scan rows.  No field arithmetic.

    * points are gathered as element-major rows from the (n, 48) table built
      once per MSM by _stage_pack_rows;
    * the column-major tiling permutation is composed into the gather index,
      so the rows move once; the (R, L, 48) -> (R, 48, L) transpose afterwards
      is a streaming pass;
    * digit signs ride in bit 0 of the sort key and infinity / zero-digit
      slots in the sentinel range, so there is no separate sign or inf gather.
    * pad slots gather ``iota % n`` (a valid row) and are masked by _PAD2.

    Returns (bucket_sorted, x_rows, y_rows, sign_rows, inf_rows); the sorted
    bucket ids feed _boundary_core's searchsorted.
    """
    n = inf.shape[-1]
    dev = key2.device
    key2 = torch.where(inf, _SENT2, key2)
    pad = R * L - n
    if pad:
        key2 = torch.cat(
            [key2, torch.full((pad,), _PAD2, dtype=_KEY_DTYPE, device=dev)])
    key_sorted, order = torch.sort(key2, stable=True)
    perm = order % n  # the gathered value of iota % n under the sort
    # tile[r, l] = sorted[l*R + r]; compose into the gather
    tile = lambda a: a.reshape(L, R).transpose(0, 1)
    gidx = tile(perm).reshape(-1)      # (R*L,)
    ks_rows = tile(key_sorted)         # (R, L)

    rows = em_rows.index_select(0, gidx)                      # (R*L, 48)
    t = rows.reshape(R, L, -1).permute(0, 2, 1).contiguous()  # (R, 48, L)
    C = FQ.num_limbs
    x_rows = t[:, :C]
    y_rows = t[:, C:2 * C]
    sign_rows = (ks_rows & 1) != 0
    inf_rows = ks_rows >= _SENT2
    return key_sorted >> 1, x_rows, y_rows, sign_rows, inf_rows


def _stage_scan(F, x_rows, y_rows, sign_rows, inf_rows):
    """Row scan of signed mixed adds: the hot loop (N mixed adds in all).

    One call: on the card, one kernel launch in which each thread walks the
    R rows of its column.  Returns the column totals (the last prefix row)
    and the per-column inclusive prefix sums, coordinates (R, 24, L).
    """
    prefix_rows = cuda_g1.pmadd_signed_rows(
        x_rows, y_rows, sign_rows.contiguous(), inf_rows.contiguous())
    col_total = tuple(c[-1] for c in prefix_rows)
    return col_total, prefix_rows


def _stage_stitch(F, col_total):
    """Exclusive prefix point-sums of column totals (log-depth lane scan)."""
    return _lane_prefix_exclusive(F, col_total)


def _boundary_core(F, key_sorted, col_carry, nb: int, prefix_rows):
    """Dense bucket sums by prefix difference at sorted bucket boundaries.

    bucket_b = S[end_b] - S[start_b - 1]; S[e] = col_carry[l] + prefix[r, l].
    A pure gather and group subtract, constant shape for any input.
    """
    R, L = prefix_rows[0].shape[0], prefix_rows[0].shape[-1]
    dev = key_sorted.device
    b_vals = torch.arange(1, nb + 1, dtype=_KEY_DTYPE, device=dev)
    starts = torch.searchsorted(key_sorted, b_vals, right=False)
    ends = torch.searchsorted(key_sorted, b_vals, right=True)
    cnt = ends - starts

    pos = torch.cat([ends - 1, starts - 1])  # (2*nb,)
    valid = torch.cat([cnt > 0, (cnt > 0) & (starts > 0)])
    p = pos.clamp(0, R * L - 1)
    r_idx, l_idx = p % R, p // R
    part = _gather_jac_rows(prefix_rows, r_idx, l_idx)  # (K, 2*nb)
    carry = tuple(c[..., l_idx].contiguous() for c in col_carry)
    S = g_add(F, part, carry)
    S = g_cmov(F, valid, S, g_identity(F, (2 * nb,), dev))
    S_hi = tuple(c[..., :nb] for c in S)
    S_lo = tuple(c[..., nb:] for c in S)
    sums = g_add(F, S_hi, g_neg(F, S_lo))
    return g_cmov(F, cnt > 0, sums, g_identity(F, (nb,), dev))


def _stage_triangle_scans(F, buckets, nb: int):
    """Suffix-scan phase of sum_b b*P_b over a (Rb, Lb) bucket tile.

    Row- and column-sum scans are batched into one (2, Lb)-lane pass.
    Returns (w_rows, w_cols, total).
    """
    Lb = triangle_lb(nb)
    Rb = nb // Lb
    tiled = tuple(c.reshape(c.shape[:-1] + (Rb, Lb)) for c in buckets)

    # Col_l = sum_r P[r,l]; Row_r = sum_l P[r,l]
    ct = tuple(c.transpose(-1, -2) for c in tiled)  # (K, Lb, Rb)
    col_l = _sum_last_axis(F, ct)        # (K, Lb)
    row_sum = _sum_last_axis(F, tiled)   # (K, Rb)
    # pad rows to Lb lanes and batch both weighted sums in one pass
    if Lb > Rb:
        idR = g_identity(F, (Lb - Rb,), buckets[0].device)
        row_sum = tuple(torch.cat([c, i], dim=-1)
                        for c, i in zip(row_sum, idR))
    both = tuple(torch.stack([a, b], dim=-2) for a, b in zip(row_sum, col_l))
    w_both, s_both = _weighted_index_sum(F, both)  # (K, 2)
    w_rows = tuple(c[..., 0] for c in w_both)
    w_cols = tuple(c[..., 1] for c in w_both)
    total = tuple(c[..., 1] for c in s_both)  # sum of Col_l = sum_j P_j
    return w_rows, w_cols, total


def _stage_triangle_combine(F, w_rows, w_cols, total, lb_bits: int):
    """W = 2^lb_bits * w_rows + w_cols + total (window triangle total)."""
    part = _double_n(F, w_rows, lb_bits)
    out = g_add(F, part, w_cols)
    return g_add(F, out, total)


def _stage_horner(F, Ws, w: int):
    """Combine window sums top-down: acc = 2^w acc + W_t.  ``Ws`` holds the
    window sums stacked over the T windows, coordinates (T, K)."""
    T = Ws[0].shape[0]
    acc = tuple(c[T - 1] for c in Ws)
    for t in range(T - 2, -1, -1):
        acc = _double_n(F, acc, w)
        acc = g_add(F, acc, tuple(c[t] for c in Ws))
    return acc


def _stage_window_tail(F, key_sorted, col_total, nb: int, lb_bits: int,
                       prefix_rows):
    """Stitch + boundary + triangle + combine: the window's bucket math
    after the scan."""
    col_carry = _stage_stitch(F, col_total)
    buckets = _boundary_core(F, key_sorted, col_carry, nb, prefix_rows)
    w_rows, w_cols, total = _stage_triangle_scans(F, buckets, nb)
    return _stage_triangle_combine(F, w_rows, w_cols, total, lb_bits)


def _stage_to_jac(F, P):
    """Homogeneous projective accumulator -> Jacobian (public contract)."""
    return pj.proj_to_jac(F, P)


def glv_split_scalars(scalars_std):
    """Standard-form Fr scalars (16, ..., N) -> ([k1 || k2], 128) along the
    point axis: the GLV halves of k = k1 + k2*lambda, zero-padded back to
    16 limbs.  Pairs with :func:`glv_extend_bases`."""
    from ..curves import glv as glv_mod

    k1, k2 = glv_mod.decompose(scalars_std)
    pad = FR.num_limbs - k2.shape[0]  # decompose keeps only the live k2 limbs
    if pad:
        k2 = torch.cat([k2, torch.zeros((pad,) + tuple(k2.shape[1:]),
                                        dtype=k2.dtype, device=k2.device)])
    return torch.cat([k1, k2], dim=-1), glv_mod.GLV_HALF_BITS


def glv_extend_bases(F, A):
    """Affine batch A -> [A || phi(A)] (one batched Fq mul by beta)."""
    from ..curves import glv as glv_mod

    x, y, inf = A
    px, py, pinf = glv_mod.endomorphism(F, A)
    return (torch.cat([x, px], dim=-1),
            torch.cat([y, py], dim=-1),
            torch.cat([inf, pinf], dim=-1))


# -----------------------------------------------------------------------------
# Device-memory budget.  The working set per point: the element-major table,
# the gathered rows and their transposed tile, the 3-coordinate prefix rows,
# the input affine batch, and a margin for transients.
# -----------------------------------------------------------------------------

_CPU_BUDGET_BYTES = 8 << 30  # nominal; the CPU path exists for the tests


def _msm_bytes_per_point(F) -> int:
    """Approximate pipeline working-set bytes per point (int32 planes):
    table and tile rows (2 x 48 planes), the gathered x/y rows and the
    3-coordinate prefix rows and the input batch (7 x 24 planes), plus 25%."""
    C = FQ.num_limbs * getattr(F, "limb_planes", 1)  # planes per coordinate
    W = 2 * C
    return 4 * (2 * W + 7 * C) * 5 // 4


def _available_budget(device) -> int:
    """Bytes the pipeline may use on ``device`` right now.

    On the card: what ``torch.cuda.mem_get_info`` reports free, plus what
    PyTorch's allocator holds cached but unused.  Whatever the caller keeps
    live on the card is thereby already taken off.
    """
    device = torch.device(device)
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        cached = (torch.cuda.memory_reserved(device)
                  - torch.cuda.memory_allocated(device))
        return free + cached
    return _CPU_BUDGET_BYTES


def _split_points(n: int, budget: int, bpp: int) -> int:
    """Number of sequential point-chunks needed to fit the budget."""
    need = -(-n * bpp // budget)
    return max(1, need)


def _resolve_glv(glv, n: int, budget: int, bpp: int) -> bool:
    """The GLV decision: as asked, else MIDNIGHT_MSM_GLV, where ``auto``
    takes GLV only while the doubled point set still fits in one shot (it
    halves the window count but doubles the points)."""
    if glv is None:
        from ..runtime.config import config

        mode = config().msm_glv
        if mode == "auto":
            return 2 * n * bpp <= budget
        return mode == "on"
    return bool(glv)


def msm_geometry(n: int, glv: bool | None = None, F=FQ_ADAPTER, device=None,
                 window_bits: int | None = None) -> dict:
    """The plan ``msm`` follows for n input points on ``device`` now, and the
    only place where it is made.

    ``glv``: as asked, or None for the default (MIDNIGHT_MSM_GLV against the
    device's memory budget).  Returns the GLV decision, the point count n
    after the split, window bits w, window count T, buckets nb, the triangle
    tile's log2 lane width lb_bits, the scan tile (R, L), and the number of
    pieces the budget would force (``msm`` refuses more than one).
    """
    from ..device import resolve_device

    budget = _available_budget(resolve_device(device))
    bpp = _msm_bytes_per_point(F)
    glv = _resolve_glv(glv, n, budget, bpp)
    n_eff = n * (2 if glv else 1)
    w = window_bits or window_bits_for(n_eff, F, device)
    nb = 1 << (w - 1)
    L = lane_tile_for(n_eff, F, device)
    return {"glv": glv, "n": n_eff, "w": w,
            "T": num_windows(w, GLV_HALF_BITS_STATIC if glv else FR_BITS),
            "nb": nb, "lb_bits": triangle_lb(nb).bit_length() - 1,
            "L": L, "R": -(-n_eff // L),
            "pieces": _split_points(n_eff, budget, bpp),
            "budget_bytes": budget, "bytes_per_point": bpp}


def _check_inputs(scalars, A):
    x, y, inf = A
    for t, k, name in ((scalars, FR.num_limbs, "scalars"),
                       (x, FQ.num_limbs, "x"), (y, FQ.num_limbs, "y")):
        if not isinstance(t, torch.Tensor) or t.dtype != LIMB_DTYPE:
            raise TypeError(f"msm: {name} must be a {LIMB_DTYPE} tensor")
        if t.dim() != 2 or t.shape[0] != k:
            raise ValueError(
                f"msm: {name} must have shape ({k}, N), got {tuple(t.shape)}")
    if not isinstance(inf, torch.Tensor) or inf.dtype != torch.bool:
        raise TypeError("msm: inf must be a bool tensor")
    n = inf.shape[-1]
    if inf.dim() != 1 or not (scalars.shape[1] == x.shape[1] == y.shape[1] == n):
        raise ValueError("msm: scalars, x, y and inf disagree on N")
    if not (scalars.device == x.device == y.device == inf.device):
        raise ValueError("msm: scalars and points live on different devices")


def msm(F, scalars, A, *, window_bits: int | None = None,
        scalars_montgomery: bool = True, glv: bool | None = None):
    """MSM: sum_i scalars[i] * A[i] over the curve with field adapter F.

    scalars: (16, N) int32 Fr limbs (Montgomery form by default).
    A: affine batch (x, y, inf).  Returns a single Jacobian point.  Runs on
    the device the tensors live on.

    ``glv`` (default from MIDNIGHT_MSM_GLV) splits every scalar
    k = k1 + k2*lambda and runs the pipeline over [k1 || k2] against
    [A || phi(A)]: half the window count on 2n points.  ``auto`` turns it on
    while the doubled set fits the device memory budget in one shot.

    A point set that does not fit the budget in one shot raises
    ``NotImplementedError``: chunking is not ported yet.
    """
    if F is not FQ_ADAPTER:
        raise NotImplementedError("msm: only G1 (FQ_ADAPTER) is ported")
    _check_inputs(scalars, A)
    x, y, inf = A
    n = inf.shape[-1]
    if n > (1 << constants.MAX_MSM_LOG_SIZE):
        raise ValueError(f"MSM size {n} exceeds 2^{constants.MAX_MSM_LOG_SIZE}")
    if scalars_montgomery:
        with stage("from_mont"):
            scalars = fast.from_mont(FR, scalars)
    geo = msm_geometry(n, glv, F, inf.device, window_bits)
    if geo["pieces"] > 1:
        raise NotImplementedError(
            f"msm: {geo['n']} points at {geo['bytes_per_point']} bytes each "
            f"exceed the device memory budget of {geo['budget_bytes']} bytes; "
            f"the chunked MSM ({geo['pieces']} pieces) is not ported yet")
    Ws = _msm_window_sums(F, scalars, (x, y, inf), geo)
    with stage("horner"):
        return _stage_to_jac(F, _stage_horner(F, Ws, geo["w"]))


def _msm_window_sums(F, scalars_std, A, geo: dict):
    """Per-window signed-bucket sums for one point set, to the plan ``geo``
    of :func:`msm_geometry`: the whole pipeline short of the Horner ladder
    (projective window sums stacked over the T windows, coordinates (T, K))."""
    x, y, inf = A
    num_bits = FR_BITS
    if geo["glv"]:
        with stage("glv"):
            scalars_std, num_bits = glv_split_scalars(scalars_std)
            x, y, inf = glv_extend_bases(F, (x, y, inf))
    w, T, nb, lb_bits, L, R = (geo[k] for k in ("w", "T", "nb", "lb_bits", "L", "R"))
    assert inf.shape[-1] == geo["n"]

    with stage("keys"):
        keys = decompose_window_keys(scalars_std, w, num_bits)  # (T, N)
        assert keys.shape[0] == T
        em_rows = _stage_pack_rows(F, x, y)  # (N, 48), shared by all windows

    window_sums = []
    for t in range(T):
        with stage("sort_gather"):
            key_sorted, x_rows, y_rows, sign_rows, inf_rows = _stage_sort_tile(
                F, keys[t], R, L, em_rows, inf)
        with stage("scan"):
            col_total, prefix_rows = _stage_scan(
                F, x_rows, y_rows, sign_rows, inf_rows)
        del x_rows, y_rows
        with stage("tail"):
            window_sums.append(_stage_window_tail(
                F, key_sorted, col_total, nb, lb_bits, prefix_rows))
        del prefix_rows, col_total
    return tuple(torch.stack([ws[c] for ws in window_sums]) for c in range(3))


def msm_g1(scalars, A, **kw):
    return msm(FQ_ADAPTER, scalars, A, **kw)
