"""Pippenger multi-scalar multiplication, generic over the field adapter: G1
over ``FQ_ADAPTER``, G2 over ``FQ2_ADAPTER``.

Counterpart of the JAX package's ``msm/pippenger.py``: the single-shot MSM
(``msm``, ``msm_g1``, ``msm_g2``) with its sequential point-chunks when the
set does not fit the device memory budget, the precomputed-multiples MSM
(``expand_bases``, ``msm_precomputed``) and the shared-bases batch
(``msm_batch_shared``).  The pipeline is the JAX package's, stage by stage,
because it needs no atomics and no scatter and has the same shape for every
scalar distribution:

1. **Signed-digit windows**: w-bit digits in [-(2^(w-1)-1), 2^(w-1)], bucket
   id |d| in 1..2^(w-1); zero digits go to a sentinel key.
2. **Sort by bucket** (``torch.sort`` on the keys, then one row gather of the
   element-major point table).
3. **Prefix-sum bucket extraction**: the sorted points are laid column-major
   into an (R, L) tile; one scan down the R rows (the hot loop, N signed mixed
   adds in all) gives per-column inclusive prefix sums; a lane scan stitches
   the column carries.  Because the curve is a group, each bucket
   sum is S[end_b] - S[start_b - 1].
4. **Weighted triangle reduction** sum_b b * bucket_b by suffix scans over an
   (Rb, Lb) bucket tile.
5. **Horner window combine** with w doublings per window.

Accumulation runs in homogeneous projective coordinates with the RCB16
complete formulas (curves/projective.py); the result converts to Jacobian at
the public boundary.

A coordinate is a tensor ``(*F.elem_shape, *batch)``: ``(24, N)`` for G1,
``(24, 2, N)`` for G2 (curves/field_adapters.py).  The batch axes are the
trailing ones in both, so every stage below is written once: it touches the
element axes only through ``F.elem_shape``.  The shared-bases batch folds its
batch axis B between the element axes and the lanes; to the scan kernel B*L
is one lane axis.

On CUDA tensors the group-law calls (the scan's signed mixed adds, ``g_add``,
``_double_n``) and the field products go to the CUDA kernels of
``curves/cuda_g1.py``, ``curves/cuda_g2.py`` and ``fields/cuda_ops.py``; sort,
gather, searchsorted, rolls and selects are plain PyTorch.  The scan is ONE
launch per window: each thread owns a column and walks its R rows.  The
tail's lane scans (stitch, triangle) are, on the card, the scan kernel
``padd_scan`` (G1) or ``padd2_scan`` (G2) (``projective.proj_lane_scan_fast``:
12 launches a window); on the CPU they are the JAX package's Hillis-Steele
steps.  The
boundary, the triangle combine and Horner call the add and the doubling on
few lanes; that part is bound by launch latency.  A chain of doublings
(``_double_n``: the triangle combine's lb_bits, Horner's w, ``expand_bases``'
span) is, on the card, one launch (``projective.proj_double_n_fast``:
``pdbl`` for G1, ``pdbl2`` for G2).

``msm_chunked`` runs the same pipeline over a leading chunk axis, one partial
MSM a chunk (the scale-out layer's local step, ``parallel/msm.py``): the D
chunks are one batch, folded between the element axes and the lanes as the
shared-bases batch folds its B, each chunk with its own point table.
``msm_traceable`` is the JAX package's one-trace form: one call with every
shape from the inputs' shapes, which a CUDA graph can capture.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from .. import constants
from ..tuning import chip_profile
from ..curves import projective as pj
from ..curves.field_adapters import FQ2_ADAPTER, FQ_ADAPTER
from ..fields import FR, fast
from ..fields.ops import LIMB_DTYPE
from ..runtime.tracing import stage

# Accumulation group ops: homogeneous projective with the RCB16 complete
# formulas, routed to the fused kernels for CUDA tensors.
g_identity = pj.proj_identity
g_add = pj.proj_add_fast
g_cmov = pj.proj_cmov
g_neg = pj.proj_neg
g_scan_rows = pj.proj_scan_rows_fast

FR_BITS = 255
# curves/glv.GLV_HALF_BITS mirrored statically (a lattice fact, not tunable).
GLV_HALF_BITS_STATIC = 128

_KEY_DTYPE = torch.int64

# A window's tail on the card: the stitch (a scan, 3 launches), the
# triangle's column and row sums (totals, 2 each), its suffix scan (3) and
# the sum of that (2); two adds at the boundary, one in the weighted sum,
# two in the combine, whose lb_bits doublings are one pdbl (pdbl2) launch.
# The kernels' names in the launch counts by the adapter's limb planes a
# coordinate (1: G1, 2: G2): (the scan, the add).
TAIL_SCAN_LAUNCHES = 12
TAIL_ADDS = 5
TAIL_KERNELS = {1: ("padd_scan", "padd"), 2: ("padd2_scan", "padd2")}


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

    The row scan is R dependent mixed adds per lane, the column stitch a lane
    scan: L ~ sqrt(256 n), within the profile's cap (one less for G2).  A
    curve takes at least 2^msm_g1_lane_tile_log_min (G2:
    2^msm_g2_lane_tile_log_min) lanes while that leaves 16 rows: on the card
    the scan needs that many lanes in flight, and its stitch costs some 2L
    adds, not L log2 L."""
    ln = max(4, n).bit_length() - 1
    prof = chip_profile(device)
    cap = prof.msm_lane_tile_log_cap
    floor = prof.msm_g1_lane_tile_log_min
    if F is not None and getattr(F, "limb_planes", 1) > 1:
        cap, floor = cap - 1, prof.msm_g2_lane_tile_log_min
    lo = max(3, min(floor, ln - 4))
    return 1 << int(np.clip((ln + 8) // 2, lo, max(cap, lo)))


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


def _coord_planes(F) -> int:
    """Limb planes per affine coordinate (Fq: 24; Fq2: 48)."""
    return math.prod(F.elem_shape)


def _stage_pack_rows(F, x, y):
    """Affine coordinates (limbs-first) -> (n, 2C) element-major rows, C the
    planes of one coordinate (G1: 48 columns, G2: 96).  Coordinates
    (*elem, B, n) of B point sets give their B tables member after member:
    (B*n, 2C), row b*n + i the point i of member b.  The coordinates may be
    views of a (B, *elem, n) layout (the chunk axis moved behind the element
    axes): the table is the only copy made.

    Runs once per MSM; the per-window gather then moves whole point rows
    (192 or 384 contiguous bytes) instead of 2C separate limb planes.
    """
    C, k = _coord_planes(F), len(F.elem_shape)
    planes_last = lambda c: c.reshape((C,) + tuple(c.shape[k:])).movedim(0, -1)
    return torch.cat([planes_last(x), planes_last(y)], dim=-1).reshape(-1, 2 * C)


def _coord_rows(F, t, off: int):
    """Planes [off, off + C) of an (R, 2C, *lanes) tile as coordinate rows
    (R, *F.elem_shape, *lanes): a view, nothing moves."""
    return t[:, off:off + _coord_planes(F)].unflatten(1, F.elem_shape)


def _indexed_axes_last(t, k: int):
    """Move the first k axes of ``t`` behind the others (the axes an indexed
    gather puts in front go back to where the batch axes belong)."""
    return t.permute(*range(k, t.dim()), *range(k)).contiguous()


def _weighted_index_sum(F, P):
    """sum_j j * P[j] over the last axis via suffix sums.

    sum_j j*P_j = sum_{k>=1} S_k where S_k = sum_{j>=k} P_j.
    Returns (weighted_sum, plain_sum): the plain sum (= S_0) falls out free.
    """
    S = pj.proj_lane_scan_fast(F, P, reverse=True)
    total_tail = pj.proj_lane_sum_fast(F, S)  # sum_k S_k  (k >= 0)
    S0 = tuple(c[..., 0] for c in S)
    return g_add(F, total_tail, g_neg(F, S0)), S0


def _double_n(F, P, times: int):
    """2^times P, on the card one launch (the JAX package's ``fori_loop``
    of doublings)."""
    return pj.proj_double_n_fast(F, P, times)


# -----------------------------------------------------------------------------
# Stages.  PyTorch runs eagerly, so a stage is a plain function; the names are
# the JAX package's.
# -----------------------------------------------------------------------------


def _stage_sort_tile(F, key2, R: int, L: int, em_rows, inf):
    """Sort by bucket key, row-gather the element-major point table, and tile
    column-major into scan rows.  No field arithmetic.

    ``key2`` is (n,) for one scalar set or (B, n) for a batch of B sets.
    With ``inf`` (n,) the batch gathers from one shared (n, 2C) table; with
    ``inf`` (B, n) each member has its own, the B tables packed member after
    member in ``em_rows`` (B*n, 2C) (the chunk axis of :func:`msm_chunked`).

    * points are gathered as element-major rows from the (n, 2C) table built
      once per MSM by _stage_pack_rows;
    * the column-major tiling permutation is composed into the gather index,
      so the rows move once; the transpose to limb planes afterwards is a
      streaming pass;
    * digit signs ride in bit 0 of the sort key and infinity / zero-digit
      slots in the sentinel range, so there is no separate sign or inf gather.
    * pad slots gather ``iota % n`` (a valid row) and are masked by _PAD2.

    Returns (bucket_sorted, x_rows, y_rows, sign_rows, inf_rows); the sorted
    bucket ids feed _boundary_core's searchsorted.  Without a batch the rows
    are (R, *elem, L) with masks (R, L); with one the batch axis lies between
    the element axes and the lanes: (R, *elem, B, L), masks (R, B, L).
    """
    n = inf.shape[-1]
    dev = key2.device
    lead = tuple(key2.shape[:-1])                 # () or (B,)
    key2 = torch.where(inf, _SENT2, key2)
    pad = R * L - n
    if pad:
        key2 = torch.cat(
            [key2, torch.full(lead + (pad,), _PAD2, dtype=_KEY_DTYPE,
                              device=dev)], dim=-1)
    key_sorted, order = torch.sort(key2, dim=-1, stable=True)
    perm = order % n  # the gathered value of iota % n under the sort
    if inf.dim() > 1:  # member b's own table starts at row b*n
        perm = perm + torch.arange(0, lead[0] * n, n, device=dev)[:, None]
    # tile[r, l] = sorted[l*R + r]; compose into the gather
    tile = lambda a: a.reshape(lead + (L, R)).transpose(-1, -2)
    gidx = tile(perm).reshape(-1)      # (R*L,) or (B*R*L,)
    ks_rows = tile(key_sorted)         # (R, L) or (B, R, L)

    rows = em_rows.index_select(0, gidx)                      # (.., 2C)
    if lead:
        t = rows.reshape(lead + (R, L, -1)).permute(1, 3, 0, 2).contiguous()
        ks_rows = ks_rows.transpose(0, 1)                     # (R, B, L)
    else:
        t = rows.reshape(R, L, -1).permute(0, 2, 1).contiguous()
    x_rows = _coord_rows(F, t, 0)
    y_rows = _coord_rows(F, t, _coord_planes(F))
    sign_rows = (ks_rows & 1) != 0
    inf_rows = ks_rows >= _SENT2
    return key_sorted >> 1, x_rows, y_rows, sign_rows, inf_rows


def _stage_scan(F, x_rows, y_rows, sign_rows, inf_rows):
    """Row scan of signed mixed adds: the hot loop (N mixed adds in all).

    One call: on the card, one kernel launch in which each thread walks the
    R rows of its column.  A batch axis is folded into the lanes for the
    call (B*L columns) and unfolded after it.  Returns the column totals (the
    last prefix row) and the per-column inclusive prefix sums, coordinates
    (R, *elem, [B,] L).
    """
    lanes = tuple(inf_rows.shape[1:])             # (L,) or (B, L)
    if len(lanes) > 1:
        x_rows, y_rows = x_rows.flatten(-2), y_rows.flatten(-2)
        sign_rows = sign_rows.contiguous().flatten(-2)
        inf_rows = inf_rows.contiguous().flatten(-2)
    prefix_rows = g_scan_rows(F, x_rows, y_rows, sign_rows, inf_rows)
    if len(lanes) > 1:
        prefix_rows = tuple(c.unflatten(-1, lanes) for c in prefix_rows)
    col_total = tuple(c[-1] for c in prefix_rows)
    return col_total, prefix_rows


def _stage_stitch(F, col_total):
    """Exclusive prefix point-sums of column totals (one lane scan)."""
    return pj.proj_lane_scan_fast(F, col_total, exclusive=True)


def _boundary_core(F, key_sorted, col_carry, nb: int, prefix_rows):
    """Dense bucket sums by prefix difference at sorted bucket boundaries.

    bucket_b = S[end_b] - S[start_b - 1]; S[e] = col_carry[l] + prefix[r, l].
    A pure gather and group subtract, constant shape for any input.

    ``key_sorted`` is (R*L,), or (B, R*L) for a batch, with col_carry
    (*elem, B, L) and prefix rows (R, *elem, B, L); the buckets are then
    (*elem, B, nb).  The batch is one batched ``searchsorted`` and one gather
    (the JAX package maps the unbatched function over B).
    """
    R, L = prefix_rows[0].shape[0], prefix_rows[0].shape[-1]
    dev = key_sorted.device
    lead = tuple(key_sorted.shape[:-1])           # () or (B,)
    b_vals = torch.arange(1, nb + 1, dtype=_KEY_DTYPE, device=dev)
    b_vals = b_vals.expand(lead + (nb,)).contiguous()
    starts = torch.searchsorted(key_sorted, b_vals, right=False)
    ends = torch.searchsorted(key_sorted, b_vals, right=True)
    cnt = ends - starts

    pos = torch.cat([ends - 1, starts - 1], dim=-1)           # (.., 2*nb)
    valid = torch.cat([cnt > 0, (cnt > 0) & (starts > 0)], dim=-1)
    p = pos.clamp(0, R * L - 1)
    r_idx, l_idx = p % R, p // R
    if lead:
        b_idx = torch.arange(lead[0], device=dev)[:, None]
        part = tuple(_indexed_axes_last(c[r_idx, ..., b_idx, l_idx], 2)
                     for c in prefix_rows)                    # (*elem, B, 2*nb)
        carry = tuple(c[..., b_idx, l_idx].contiguous() for c in col_carry)
    else:
        part = tuple(_indexed_axes_last(c[r_idx, ..., l_idx], 1)
                     for c in prefix_rows)                    # (*elem, 2*nb)
        carry = tuple(c[..., l_idx].contiguous() for c in col_carry)
    S = g_add(F, part, carry)
    S = g_cmov(F, valid, S, g_identity(F, lead + (2 * nb,), dev))
    S_hi = tuple(c[..., :nb] for c in S)
    S_lo = tuple(c[..., nb:] for c in S)
    sums = g_add(F, S_hi, g_neg(F, S_lo))
    return g_cmov(F, cnt > 0, sums, g_identity(F, lead + (nb,), dev))


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
    col_l = pj.proj_lane_sum_fast(F, ct)        # (K, Lb)
    row_sum = pj.proj_lane_sum_fast(F, tiled)   # (K, Rb)
    # pad rows to Lb lanes and batch both weighted sums in one pass
    if Lb > Rb:
        lead = F.batch_shape(buckets[0])[:-1]     # () or (B,)
        idR = g_identity(F, lead + (Lb - Rb,), buckets[0].device)
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
    window sums stacked over the T windows, coordinates (T, *elem[, B])."""
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
# the input affine batch, and a margin for transients.  When an MSM (or a
# shared-bases batch) would exceed the budget, the point (or batch) axis is
# split into sequential pieces.
# -----------------------------------------------------------------------------

_CPU_BUDGET_BYTES = 8 << 30  # nominal; the CPU path exists for the tests


def _msm_bytes_per_point(F) -> int:
    """Approximate pipeline working-set bytes per point (int32 planes):
    table and tile rows (2 x 2C planes), the gathered x/y rows and the
    3-coordinate prefix rows and the input batch (7 x C planes), plus 25%."""
    C = _coord_planes(F)          # planes per affine coordinate
    W = 2 * C
    return 4 * (2 * W + 7 * C) * 5 // 4


def _budget_limit_bytes() -> int | None:
    """MIDNIGHT_MSM_HBM_BUDGET_MB: an upper limit on the memory the pipeline
    may plan with, which a caller sets to keep room on the card for its own
    buffers.  Unset: no limit but the card's free memory.  Read at every
    call, as the JAX package reads it."""
    raw = os.environ.get("MIDNIGHT_MSM_HBM_BUDGET_MB")
    if raw is None or not raw.strip():
        return None
    mb = int(raw)
    if mb <= 0:
        raise ValueError(f"MIDNIGHT_MSM_HBM_BUDGET_MB={raw!r}: need a positive "
                         f"number of MiB")
    return mb << 20


def _available_budget(device) -> int:
    """Bytes the pipeline may use on ``device`` right now.

    On the card: what ``torch.cuda.mem_get_info`` reports free, plus what
    PyTorch's allocator holds cached but unused; whatever the caller keeps
    live on the card is thereby already taken off.  MIDNIGHT_MSM_HBM_BUDGET_MB
    caps the figure.  It never falls below 1/8 of the cap (the limit, or the
    card's memory), so that piece counts stay sane under memory pressure.
    """
    device = torch.device(device)
    limit = _budget_limit_bytes()
    if device.type == "cuda":
        free, total = torch.cuda.mem_get_info(device)
        cached = (torch.cuda.memory_reserved(device)
                  - torch.cuda.memory_allocated(device))
        cap = total if limit is None else limit
        return max(min(free + cached, cap), cap // 8)
    return _CPU_BUDGET_BYTES if limit is None else limit


def _split_points(n: int, budget: int, bpp: int) -> int:
    """Number of sequential point-chunks needed to fit the budget."""
    need = -(-n * bpp // budget)
    return max(1, need)


def _point_pieces(unit: int, n_eff: int, budget: int, bpp: int):
    """Sequential point-chunks for ``n_eff`` pipeline points that are sliced
    along an axis of ``unit`` points: (pieces, points of ``unit`` a piece).
    Equal sizes; a piece count that divides ``unit`` is preferred (for powers
    of two it lands on power-of-two pieces)."""
    pieces = _split_points(n_eff, budget, bpp)
    if pieces == 1:
        return 1, unit
    while unit % pieces and pieces < 64:
        pieces += 1
    per = -(-unit // pieces)
    return -(-unit // per), per


def _balance_groups(total: int, fit: int):
    """``total`` batch members (or chunks) in the fewest sequential groups of
    at most ``fit`` (at least 1), of equal size: (groups, members a group)."""
    groups = -(-total // max(1, min(total, fit)))
    per_group = -(-total // groups)
    return -(-total // per_group), per_group


def _resolve_glv(glv, n: int, budget: int, bpp: int, F=FQ_ADAPTER) -> bool:
    """The GLV decision (G1 only): as asked, else MIDNIGHT_MSM_GLV, where
    ``auto`` takes GLV only while the doubled point set still fits in one
    shot (it halves the window count but doubles the points)."""
    if F is not FQ_ADAPTER:
        return False
    if glv is None:
        from ..runtime.config import config

        mode = config().msm_glv
        if mode == "auto":
            return 2 * n * bpp <= budget
        return mode == "on"
    return bool(glv)


def _tile_plan(F, n_eff: int, w: int, device) -> dict:
    """The tiles of one pipeline run over ``n_eff`` points at window bits w."""
    nb = 1 << (w - 1)
    L = lane_tile_for(n_eff, F, device)
    return {"n": n_eff, "w": w, "nb": nb,
            "lb_bits": triangle_lb(nb).bit_length() - 1,
            "L": L, "R": -(-n_eff // L)}


def msm_geometry(n: int, glv: bool | None = None, F=FQ_ADAPTER, device=None,
                 window_bits: int | None = None, *, factor: int = 1,
                 batch: int = 1, cached: bool = False,
                 chunks: int | None = None) -> dict:
    """The plan an MSM over n input points follows on ``device`` now, and the
    only place where it is made.

    ``cached=False``: the plan of :func:`msm` (ad-hoc bases).  ``glv``: as
    asked, or None for the default (MIDNIGHT_MSM_GLV against the device's
    memory budget).

    ``cached=True``: the plan of the cached-bases paths against n bases
    uploaded with ``factor``, ``glv`` and ``window_bits``:
    :func:`msm_precomputed` for ``batch == 1``, :func:`msm_batch_shared` for a
    batch of B scalar sets.  With ``glv`` or ``window_bits`` None it is the
    plan ``MsmContext.upload_bases`` makes for them: GLV while the doubled,
    expanded set fits the budget in one shot, and the window for the whole
    expanded set (MIDNIGHT_MSM_WINDOW, else the heuristic).

    ``chunks=D``: the plan of :func:`msm_chunked` over D chunks of n input
    points each, with ``glv`` as asked and ``factor`` (bases the caller
    expanded, and GLV-extended before, for factor > 1).  Every chunk has the
    geometry of one chunk alone (w from the chunk's points after the GLV
    extension, over the factor).  Each chunk brings its own point table, so
    a group holds as many chunks as their working sets fit the budget;
    where one chunk alone does not fit, groups of one chunk run in pieces.

    Returns the GLV decision, the points of one pipeline run ``n`` (after the
    GLV split, the expansion and the cut into pieces), window bits w, the
    window count T of a run, buckets nb, the triangle tile's log2 lane width
    lb_bits, the scan tile (R, L), ``pieces`` sequential point-chunks of
    ``per`` points each (counted along the axis that is sliced), ``groups``
    sequential batch groups of ``per_group`` scalar sets (or chunks), and
    ``scan_launches``, the scan launches of the whole call (one a window, a
    piece and a group), and ``tail_launches``: where the lane scans take the
    scan kernel (``projective.lane_scan_kernel``: on the card), the scan's
    and the add's launches of the call under their names (``padd_scan`` and
    ``padd`` for G1, ``padd2_scan`` and ``padd2`` for G2; a window's tail
    makes 12 scan launches and 5 adds; each piece after the first of a group
    adds its window sums in once; Horner adds T - 1 times), else None.
    ``doubling_chains``: the call's chains of doublings (one a window's
    triangle combine, one a Horner step; on the card each is one ``pdbl``
    launch for G1, one ``pdbl2`` launch for G2) and ``doublings``, the
    doublings in them.
    """
    from ..device import resolve_device

    device = resolve_device(device)
    budget = _available_budget(device)
    bpp = _msm_bytes_per_point(F)
    factor = max(int(factor), 1)
    groups, per_group = 1, batch
    if chunks is not None:
        if cached or batch != 1:
            raise ValueError("msm_geometry: chunks plan msm_chunked, which has no "
                             "batch and no cached flag")
        glv = bool(glv) and F is FQ_ADAPTER
        m = n * (2 if glv else 1)             # points of one factor block
        n_eff = m * factor                    # pipeline points of one chunk
        w = window_bits or window_bits_for(m, F, device)
        # factor 1 slices the input points (a piece GLV-extends its own),
        # factor > 1 the points of a factor block
        unit = m if factor > 1 else n
        pieces, per = _point_pieces(unit, n_eff, budget, bpp)
        groups, per_group = _balance_groups(
            chunks, 1 if pieces > 1 else budget // (n_eff * bpp))
        n_run = per * (n_eff // unit)
    elif not cached:
        if factor != 1 or batch != 1:
            raise ValueError("msm_geometry: factor and batch belong to cached "
                             "bases (cached=True)")
        glv = _resolve_glv(glv, n, budget, bpp, F)
        mult = 2 if glv else 1
        pieces, per = _point_pieces(n, n * mult, budget, bpp)
        n_run = per * mult
        w = window_bits or window_bits_for(n_run, F, device)
    else:
        if glv is None:
            glv = _resolve_glv(None, n * factor, budget, bpp, F)
        glv = bool(glv) and F is FQ_ADAPTER
        m = n * (2 if glv else 1)             # points of one factor block
        n_eff = m * factor
        if window_bits is None:
            from ..runtime.config import config

            window_bits = config().msm_window or window_bits_for(n_eff, F, device)
        w = window_bits
        if batch == 1:
            pieces, per = _point_pieces(m, n_eff, budget, bpp)
        else:
            # The element-major table is shared by the batch; the tiles
            # scale with B.  The point axis chunks when even one member
            # does not fit; then the batch runs in groups.
            W = 2 * _coord_planes(F)
            C = _coord_planes(F)
            shared, per_b = 4 * W * n_eff, 4 * (W + 5 * C) * n_eff
            pieces, per = 1, m
            if shared + per_b > budget and m > 1:
                pieces = -(-(shared + per_b) // budget) + 1
                while m % pieces and pieces < 64:
                    pieces += 1
                per = -(-m // pieces)
                if per >= m:
                    per = max(1, m // 2)
                pieces = -(-m // per)
            shared, per_b = 4 * W * per * factor, 4 * (W + 5 * C) * per * factor
            room = max(budget - shared, per_b)
            groups, per_group = _balance_groups(batch, room // per_b)
        n_run = per * factor
    # a factor-1 call's span is its window count
    T = precompute_window_span(w, factor, GLV_HALF_BITS_STATIC if glv else FR_BITS)
    runs = T * pieces * groups
    tail = None
    if pj.lane_scan_kernel(F, device) is not None:
        scan, add = TAIL_KERNELS[F.limb_planes]
        tail = {scan: TAIL_SCAN_LAUNCHES * runs,
                add: TAIL_ADDS * runs + groups * (pieces - 1) + T - 1}
    plan = _tile_plan(F, n_run, w, device)
    chains = [(runs, plan["lb_bits"]), (T - 1, w)]
    return {"glv": glv, "T": T, **plan,
            "doubling_chains": sum(k for k, d in chains if d > 0),
            "doublings": sum(k * d for k, d in chains),
            "factor": factor, "batch": batch, "chunks": chunks,
            "pieces": pieces, "per": per,
            "groups": groups, "per_group": per_group,
            "scan_launches": runs, "tail_launches": tail,
            "budget_bytes": budget, "bytes_per_point": bpp}


def _check_inputs(F, scalars, A):
    if F is not FQ_ADAPTER and F is not FQ2_ADAPTER:
        raise NotImplementedError(
            "msm: the field adapter must be FQ_ADAPTER (G1) or FQ2_ADAPTER (G2)")
    x, y, inf = A
    elem = tuple(F.elem_shape)
    for t, shape, name in ((scalars, (FR.num_limbs,), "scalars"),
                           (x, elem, "x"), (y, elem, "y")):
        if not isinstance(t, torch.Tensor) or t.dtype != LIMB_DTYPE:
            raise TypeError(f"msm: {name} must be a {LIMB_DTYPE} tensor")
        if t.dim() != len(shape) + 1 or tuple(t.shape[:-1]) != shape:
            raise ValueError(
                f"msm: {name} must have shape {shape + ('N',)}, got "
                f"{tuple(t.shape)}")
    if not isinstance(inf, torch.Tensor) or inf.dtype != torch.bool:
        raise TypeError("msm: inf must be a bool tensor")
    n = inf.shape[-1]
    if inf.dim() != 1 or not (scalars.shape[-1] == x.shape[-1] == y.shape[-1] == n):
        raise ValueError("msm: scalars, x, y and inf disagree on N")
    if not (scalars.device == x.device == y.device == inf.device):
        raise ValueError("msm: scalars and points live on different devices")


def _r_ws_add(F, Wa, Wb):
    """Group-add two stacked window-sum points (coordinates (T, *elem[, B])).

    The sequential point-chunk paths fold each chunk's per-window bucket
    sums into a running total with it (sums over points distribute per
    window), so the Horner ladder runs once per MSM and not once per chunk.
    The T axis is moved behind the element axes for the add and back after."""
    k = len(F.elem_shape)
    back = lambda P: tuple(c.movedim(0, k) for c in P)
    return tuple(c.movedim(k, 0) for c in g_add(F, back(Wa), back(Wb)))


def _horner_to_jac(F, Ws, w: int):
    with stage("horner"):
        return _stage_to_jac(F, _stage_horner(F, Ws, w))


def _msm_prelude(F, scalars, A, scalars_montgomery: bool):
    """The inputs checked, the size limit, the scalars in standard form:
    (n, scalars)."""
    _check_inputs(F, scalars, A)
    n = A[2].shape[-1]
    if n > (1 << constants.MAX_MSM_LOG_SIZE):
        raise ValueError(f"MSM size {n} exceeds 2^{constants.MAX_MSM_LOG_SIZE}")
    if scalars_montgomery:
        with stage("from_mont"):
            scalars = fast.from_mont(FR, scalars)
    return n, scalars


def msm(F, scalars, A, *, window_bits: int | None = None,
        scalars_montgomery: bool = True, glv: bool | None = None):
    """MSM: sum_i scalars[i] * A[i] over the curve with field adapter F.

    scalars: (16, N) int32 Fr limbs (Montgomery form by default).
    A: affine batch (x, y, inf).  Returns a single Jacobian point.  Runs on
    the device the tensors live on.

    ``glv`` (G1 only; default from MIDNIGHT_MSM_GLV) splits every scalar
    k = k1 + k2*lambda and runs the pipeline over [k1 || k2] against
    [A || phi(A)]: half the window count on 2n points.  ``auto`` turns it on
    while the doubled set fits the device memory budget in one shot.

    A point set that does not fit the budget in one shot runs in sequential
    point-chunks of equal size.  Equal chunks share one window geometry, so
    each chunk's per-window bucket sums fold into a running total and the
    Horner ladder and the Jacobian conversion run once.
    """
    n, scalars = _msm_prelude(F, scalars, A, scalars_montgomery)
    geo = msm_geometry(n, glv, F, A[2].device, window_bits)
    w = geo["w"]
    return _horner_to_jac(F, _pieces_window_sums(F, scalars, A, w, geo["glv"], geo["per"]), w)


def _pieces_window_sums(F, scalars_std, A, w: int, glv: bool, per: int):
    """Window sums over sequential point-chunks of ``per`` points (the
    budget's pieces): each piece's sums fold into a running total.  Scalars
    (16, [B,] n) against coordinates (*elem, [B,] n): with B, the chunks of
    :func:`msm_chunked`, each member against its own points."""
    x, y, inf = A
    n = inf.shape[-1]
    Ws = None
    for s in range(0, n, per):
        e = min(s + per, n)
        Ai = (x[..., s:e], y[..., s:e], inf[..., s:e])
        Wi = _msm_window_sums(F, scalars_std[..., s:e], Ai, w, glv)
        Ws = Wi if Ws is None else _r_ws_add(F, Ws, Wi)
    return Ws


def _window_sums_from_keys(F, keys, A, w: int):
    """The window loop: per-window signed-bucket sums for sort keys
    (T, n) or (T, B, n) against the affine batch A of n points (projective
    window sums stacked over the windows, coordinates (T, *elem[, B]))."""
    x, y, inf = A
    plan = _tile_plan(F, inf.shape[-1], w, inf.device)
    nb, lb_bits, L, R = (plan[k] for k in ("nb", "lb_bits", "L", "R"))
    with stage("keys"):
        em_rows = _stage_pack_rows(F, x, y)  # (n, 2C), shared by all windows

    window_sums = []
    for t in range(keys.shape[0]):
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


def _msm_window_sums(F, scalars_std, A, w: int, glv: bool):
    """Per-window signed-bucket sums for one point set: the whole pipeline
    short of the Horner ladder.  Split out of :func:`msm` so that the
    point-chunk path can add window sums across chunks and pay the ladder
    once."""
    num_bits = FR_BITS
    if glv:
        with stage("glv"):
            scalars_std, num_bits = glv_split_scalars(scalars_std)
            A = glv_extend_bases(F, A)
    with stage("keys"):
        keys = decompose_window_keys(scalars_std, w, num_bits)  # (T, N)
    return _window_sums_from_keys(F, keys, A, w)


def msm_traceable(F, scalars, A, *, window_bits: int | None = None,
                  scalars_montgomery: bool = True):
    """Same contract as :func:`msm`, as one call whose every shape follows
    from the inputs' shapes (the JAX package's one-trace MSM).

    The window is ``window_bits`` or the heuristic for n, the scan tile
    ``_tile_plan``'s; there is no GLV, no memory budget and no point pieces,
    and neither MIDNIGHT_MSM_GLV nor MIDNIGHT_MSM_HBM_BUDGET_MB is read.  At
    the same w it runs the kernels and torch ops of ``msm(F, ..., glv=False)``
    in one piece, in the same order, and returns the same limbs.

    Capture: after one eager call on the same shapes and device (it builds
    the kernels and makes the cached device constants), a call can be
    captured in a ``torch.cuda.CUDAGraph`` and replayed.  Nothing on the path
    reads a device value on the host, and every launch goes to the current
    stream, so the replay recomputes the result from whatever the input
    tensors hold at replay time::

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            msm_traceable(F, scalars, A)          # the warm call
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = msm_traceable(F, scalars, A)
        scalars.copy_(other_scalars)
        graph.replay()                            # out: the MSM of other_scalars
    """
    n, scalars = _msm_prelude(F, scalars, A, scalars_montgomery)
    w = window_bits or window_bits_for(n, F, A[2].device)
    return _horner_to_jac(F, _msm_window_sums(F, scalars, A, w, False), w)


def msm_g1(scalars, A, **kw):
    return msm(FQ_ADAPTER, scalars, A, **kw)


def msm_g2(scalars, A, **kw):
    return msm(FQ2_ADAPTER, scalars, A, **kw)


# -----------------------------------------------------------------------------
# Precomputed-multiples MSM.  With factor f the base array is expanded to
# [P, 2^(w*T')P, ..., 2^(w*T'(f-1))P], so the window loop shrinks from T to
# T' = ceil(T/f) windows over f*N points: memory for sequential windows.
# -----------------------------------------------------------------------------


def precompute_window_span(w: int, factor: int,
                           num_bits: int = FR_BITS) -> int:
    """T': windows per precomputed multiple (shift = w*T' bits)."""
    return -(-num_windows(w, num_bits) // factor)


def expand_bases(F, A, w: int, factor: int, num_bits: int = FR_BITS):
    """Affine bases (x, y, inf) of n points -> expanded (factor*n) points.

    Block j holds 2^(w*T'*j) * P_i (batched doublings, then one batched
    inversion a block, on the device the bases live on).  Returns the
    expanded affine batch; run once at set-up time.  ``num_bits``: the bit
    length of the scalars the expansion will serve (128 for GLV halves, which
    shrinks the shift between blocks).

    Large inputs expand in sequential point-slices (the doubling chain is
    pointwise, so any partition is exact): one shot keeps a projective copy
    of the whole array and the inversion's scratch alive.
    MIDNIGHT_EXPAND_CHUNK_LOG overrides the slice of 2^20 lanes.
    """
    if factor <= 1:
        return A
    n = A[2].shape[-1]
    cap = 1 << int(os.environ.get("MIDNIGHT_EXPAND_CHUNK_LOG", "20"))
    if n > cap:
        pieces = [expand_bases(F, tuple(c[..., s:s + cap] for c in A), w,
                               factor, num_bits)
                  for s in range(0, n, cap)]

        # back to block-major: a piece holds (.., factor*m) -> (.., factor, m);
        # the pieces join along the point axis of every block
        def stitch(cs):
            parts = [c.reshape(c.shape[:-1] + (factor, -1)) for c in cs]
            return torch.cat(parts, dim=-1).reshape(cs[0].shape[:-1] + (-1,))

        return tuple(stitch([p[c] for p in pieces]) for c in range(3))
    span = precompute_window_span(w, factor, num_bits) * w
    blocks = [A]
    cur = pj.affine_to_proj(F, A)
    for _ in range(factor - 1):
        cur = _double_n(F, cur, span)
        blocks.append(pj.proj_to_affine(F, cur))
    return tuple(torch.cat([b[c] for b in blocks], dim=-1) for c in range(3))


def _digits_for_precompute(scalars_std, w: int, factor: int,
                           num_bits: int = FR_BITS):
    """Digit tensors (T, [B,] N) regrouped to (T', [B,] factor*N), matching
    :func:`expand_bases`: window t = j*T' + t' of the scalars feeds base
    block j."""
    abs_d, signs = decompose_signed_digits(scalars_std, w, num_bits)
    if factor <= 1:
        return abs_d, signs
    T, n = abs_d.shape[0], abs_d.shape[-1]
    lead = tuple(abs_d.shape[1:-1])               # () or (B,)
    Tp = precompute_window_span(w, factor, num_bits)
    pad = Tp * factor - T

    def regroup(a):
        if pad:
            a = torch.cat([a, torch.zeros((pad,) + lead + (n,), dtype=a.dtype,
                                          device=a.device)])
        a = a.reshape((factor, Tp) + lead + (n,)).movedim(0, -2)
        return a.reshape((Tp,) + lead + (factor * n,))

    return regroup(abs_d), regroup(signs)


def _slice_factor_blocks(c, m: int, s: int, e: int, factor: int):
    """Slice points [s, e) out of every factor block of a block-major
    expanded tensor: (..., factor*m) -> (..., factor*(e-s))."""
    b = c.reshape(c.shape[:-1] + (factor, m))
    return b[..., s:e].reshape(c.shape[:-1] + (factor * (e - s),))


def _precomputed_window_sums(F, scalars_std, A_expanded, w: int, factor: int,
                             num_bits: int):
    """Per-window bucket sums for the precomputed-bases pipeline, one scalar
    set (16, m) or a batch (16, B, m) (coordinates (T', *elem[, B])); the
    Horner ladder is the caller's, so that chunked runs share it."""
    with stage("keys"):
        keys = _keys_from_digits(
            *_digits_for_precompute(scalars_std, w, factor, num_bits))
    return _window_sums_from_keys(F, keys, A_expanded, w)


def _cached_scalars(scalars, scalars_montgomery: bool, glv: bool):
    """Scalars of a cached-bases call -> standard form, GLV-split to match
    GLV-extended bases; returns (scalars, bit length)."""
    if scalars_montgomery:
        with stage("from_mont"):
            scalars = fast.from_mont(FR, scalars)
    if not glv:
        return scalars, FR_BITS
    with stage("glv"):
        return glv_split_scalars(scalars)


def _sliced_window_sums(F, scalars_std, A_expanded, w: int, factor: int,
                        num_bits: int, per: int):
    """Window sums over sequential point-chunks of ``per`` points: every
    factor block is sliced alike, so a piece is itself a precomputed MSM over
    the sliced bases, and the pieces' window sums add up."""
    m = scalars_std.shape[-1]
    if per >= m:
        return _precomputed_window_sums(F, scalars_std, A_expanded, w, factor,
                                        num_bits)
    Ws = None
    for s in range(0, m, per):
        e = min(s + per, m)
        Ai = tuple(_slice_factor_blocks(c, m, s, e, factor)
                   for c in A_expanded)
        Wi = _precomputed_window_sums(F, scalars_std[..., s:e], Ai, w, factor,
                                      num_bits)
        Ws = Wi if Ws is None else _r_ws_add(F, Ws, Wi)
    return Ws


def msm_precomputed(F, scalars, A_expanded, *, window_bits: int, factor: int,
                    scalars_montgomery: bool = True, glv: bool = False):
    """MSM against bases expanded by :func:`expand_bases` (same w and factor).

    ``glv``: the bases were uploaded GLV-extended ([A || phi(A)] before the
    expansion); the scalars are split to match and the window counts are
    those of 128-bit scalars.

    Like :func:`msm`, the point axis chunks sequentially when the working
    set would not fit the memory budget: this is the path a prover calls
    while it holds the expanded bases and its own buffers on the card.
    """
    factor = max(int(factor), 1)
    if factor == 1 and not glv:
        return msm(F, scalars, A_expanded, window_bits=window_bits,
                   scalars_montgomery=scalars_montgomery, glv=False)
    inf = A_expanded[2]
    n = inf.shape[-1] // (factor * (2 if glv else 1))
    geo = msm_geometry(n, glv, F, inf.device, window_bits, factor=factor,
                       cached=True)
    scalars, num_bits = _cached_scalars(scalars, scalars_montgomery, glv)
    Ws = _sliced_window_sums(F, scalars, A_expanded, window_bits, factor,
                             num_bits, geo["per"])
    return _horner_to_jac(F, Ws, window_bits)


# -----------------------------------------------------------------------------
# Batched MSM with shared bases: ONE pipeline for all B scalar sets.  The
# batch axis is folded between the element axes and the lanes of every tile,
# so each per-window stage runs once over B-times-wider lanes instead of B
# times: one batched sort, one row gather from the SHARED point table, one
# scan of B*L columns.
# -----------------------------------------------------------------------------


def msm_batch_shared(F, scalars_b, A, *, window_bits: int | None = None,
                     factor: int = 1, scalars_montgomery: bool = True,
                     glv: bool = False):
    """B MSMs over shared affine bases in one batched pipeline.

    scalars_b: (16, B, N) int32 Fr limbs (limbs first, batch in the middle).
    A: the affine bases, already expanded by :func:`expand_bases` when
    factor > 1 and GLV-extended beforehand when ``glv`` (the scalars are
    split to the 128-bit halves here).  Returns a Jacobian point batch,
    coordinates (*elem, B): one result per scalar set.

    The memory budget chunks both axes: the batch runs in sequential groups
    (their window sums join along the batch axis), and when even one member
    does not fit, the point axis chunks first (window sums add up).  All of
    it happens at the window-sum level, so the Horner ladder runs once.
    """
    factor = max(int(factor), 1)
    inf = A[2]
    n_eff = inf.shape[-1]
    B = scalars_b.shape[1]
    n = n_eff // (factor * (2 if glv else 1))
    w = window_bits or window_bits_for(n_eff // factor, F, inf.device)
    geo = msm_geometry(n, glv, F, inf.device, w, factor=factor, batch=B,
                       cached=True)
    scalars_b, num_bits = _cached_scalars(scalars_b, scalars_montgomery, glv)
    parts = [_sliced_window_sums(F, scalars_b[:, s:s + geo["per_group"]], A, w,
                                 factor, num_bits, geo["per"])
             for s in range(0, B, geo["per_group"])]
    Ws = tuple(torch.cat([p[c] for p in parts], dim=-1) for c in range(3))
    return _horner_to_jac(F, Ws, w)


# -----------------------------------------------------------------------------
# Chunked MSM: the same pipeline over a leading chunk axis, one partial MSM a
# chunk.  The scale-out layer's local step (parallel/msm.py): a rank runs its
# chunks here, and the chunk points are gathered and summed there.  The D
# chunks are one batch, folded between the element axes and the lanes as the
# shared-bases batch folds its B; each chunk brings its own point table.
# -----------------------------------------------------------------------------


def msm_chunked(F, scalars_c, A_c, *, window_bits: int | None = None,
                scalars_montgomery: bool = True, glv: bool = False,
                factor: int = 1):
    """MSM over chunked inputs; returns per-chunk Jacobian points (D leading).

    scalars_c: (D, 16, mloc) int32; A_c leaves (D, *elem, nloc) / inf
    (D, nloc), as ``parallel.msm.chunk_msm_inputs`` lays them out.  Result: a
    Jacobian point batch with leaves (D, *elem), one partial MSM a chunk;
    group-add them for the total (``parallel/msm.py::_combine_chunks``).

    Every chunk shares one geometry, the JAX package's: window bits from the
    chunk's points (after the GLV extension, over the factor), and the window
    count of the scalars' bit length.  ``glv`` (G1 only) splits each chunk's
    scalars to the GLV halves and, for factor 1, extends its bases with the
    endomorphism image in the chunk.  ``factor`` > 1: ``A_c`` holds bases
    already expanded by :func:`expand_bases` (with this ``window_bits`` and
    ``factor`` and, when ``glv``, GLV-extended before the expansion), chunked
    with ``segments = factor * (2 if glv else 1)``.

    The D chunks are one batch on the inputs' device, as the JAX package's
    ``mapper="vmap"`` maps every stage over them: one ``from_mont``, GLV split
    and key decomposition over all of them, and a window loop whose sort, scan
    (one launch over D*L columns) and tail run once a window for all D, each
    chunk gathering from its own point table; then one Horner ladder and one
    ``proj_to_jac``.  Each chunk's limbs are those of the one-device
    :func:`msm` (factor 1) or :func:`msm_precomputed` on that chunk at the
    same window bits.  ``msm_geometry(..., chunks=D)`` plans the memory
    budget: groups of chunks one after another where all D do not fit, and a
    chunk that does not fit alone in point pieces, as :func:`msm` runs them.
    There is no ``mapper``: several devices are several processes, one a
    device, each passing its own chunks (``parallel/msm.py``).
    """
    x, y, inf = A_c
    D, nloc = inf.shape[0], inf.shape[-1]
    if not (scalars_c.shape[0] == x.shape[0] == y.shape[0] == D):
        raise ValueError("msm_chunked: scalars, x, y and inf disagree on the chunk count")
    glv = glv and F is FQ_ADAPTER
    factor = max(int(factor), 1)
    # input points a chunk (factor > 1 bases arrive extended and expanded)
    n = nloc // (factor * (2 if glv and factor > 1 else 1))
    geo = msm_geometry(n, glv, F, inf.device, window_bits, factor=factor, chunks=D)
    w, per, G = geo["w"], geo["per"], geo["per_group"]

    def window_sums(s):
        """The group of chunks [s, s+G) as the batch: views with the chunk
        axis behind the element axes, scalars (16, G, m), coordinates
        (*elem, G, nloc); the stages copy only the group's own operands."""
        sc = scalars_c[s:s + G].movedim(0, 1)
        A = (x[s:s + G].movedim(0, -2), y[s:s + G].movedim(0, -2), inf[s:s + G])
        if factor > 1:
            sc, num_bits = _cached_scalars(sc, scalars_montgomery, glv)
            return _sliced_window_sums(F, sc, A, w, factor, num_bits, per)
        if scalars_montgomery:
            with stage("from_mont"):
                sc = fast.from_mont(FR, sc)
        return _pieces_window_sums(F, sc, A, w, glv, per)

    parts = [window_sums(s) for s in range(0, D, G)]
    Ws = tuple(torch.cat([p[c] for p in parts], dim=-1) for c in range(3))
    return tuple(c.movedim(-1, 0).contiguous() for c in _horner_to_jac(F, Ws, w))
