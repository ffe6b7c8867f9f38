"""CUDA kernels for the field hot ops, with their plain versions beside them.

Counterpart of the JAX package's ``fields/pallas_ops.py``:

* ``mont_mul`` takes the place of ``_build_mul_kernel`` / ``mont_mul``
  (``fields/pallas_ops.py:381``, ``:436``);
* ``mont_sqr`` takes the place of ``_build_sqr_kernel`` / ``mont_sqr``
  (``fields/pallas_ops.py:391``, ``:441``);
* ``field_inv`` takes the place of the two as the JAX package's
  ``fields/ops.py::inv_mont`` chains them (a^(p-2) in one jitted loop), where
  the port ran the ladder one product or square a launch (610 launches for
  Fq): one launch, a thread a lane;
* ``add`` and ``sub`` take the place of ``_build_add_kernel`` / ``add`` and
  ``_build_sub_kernel`` / ``sub`` (``fields/pallas_ops.py:401``, ``:411``),
  with one operand a (K, 1) column where it is one element; ``double``
  (a + a) and ``neg`` (0 - a) are the same kernels on one plane;
* ``field_sum`` takes the place of the add kernel as the JAX package's
  ``vecops.vector_sum`` chains it (a halving round a launch): the modular
  sum along the last axis in one or two launches;
* ``butterfly``, ``butterfly_stages`` and ``butterfly_stage`` take the place
  of ``_build_butterfly_kernel`` / ``butterfly`` (``fields/pallas_ops.py:421``,
  ``:453``).  ``butterfly`` is the TPU kernel's elementwise contract;
  ``butterfly_stages`` runs up to six consecutive stages of the radix-2
  ladder on the array where it lies in one launch (``csrc/ntt_stages.cu``,
  device code in ``csrc/ntt.cuh``), so the ladder needs no slices, broadcast
  twiddles or concatenation around the kernel, and no pass over the array a
  stage; ``butterfly_stage`` is that kernel at one stage;
* ``batch_inverse`` launches the three kernels of ``csrc/batch_inverse.cu``,
  Montgomery's batch inversion with the product and the square chained
  inside each phase, where ``vecops.batch_inverse`` ran ``mont_mul`` and
  ``mont_sqr`` launch by launch.  Its wrapper and plain version are
  ``vecops.batch_inverse`` and ``vecops.batch_inverse_plain``.

The kernels are CUDA C++ in ``csrc/field_kernels.cu``.  On an H100 the
memory bounds the product: an Fq product needs 144 bytes (three elements of
24 limbs of 16 bits) for 300 wide multiply-adds, and at the card's peak
rates the bytes take longer, narrowly; as stored, a 16-bit limb takes a
32-bit slot, so the kernel moves 288 bytes and the memory binds it twice as
hard.  So ``mont_mul`` and ``mont_sqr`` run the carry-chain product
(``csrc/field_carry.cuh``), for Fq four lanes a thread with a 16-byte access
per limb plane (Fr's lighter product reads faster one lane a thread); a
factor that is one element, a (K, 1) column, is read once a thread and held
in registers, so such a call moves two planes.  ``add`` and ``sub`` move the
same bytes for a few additions, so the memory binds them outright: they run
on the carry flag (``fp_add_cc`` / ``fp_sub_cc`` in ``csrc/field_carry.cuh``),
four lanes a thread for Fr and one for Fq, and each operand form moves only
its planes (a column is read once a thread; the doubling and the negation
read one plane).  A butterfly moves five elements for one product (PERF.md
has the reckoning); it is one thread an element on ``csrc/field.cuh``.

Each wrapper takes its plain version (``*_plain``, over the int64 ops of
``fields/ops.py``) only for tensors on the CPU.  For CUDA tensors it launches
the kernel or raises; there is no fallback.  The wrappers copy nothing:
operands must be contiguous and of one shape (``mont_mul``, ``add``, ``sub``:
or a plane and a (K, 1) column), and anything else raises
(``fields/fast.py`` broadcasts and lays out for them).  ``LAUNCHES`` counts
kernel launches, and nothing else: those of ``mont_mul``, ``add`` and
``sub`` with a column also in ``COLUMN_LAUNCHES`` by (kernel, lanes); the
doubling and the negation under ``double_fr`` / ``double_fq`` and
``neg_fr`` / ``neg_fq``; ``field_sum``'s one or two under ``sum_fr`` /
``sum_fq``; the
elementwise butterfly under ``butterfly_fr`` / ``butterfly_fq``, the
stages kernel (``butterfly_stage`` too) under ``butterfly_stages`` and, by
(half, count), in ``STAGE_LAUNCHES``; the inverse under ``field_inv_fr`` /
``field_inv_fq``; the batch inversion's three kernels under
``batch_inverse_fr`` / ``batch_inverse_fq``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import ops
from .field import FieldSpec

LAUNCHES = {"mont_mul_fr": 0, "mont_mul_fq": 0,
            "mont_sqr_fr": 0, "mont_sqr_fq": 0,
            "add_fr": 0, "add_fq": 0, "sub_fr": 0, "sub_fq": 0,
            "double_fr": 0, "double_fq": 0, "neg_fr": 0, "neg_fq": 0,
            "sum_fr": 0, "sum_fq": 0,
            "butterfly_fr": 0, "butterfly_fq": 0, "butterfly_stages": 0,
            "field_inv_fr": 0, "field_inv_fq": 0,
            "batch_inverse_fr": 0, "batch_inverse_fq": 0}
# butterfly_stages' launches by (half, count)
STAGE_LAUNCHES: dict = {}
# the launches with a (K, 1) column (counted in LAUNCHES too), by (kernel,
# lanes): "mont_mul_fr", "add_fq", "sub_fq", "sub_fq[column left]", ...
COLUMN_LAUNCHES: dict = {}

# The most stages one butterfly_stages launch runs (csrc/ntt.cuh).
MAX_STAGES = 6

_PTR = ctypes.c_void_p
# The libraries this module loads (``_build.library``): the field kernels,
# the batch inversion and the NTT's butterfly stages.
FIELD_LIBRARY, INVERSE_LIBRARY, STAGES_LIBRARY = "field_kernels", "batch_inverse", "ntt_stages"
_CONFIGURED = False
_BINV_CONFIGURED = False
_STAGES_CONFIGURED = False


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    STAGE_LAUNCHES.clear()
    COLUMN_LAUNCHES.clear()


def _lib():
    global _CONFIGURED
    lib = _build.library(FIELD_LIBRARY)
    if not _CONFIGURED:
        for name in ("mont_mul", "mont_mul_col", "field_add", "field_add_col",
                     "field_sub", "field_sub_col", "field_sub_col_left"):
            for sfx in ("fr", "fq"):
                fn = getattr(lib, f"{sfx}_{name}")
                fn.argtypes = [_PTR, _PTR, _PTR, ctypes.c_longlong, _PTR]
                fn.restype = ctypes.c_int
        for name in ("fr_field_sum", "fq_field_sum"):
            fn = getattr(lib, name)
            fn.argtypes = [_PTR] * 3 + [ctypes.c_longlong] * 2 + [_PTR]
            fn.restype = ctypes.c_int
        lib.field_sum_blocks_per_row.argtypes = [ctypes.c_longlong] * 2
        lib.field_sum_blocks_per_row.restype = ctypes.c_longlong
        for name in ("fr_butterfly", "fq_butterfly"):
            fn = getattr(lib, name)
            fn.argtypes = [_PTR] * 5 + [ctypes.c_longlong, _PTR]
            fn.restype = ctypes.c_int
        for name in ("fr_mont_sqr", "fq_mont_sqr", "fr_field_inv", "fq_field_inv",
                     "fr_field_double", "fq_field_double", "fr_field_neg", "fq_field_neg"):
            fn = getattr(lib, name)
            fn.argtypes = [_PTR, _PTR, ctypes.c_longlong, _PTR]
            fn.restype = ctypes.c_int
        _CONFIGURED = True
    return lib


def _binv_lib():
    global _BINV_CONFIGURED
    lib = _build.library(INVERSE_LIBRARY)
    if not _BINV_CONFIGURED:
        for name in ("fr_batch_inverse", "fq_batch_inverse"):
            fn = getattr(lib, name)
            fn.argtypes = [_PTR] * 5 + [ctypes.c_longlong] * 2 + [ctypes.c_int, _PTR]
            fn.restype = ctypes.c_int
        _BINV_CONFIGURED = True
    return lib


def _stages_lib():
    global _STAGES_CONFIGURED
    lib = _build.library(STAGES_LIBRARY)
    if not _STAGES_CONFIGURED:
        lib.fr_butterfly_stages.argtypes = (
            [_PTR] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [_PTR])
        lib.fr_butterfly_stages.restype = ctypes.c_int
        _STAGES_CONFIGURED = True
    return lib


def check_limbs(t, k: int, name: str) -> None:
    """Raise unless ``t`` is what the kernels take: contiguous int32
    (k, *batch) limbs."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != ops.LIMB_DTYPE:
        raise TypeError(f"{name}: expected dtype {ops.LIMB_DTYPE}, got {t.dtype}")
    if t.dim() < 1 or t.shape[0] != k:
        raise ValueError(f"{name}: expected shape ({k}, *batch), got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor, got strides "
                         f"{tuple(t.stride())} for shape {tuple(t.shape)}")


def check_launch(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error code {code}")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def mont_mul_plain(spec: FieldSpec, a, b):
    """Plain PyTorch version of the ``mont_mul`` kernel."""
    return ops.mont_mul(spec, a, b)


def mont_sqr_plain(spec: FieldSpec, a):
    """Plain PyTorch version of the ``mont_sqr`` kernel."""
    return ops.mont_sqr(spec, a)


def field_inv_plain(spec: FieldSpec, a):
    """Plain PyTorch version of the ``field_inv`` kernel: ``ops.inv_mont``,
    the JAX package's ladder (a square at every bit of p - 2, a product where
    the bit is set)."""
    return ops.inv_mont(spec, a)


def add_plain(spec: FieldSpec, a, b):
    """Plain PyTorch version of the ``add`` kernel."""
    return ops.add(spec, a, b)


def sub_plain(spec: FieldSpec, a, b):
    """Plain PyTorch version of the ``sub`` kernel."""
    return ops.sub(spec, a, b)


def double_plain(spec: FieldSpec, a):
    """Plain PyTorch version of ``double``: a + a."""
    return ops.add(spec, a, a)


def neg_plain(spec: FieldSpec, a):
    """Plain PyTorch version of ``neg``: 0 - a."""
    return ops.neg(spec, a)


def field_sum_plain(spec: FieldSpec, v):
    """Plain PyTorch version of ``field_sum``: the JAX package's
    ``vecops.vector_sum`` on the plain add, log2 n halving rounds along the
    last axis (an odd element out carried to the next round)."""
    n = v.shape[-1]
    while n > 1:
        half = n // 2
        red = ops.add(spec, v[..., :half], v[..., half:2 * half])
        if n % 2:
            red = torch.cat([red, v[..., -1:]], dim=-1)
            n = half + 1
        else:
            n = half
        v = red
    return v[..., 0]


def butterfly_plain(spec: FieldSpec, even, odd, w):
    """Plain PyTorch version of the ``butterfly`` kernel:
    (even + w*odd, even - w*odd)."""
    t = ops.mont_mul(spec, odd, w)
    return ops.add(spec, even, t), ops.sub(spec, even, t)


def butterfly_stage_plain(spec: FieldSpec, x, tw, half: int):
    """Plain PyTorch version of ``butterfly_stage``: the stage as the JAX
    package's ladder writes it (``ntt/ntt.py:49-61``), with a reshape, two
    slices, the strided twiddle broadcast over them, and a concatenation.
    ``tw`` is the table of a domain at least 2 ``half`` long (``K``, S/2): the
    stage's twiddle j is entry j * S / (2 half)."""
    K, n = x.shape[0], x.shape[-1]
    lead = tuple(x.shape[1:-1])
    m = 2 * half
    w = tw[:, ::2 * tw.shape[-1] // m][:, :half]
    w = w.reshape((K,) + (1,) * (len(lead) + 1) + (half,))
    xg = x.reshape((K,) + lead + (n // m, m))
    hi, lo = butterfly_plain(spec, xg[..., :half], xg[..., half:], w)
    return torch.cat([hi, lo], dim=-1).reshape(x.shape)


def butterfly_stages_plain(spec: FieldSpec, x, tw, half: int, count: int,
                           scale=None):
    """Plain PyTorch version of ``butterfly_stages``: ``butterfly_stage_plain``
    ``count`` times, then the scalar."""
    for c in range(count):
        x = butterfly_stage_plain(spec, x, tw, half << c)
    if scale is not None:
        x = ops.mont_mul(spec, x, scale.reshape((spec.num_limbs,) + (1,) * (x.dim() - 1)))
    return x


def _suffix(spec: FieldSpec) -> str:
    if spec.num_limbs == 16:
        return "fr"
    if spec.num_limbs == 24:
        return "fq"
    raise ValueError(f"no kernel for a field of {spec.num_limbs} limbs")


def _check_same(spec: FieldSpec, name: str, **operands) -> None:
    """Raise unless the operands are kernel limbs of one shape on one device."""
    first = None
    for label, t in operands.items():
        check_limbs(t, spec.num_limbs, f"{name}: {label}")
        if first is None:
            first = t
        elif t.device != first.device:
            raise ValueError(f"{name}: devices differ ({first.device}, {t.device})")
        elif t.shape != first.shape:
            raise ValueError(f"{name}: shapes differ ({tuple(first.shape)}, "
                             f"{tuple(t.shape)})")


def _launch(spec: FieldSpec, name: str, entry: str, *operands):
    """``{fr,fq}_<entry>`` on CUDA operands whose first is the output's
    shape; counted under ``<name>_{fr,fq}``."""
    first = operands[0]
    sfx = _suffix(spec)
    out = torch.empty_like(first)
    with torch.cuda.device(first.device):
        code = getattr(_lib(), f"{sfx}_{entry}")(
            *(t.data_ptr() for t in operands), out.data_ptr(),
            first.numel() // spec.num_limbs, stream_ptr(first.device))
    check_launch(code, f"{sfx}_{entry}")
    LAUNCHES[f"{name}_{sfx}"] += 1
    return out


def _binary(spec: FieldSpec, name: str, entry: str, plain, a, b):
    """One elementwise kernel of two operands: ``{fr,fq}_<entry>``."""
    _check_same(spec, name, a=a, b=b)
    if not a.is_cuda:
        return plain(spec, a, b)
    return _launch(spec, name, entry, a, b)


def _is_column(spec: FieldSpec, t) -> bool:
    return isinstance(t, torch.Tensor) and tuple(t.shape) == (spec.num_limbs, 1)


def _with_column(spec: FieldSpec, name: str, entry: str, plain, plane, col, key: str = ""):
    """``{fr,fq}_<entry>`` on a plane and one (K, 1) column that every lane
    takes (read once a thread, never laid out as a plane); on the CPU
    ``plain(plane, the column broadcast)``.  Counted under ``<name>_{fr,fq}``
    and in ``COLUMN_LAUNCHES`` under (``<name>_{fr,fq}<key>``, lanes)."""
    K = spec.num_limbs
    check_limbs(plane, K, f"{name}: plane")
    check_limbs(col, K, f"{name}: column")
    if plane.device != col.device:
        raise ValueError(f"{name}: devices differ ({plane.device}, {col.device})")
    if not plane.is_cuda:
        return plain(plane, col.reshape((K,) + (1,) * (plane.dim() - 1)))
    out = _launch(spec, name, entry, plane, col)
    k = (f"{name}_{_suffix(spec)}{key}", plane.numel() // K)
    COLUMN_LAUNCHES[k] = COLUMN_LAUNCHES.get(k, 0) + 1
    return out


def mont_mul(spec: FieldSpec, a, b):
    """Batched Montgomery product a*b*R^-1 mod p on (K, *batch) limbs.

    ``b`` is a plane of ``a``'s shape, or one element as a (K, 1) column that
    every lane of ``a`` takes."""
    if _is_column(spec, b):
        return _with_column(spec, "mont_mul", "mont_mul_col",
                            lambda p, c: mont_mul_plain(spec, p, c), a, b)
    return _binary(spec, "mont_mul", "mont_mul", mont_mul_plain, a, b)


def add(spec: FieldSpec, a, b):
    """Batched (a + b) mod p on (K, *batch) limbs, canonical in and out.

    ``a`` and ``b`` are planes of one shape, or one of them is one element
    as a (K, 1) column that every lane of the other takes (read once a
    thread, never laid out as a plane)."""
    if _is_column(spec, a) and not _is_column(spec, b):
        a, b = b, a                                  # the sum commutes
    if _is_column(spec, b):
        return _with_column(spec, "add", "field_add_col",
                            lambda p, c: add_plain(spec, p, c), a, b)
    return _binary(spec, "add", "field_add", add_plain, a, b)


def sub(spec: FieldSpec, a, b):
    """Batched (a - b) mod p on (K, *batch) limbs, canonical in and out;
    either operand may be one element as a (K, 1) column."""
    if _is_column(spec, b):
        return _with_column(spec, "sub", "field_sub_col",
                            lambda p, c: sub_plain(spec, p, c), a, b)
    if _is_column(spec, a):
        return _with_column(spec, "sub", "field_sub_col_left",
                            lambda p, c: sub_plain(spec, c, p), b, a, "[column left]")
    return _binary(spec, "sub", "field_sub", sub_plain, a, b)


def double(spec: FieldSpec, a):
    """Batched (a + a) mod p: the ``add`` kernel on one plane, which it
    reads once."""
    check_limbs(a, spec.num_limbs, "double: a")
    if not a.is_cuda:
        return double_plain(spec, a)
    return _launch(spec, "double", "field_double", a)


def neg(spec: FieldSpec, a):
    """Batched (0 - a) mod p, 0 for 0: the ``sub`` kernel on one plane."""
    check_limbs(a, spec.num_limbs, "neg: a")
    if not a.is_cuda:
        return neg_plain(spec, a)
    return _launch(spec, "neg", "field_neg", a)


def field_sum(spec: FieldSpec, v):
    """The modular sum along the last axis: (K, *batch, n) -> (K, *batch),
    canonical in and out, n >= 1, ``v`` contiguous.

    On the card one pass over ``v`` (a block sums a grid-stride part of a
    row in registers, shuffle trees over the warps and their partials, one
    partial a block) and a second over the partials, or one where a row
    takes one block: one or two launches, counted under ``sum_{fr,fq}``.
    Modular addition of canonical values is exact, so the limbs equal the
    halving tree's (``field_sum_plain``) bit for bit."""
    K = spec.num_limbs
    check_limbs(v, K, "field_sum: v")
    if v.dim() < 2 or v.shape[-1] < 1:
        raise ValueError(f"field_sum: expected ({K}, *batch, n) with n >= 1, got "
                         f"{tuple(v.shape)}")
    if not v.is_cuda:
        return field_sum_plain(spec, v)
    n = v.shape[-1]
    rows = v.numel() // (K * n)
    out = torch.empty((K,) + tuple(v.shape[1:-1]), dtype=v.dtype, device=v.device)
    if rows == 0:
        return out
    lib, sfx = _lib(), _suffix(spec)
    G = lib.field_sum_blocks_per_row(n, rows)
    scratch = (torch.empty((K, rows, G), dtype=v.dtype, device=v.device).data_ptr()
               if G > 1 else None)
    with torch.cuda.device(v.device):
        code = getattr(lib, f"{sfx}_field_sum")(v.data_ptr(), out.data_ptr(), scratch,
                                                n, rows, stream_ptr(v.device))
    check_launch(code, f"{sfx}_field_sum")
    LAUNCHES[f"sum_{sfx}"] += 2 if G > 1 else 1
    return out


def mont_sqr(spec: FieldSpec, a):
    """Batched Montgomery square a*a*R^-1 mod p on (K, *batch) limbs."""
    check_limbs(a, spec.num_limbs, "mont_sqr: a")
    if not a.is_cuda:
        return mont_sqr_plain(spec, a)
    return _launch(spec, "mont_sqr", "mont_sqr", a)


def field_inv(spec: FieldSpec, a):
    """Batched Montgomery-form inverse on (K, *batch) limbs, inv(0) = 0, in
    one launch: a thread a lane runs a^(p-2) on the carry-chain product
    (``csrc/field_carry.cuh::fp_inv_fermat``), left to right in 4-bit windows
    of p - 2 from a table of a^0 .. a^15.  The JAX package's ladder (and
    ``field_inv_plain``) squares at every bit and multiplies and selects
    where the bit is set; the windows branch on the public exponent only,
    never on the base.  An inverse is unique and canonical, so the limbs
    equal the ladder's bit for bit, 0 for 0.  Meant for few lanes (the
    affine conversion of a few points): one thread's chain of 485
    dependent products (Fq) bounds it; many lanes take
    ``vecops.batch_inverse``."""
    check_limbs(a, spec.num_limbs, "field_inv: a")
    if not a.is_cuda:
        return field_inv_plain(spec, a)
    return _launch(spec, "field_inv", "field_inv", a)


def butterfly(spec: FieldSpec, even, odd, w):
    """Fused radix-2 butterfly (even + w*odd, even - w*odd), elementwise on
    three (K, *batch) operands of one shape."""
    _check_same(spec, "butterfly", even=even, odd=odd, w=w)
    if not even.is_cuda:
        return butterfly_plain(spec, even, odd, w)
    sfx = _suffix(spec)
    hi, lo = torch.empty_like(even), torch.empty_like(even)
    with torch.cuda.device(even.device):
        code = getattr(_lib(), f"{sfx}_butterfly")(
            even.data_ptr(), odd.data_ptr(), w.data_ptr(), hi.data_ptr(),
            lo.data_ptr(), even.numel() // spec.num_limbs,
            stream_ptr(even.device))
    check_launch(code, f"{sfx}_butterfly")
    LAUNCHES[f"butterfly_{sfx}"] += 1
    return hi, lo


def butterfly_stages(spec: FieldSpec, x, tw, half: int, count: int, scale=None):
    """``count`` consecutive stages of the radix-2 DIT ladder along the last
    axis of ``x``, from ``half`` up, in one launch; then times ``scale``.

    ``x`` is (K, ..., n).  At each stage, within every group of ``2 * h``
    elements (h = half, 2 half, ...), element j of the low half and element j
    of the high half become (e + w*o, e - w*o) with w = w_(2h)^j.  ``tw`` is
    the (K, S/2) table w_S^0 .. w_S^(S/2 - 1) of a domain of size S with
    2^count * half <= S <= n: the ladder's own (S = n), or that of the
    launch's top stage, whose entries then lie close together.  ``scale``:
    None or one (K,) element.  1 <= count <= ``MAX_STAGES``.  Returns a new
    tensor of ``x``'s shape.  Fr only: the NTT runs over no other field.
    """
    K = spec.num_limbs
    if K != 16:
        raise ValueError("butterfly_stages: the kernel is built for Fr only")
    check_limbs(x, K, "butterfly_stages: x")
    check_limbs(tw, K, "butterfly_stages: tw")
    if x.device != tw.device:
        raise ValueError(f"butterfly_stages: devices differ ({x.device}, {tw.device})")
    n = x.shape[-1] if x.dim() > 1 else 0
    if n < 2 or n & (n - 1):
        raise ValueError(f"butterfly_stages: the last axis must be a power of "
                         f"two >= 2, got shape {tuple(x.shape)}")
    if not 1 <= count <= MAX_STAGES:
        raise ValueError(f"butterfly_stages: count = {count} is not in [1, {MAX_STAGES}]")
    if half < 1 or half & (half - 1) or half << count > n:
        raise ValueError(f"butterfly_stages: half = {half} is no power of two "
                         f"with half * 2^{count} <= {n}")
    S = 2 * tw.shape[-1] if tw.dim() == 2 else 0
    if S & (S - 1) or not half << count <= S <= n:
        raise ValueError(f"butterfly_stages: expected twiddles of shape ({K}, S/2) "
                         f"with S a power of two in [{half << count}, {n}], got "
                         f"{tuple(tw.shape)}")
    if scale is not None:
        check_limbs(scale, K, "butterfly_stages: scale")
        if scale.dim() != 1 or scale.device != x.device:
            raise ValueError(f"butterfly_stages: expected a scalar of shape ({K},) on "
                             f"{x.device}, got {tuple(scale.shape)} on {scale.device}")
    if not x.is_cuda:
        return butterfly_stages_plain(spec, x, tw, half, count, scale)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        code = _stages_lib().fr_butterfly_stages(
            x.data_ptr(), tw.data_ptr(), scale.data_ptr() if scale is not None else None,
            out.data_ptr(), x.numel() // K, half.bit_length() - 1, count,
            S.bit_length() - 1, stream_ptr(x.device))
    check_launch(code, "fr_butterfly_stages")
    LAUNCHES["butterfly_stages"] += 1
    STAGE_LAUNCHES[(half, count)] = STAGE_LAUNCHES.get((half, count), 0) + 1
    return out


def butterfly_stage(spec: FieldSpec, x, tw, half: int):
    """One stage of the radix-2 DIT ladder along the last axis of ``x``:
    ``butterfly_stages`` at one stage.

    ``x`` is (K, ..., n); ``tw`` is the (K, n/2) table of w_n^0..w_n^(n/2-1).
    Within every group of ``2 * half`` elements, element j of the low half
    and element j of the high half become (e + w*o, e - w*o) with
    w = w_n^(j * n / (2 * half)).  Returns a new tensor of ``x``'s shape.
    """
    if spec.num_limbs != 16:
        raise ValueError("butterfly_stage: the kernel is built for Fr only")
    n = x.shape[-1] if x.dim() > 1 else 0
    if n >= 2 and not n & (n - 1) and tuple(tw.shape) != (spec.num_limbs, n // 2):
        raise ValueError(f"butterfly_stage: expected twiddles of shape "
                         f"({spec.num_limbs}, {n // 2}), got {tuple(tw.shape)}")
    return butterfly_stages(spec, x, tw, half, 1)


def batch_inverse(spec: FieldSpec, x, lanes: int):
    """The three batch-inversion kernels on CUDA limbs ``x`` (K, n),
    contiguous: the elementwise Montgomery inverse, inv(0) = 0, on an
    (R, lanes) tile with R = ceil(n / lanes).  Three launches; raises if one
    fails.  ``vecops.batch_inverse`` is the wrapper that lays out for it and
    takes the plain version on the CPU."""
    K = spec.num_limbs
    check_limbs(x, K, "batch_inverse: x")
    if x.dim() != 2:
        raise ValueError(f"batch_inverse: expected ({K}, n), got {tuple(x.shape)}")
    if not x.is_cuda:
        raise ValueError("batch_inverse: the kernels take CUDA tensors "
                         "(vecops.batch_inverse_plain is the CPU's)")
    n = x.shape[1]
    L = min(int(lanes), n)
    if L < 1:
        return torch.empty_like(x)
    R = -(-n // L)
    sfx = _suffix(spec)
    dev = x.device
    new = lambda m: torch.empty((K, m), dtype=x.dtype, device=dev)
    out, pre, col, colinv = new(n), new((R - 1) * L), new(L), new(L)
    with torch.cuda.device(dev):
        code = getattr(_binv_lib(), f"{sfx}_batch_inverse")(
            x.data_ptr(), out.data_ptr(), pre.data_ptr(), col.data_ptr(),
            colinv.data_ptr(), n, L, R, stream_ptr(dev))
    check_launch(code, f"{sfx}_batch_inverse")
    LAUNCHES[f"batch_inverse_{sfx}"] += 3
    return out
