"""Multi-precision modular arithmetic on 32-bit word tensors (device path).

Counterpart of the JAX package's ``ops/limbs.py`` and ``ops/fields.py``.
Every BLS12-381 field element is a vector of little-endian 32-bit words held
in ``torch.int32`` (the bit pattern is the unsigned word): Fp is
``[..., 12]`` with Montgomery radix R = 2^384, the same radix as the JAX
package's 32 x 12-bit limbs, and Fr is ``[..., 8]`` with R = 2^256, which is
NOT the JAX package's 2^264 (compare canonical integers, never raw Fr
Montgomery words; :mod:`.jax_state` converts).  Values are canonical
(< modulus) at every function boundary.

On a CUDA tensor each arithmetic function launches its hand-written kernel
(``csrc/field_kernels.cu``: K1 ``kzg_fp_mont_mul`` replaces the JAX package's
``pallas_kernels.py:248`` ``mont_mul_fp_pallas``, K2 ``kzg_fr_mont_mul``
replaces ``:252`` ``mont_mul_fr_pallas``; a constant-exponent chain of their
products is one launch of ``kzg_fp_pow_const`` or ``kzg_fr_pow_const``;
modular add, sub, compare, the blob ingest and the domain sum are small
launchers on the same device functions) or raises.  On a CPU tensor it runs
the kernel's plain PyTorch version, ``*_plain`` below.
PyTorch has no usable uint32 arithmetic, so the plain versions work in
int64 on 16-bit half-words (24 for Fp, 16 for Fr): a column of half-word
products stays below 2^37, and carries are resolved by repeated
carry-save passes until none is left.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..golden.field import P, R
from . import _build

WORD_BITS = 32
MAX_POW_DIGITS = 96  # 4-bit digits of the chain kernels' largest exponent (< 2^384)
HALF_BITS = 16
HALF_MASK = (1 << HALF_BITS) - 1

# Launch counts of K1, K2 and the field launchers, by C entry point: plain
# ints that _build.launch adds one to at each launch (shared with curve.py).
LAUNCHES = _build.LAUNCHES


class FieldSpec:
    """Static per-field constants and the names of its kernels."""

    def __init__(self, name: str, modulus: int, nwords: int):
        self.name = name
        self.modulus = modulus
        self.nwords = nwords
        self.nhalves = 2 * nwords
        r = 1 << (WORD_BITS * nwords)
        self.mont_r = r % modulus  # mont(1) as an int
        self.r2 = (r * r) % modulus  # to-mont factor
        self.nprime = (-pow(modulus, -1, r)) % r  # -N^-1 mod R
        self.kernels = {
            op: f"kzg_{name}_{op}" for op in ("mont_mul", "pow_const", "add", "sub", "cmp")
        }
        self._consts: dict = {}

    def const(self, name, device) -> torch.Tensor:
        """A cached constant on ``device`` (uploaded once, so a launch
        sequence never waits on a host copy): an int ``name`` as [nwords]
        int32 words; word tensors ``mod``, ``r2``, ``one`` (1), ``one_mont``,
        ``zero``; and for the plain versions ``mod_h``, ``nprime_h``
        [nhalves] int64 half-words."""
        device = torch.device(device)
        key = (name, str(device))
        t = self._consts.get(key)
        if t is None:
            values = {
                "mod": self.modulus,
                "r2": self.r2,
                "one": 1,
                "one_mont": self.mont_r,
                "zero": 0,
            }
            if isinstance(name, int):
                t = torch.from_numpy(int_to_words(self.nwords, name))
            elif name in values:
                t = torch.from_numpy(int_to_words(self.nwords, values[name]))
            else:
                v = {"mod_h": self.modulus, "nprime_h": self.nprime}[name]
                t = torch.tensor(
                    [(v >> (HALF_BITS * k)) & HALF_MASK for k in range(self.nhalves)],
                    dtype=torch.int64,
                )
            t = t.to(device)
            self._consts[key] = t
        return t

    def __repr__(self):  # pragma: no cover
        return f"FieldSpec({self.name}, {self.nwords} words)"


FP = FieldSpec("fp", P, 12)
FR = FieldSpec("fr", R, 8)
_BY_WIDTH = {FP.nwords: FP, FR.nwords: FR}


# ---------------------------------------------------------------------------
# Host codecs (python ints <-> word arrays)
# ---------------------------------------------------------------------------


def int_to_words(nwords: int, value: int) -> np.ndarray:
    """One python int -> [nwords] int32 little-endian 32-bit words."""
    return ints_to_words(nwords, [value])[0]


def ints_to_words(nwords: int, values) -> np.ndarray:
    """Python ints -> [B, nwords] int32 words (the bit pattern is the
    unsigned word)."""
    buf = b"".join(int(v).to_bytes(4 * nwords, "little") for v in values)
    arr = np.frombuffer(buf, dtype="<u4").reshape(len(values), nwords)
    return arr.astype(np.uint32).view(np.int32).copy()


def words_to_ints(arr) -> list[int]:
    """[B, nwords] words (tensor or array) -> list of python ints."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    arr = np.ascontiguousarray(arr).view(np.uint32).astype("<u4")
    nbytes = 4 * arr.shape[-1]
    buf = arr.tobytes()
    return [
        int.from_bytes(buf[i : i + nbytes], "little") for i in range(0, len(buf), nbytes)
    ]


def to_device(spec: FieldSpec, values, device) -> torch.Tensor:
    """Python ints -> [B, nwords] int32 tensor on ``device``."""
    return torch.from_numpy(ints_to_words(spec.nwords, values)).to(device)


def bytes_be_to_words(by: torch.Tensor) -> torch.Tensor:
    """[..., 4k] uint8 big-endian integers -> [..., k] int32 little-endian
    words, with torch ops on the tensor's own device."""
    x = by.contiguous().view(torch.int32)  # bytes b0..b3 read little-endian
    x = ((x >> 24) & 0xFF) | ((x >> 8) & 0xFF00) | ((x & 0xFF00) << 8) | (x << 24)
    return x.flip(-1)


# ---------------------------------------------------------------------------
# Plain versions (int64 half-words; any device)
# ---------------------------------------------------------------------------


def _halves(x: torch.Tensor) -> torch.Tensor:
    """int32 words [..., n] -> int64 half-words [..., 2n]."""
    w = x.to(torch.int64) & 0xFFFFFFFF
    return torch.stack((w & HALF_MASK, w >> HALF_BITS), dim=-1).flatten(-2)


def _words(h: torch.Tensor) -> torch.Tensor:
    """Normalized int64 half-words [..., 2n] -> int32 words [..., n]."""
    h = h.unflatten(-1, (-1, 2))
    w = h[..., 0] | (h[..., 1] << HALF_BITS)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def _pad_top(t: torch.Tensor, k: int = 1) -> torch.Tensor:
    return F.pad(t, (0, k))


def _norm(t: torch.Tensor, with_top: bool = False):
    """Signed int64 digits -> digits in [0, 2^16), by carry-save passes
    until no carry is left.  The value is kept modulo 2^(16 * width); with
    ``with_top`` also returns the carry out of the top digit (-1 for a
    negative value)."""
    top = t.new_zeros(t.shape[:-1]) if with_top else None
    while True:
        c = t >> HALF_BITS
        if not bool(c.any()):
            return (t, top) if with_top else t
        if with_top:
            top = top + c[..., -1]
        t = (t & HALF_MASK) + F.pad(c[..., :-1], (1, 0))


def _mul_cols(a: torch.Tensor, b: torch.Tensor, nout: int) -> torch.Tensor:
    """Column sums of the half-word product a x b, truncated or zero-padded
    to ``nout`` columns: one outer product, sheared so that every
    anti-diagonal lines up in a column, then one sum."""
    ka, kb = a.shape[-1], b.shape[-1]
    prod = a.unsqueeze(-1) * b.unsqueeze(-2)  # [..., ka, kb]
    width = ka + kb - 1
    f = _pad_top(prod, ka)  # [..., ka, kb + ka]
    cols = f.flatten(-2)[..., : ka * width].unflatten(-1, (ka, width)).sum(-2)
    if nout <= width:
        return cols[..., :nout]
    return _pad_top(cols, nout - width)


def _reduce_once(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """Half-words [..., k(+1)] of a value < 2N -> canonical int32 words."""
    mod = spec.const("mod_h", x.device)
    if x.shape[-1] > mod.shape[-1]:
        mod = _pad_top(mod, x.shape[-1] - mod.shape[-1])
    d, top = _norm(x - mod, with_top=True)
    out = torch.where((top < 0).unsqueeze(-1), x, d)
    return _words(out[..., : spec.nhalves])


def mont_mul_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of K1/K2: a * b * R^-1 mod N by SOS: T = a b, m = T N'
    mod R, (T + m N) / R, one conditional subtract."""
    k = spec.nhalves
    t = _norm(_mul_cols(_halves(a), _halves(b), 2 * k))  # T < N^2 < R^2
    m = _norm(_mul_cols(t[..., :k], spec.const("nprime_h", t.device), k))  # mod R
    u = _norm(t + _mul_cols(m, spec.const("mod_h", t.device), 2 * k))  # < 2 R N
    return _reduce_once(spec, u[..., k:])


def add_mod_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    s = _norm(_pad_top(_halves(a) + _halves(b)))
    return _reduce_once(spec, s)


def sub_mod_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d, top = _norm(_halves(a) - _halves(b), with_top=True)
    wrapped = _norm(d + spec.const("mod_h", d.device))  # drops 2^(16k): a - b + N
    return _words(torch.where((top < 0).unsqueeze(-1), wrapped, d))


def cmp_plain(a: torch.Tensor, b: torch.Tensor, mode: int) -> torch.Tensor:
    """mode 0: a == b; mode 1: a >= b as integers.  Returns bool [...]."""
    a, b = torch.broadcast_tensors(a, b)
    if mode == 0:
        return (a == b).all(-1)
    _, top = _norm(_halves(a) - _halves(b), with_top=True)
    return top == 0


def ingest_check_plain(blob_bytes: torch.Tensor):
    """Plain version of ``kzg_fr_ingest`` (:func:`ingest_check`): the blob
    bytes through :func:`bytes_be_to_words` (domain-major for [B, n, 32]),
    then ``any(words >= r)``."""
    words = bytes_be_to_words(blob_bytes.transpose(0, 1) if blob_bytes.dim() == 3 else blob_bytes)
    return words, ~cmp_plain(words, FR.const("mod", words.device), 1).any()


def sum_mod_plain(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """Modular sum along axis 0 as a halving tree of plain adds."""
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        s = add_mod_plain(spec, x[:h], x[h : 2 * h])
        x = torch.cat([s, x[2 * h :]]) if x.shape[0] % 2 else s
    return x[0]


# ---------------------------------------------------------------------------
# Kernel launchers
# ---------------------------------------------------------------------------


def _index_map(x: torch.Tensor, shape: tuple, nwords: int):
    """(div, mod, contiguous x) such that output element i reads element
    ``(i / div) % mod`` of x; a broadcast that is not one contiguous run of
    output dims is materialised instead."""
    xs = (1,) * (len(shape) - (x.dim() - 1)) + tuple(x.shape[:-1])
    kept = [i for i, (s, t) in enumerate(zip(shape, xs)) if s != 1 and t == s]
    bcast = [i for i, (s, t) in enumerate(zip(shape, xs)) if s != 1 and t == 1]
    lo, hi = (kept[0], kept[-1] + 1) if kept else (len(shape), len(shape))
    if any(lo <= i < hi for i in bcast):
        x, lo, hi = x.expand(shape + (nwords,)), 0, len(shape)
    return math.prod(shape[hi:]), math.prod(shape[lo:hi]), x.contiguous()


def _check(spec: FieldSpec, *xs: torch.Tensor) -> None:
    for x in xs:
        if x.dtype != torch.int32 or x.shape[-1] != spec.nwords:
            raise ValueError(
                f"{spec.name}: expected int32 [..., {spec.nwords}], got {x.dtype} {tuple(x.shape)}"
            )
        if x.device != xs[0].device:
            raise ValueError(f"{spec.name}: operands on {xs[0].device} and {x.device}")


def _check_aligned(name: str, *xs: torch.Tensor) -> None:
    """The kernels move each element with 16-byte accesses: every operand
    and output starts on 16 bytes (a contiguous word tensor always does, its
    elements being 48 or 32 bytes)."""
    for x in xs:
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: operand at {x.data_ptr():#x} is not 16-byte aligned")


def _launch_binary(name: str, spec: FieldSpec, a, b, out_dtype, out_last, *extra):
    shape = tuple(torch.broadcast_shapes(a.shape[:-1], b.shape[:-1]))
    n = math.prod(shape)
    if n >= 1 << 31:
        raise ValueError(f"{name}: {n} elements exceed the kernel's 32-bit index")
    out = torch.empty(shape + out_last, dtype=out_dtype, device=a.device)
    if n:
        a_div, a_mod, a = _index_map(a, shape, spec.nwords)
        b_div, b_mod, b = _index_map(b, shape, spec.nwords)
        _check_aligned(name, a, b, out)
        _build.launch(name, a.device, a, b, out, n, a_div, a_mod, b_div, b_mod, *extra)
    return out


def mont_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product ``a * b * R^-1 mod N`` (operands broadcast)."""
    _check(spec, a, b)
    if a.device.type == "cpu":
        return mont_mul_plain(spec, a, b)
    return _launch_binary(spec.kernels["mont_mul"], spec, a, b, torch.int32, (spec.nwords,))


def add_mod(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _check(spec, a, b)
    if a.device.type == "cpu":
        return add_mod_plain(spec, a, b)
    return _launch_binary(spec.kernels["add"], spec, a, b, torch.int32, (spec.nwords,))


def sub_mod(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b mod N (operands broadcast): on the card :func:`fr_sub` for Fr,
    ``kzg_fp_sub`` for Fp."""
    _check(spec, a, b)
    if a.device.type == "cpu":
        return sub_mod_plain(spec, a, b)
    if spec is FR:
        return fr_sub(a, b)
    return _launch_binary(spec.kernels["sub"], spec, a, b, torch.int32, (spec.nwords,))


SUB_ROWS = (1, 2, 4, 8)  # the Fr difference's rows a thread: the kernel's variants
SUB_ROWS_DEFAULT = 2


def sub_view(a: torch.Tensor, b: torch.Tensor):
    """The Fr difference's view of ``a - b`` (word tensors, broadcast):
    (shape, rows, cols, a_rs, a_cs, b_rs, b_cs), the output's shape and its
    elements as [rows, cols], operand element (r, c) at r rs + c cs
    elements from its start (0 along a broadcast).  The output's dims
    longer than 1 merge where both operands' strides allow; ValueError
    where more than two remain, or an operand's words are not whole
    contiguous elements."""
    shape = tuple(torch.broadcast_shapes(a.shape[:-1], b.shape[:-1]))
    for x in (a, b):
        if x.stride(-1) != 1 or any(s % x.shape[-1] for s in x.stride()[:-1]):
            raise ValueError(f"kzg_fr_sub: operand strides {x.stride()} are not whole contiguous elements")
    dims = []  # (size, a stride, b stride) of each output dim longer than 1, outermost first
    for d, size in enumerate(shape):
        if size == 1:
            continue
        strides = []
        for x in (a, b):
            k = d - (len(shape) - (x.dim() - 1))
            strides.append(0 if k < 0 or x.shape[k] == 1 else x.stride(k) // x.shape[-1])
        if dims and dims[-1][1] == strides[0] * size and dims[-1][2] == strides[1] * size:
            dims[-1] = (dims[-1][0] * size, *strides)
        else:
            dims.append((size, *strides))
    if len(dims) > 2:
        raise ValueError(f"kzg_fr_sub: {tuple(a.shape)} - {tuple(b.shape)} does not collapse to two dims")
    (rows, a_rs, b_rs), (cols, a_cs, b_cs) = [(1, 0, 0)] * (2 - len(dims)) + dims
    return shape, rows, cols, a_rs, a_cs, b_rs, b_cs


def fr_sub(a: torch.Tensor, b: torch.Tensor, rows_per_thread: int = SUB_ROWS_DEFAULT) -> torch.Tensor:
    """a - b mod r on the card, one launch of ``kzg_fr_sub`` over
    :func:`sub_view`'s [rows, cols], ``rows_per_thread`` rows a thread (one
    of :data:`SUB_ROWS`), no broadcast copy; raises for a view that does
    not collapse or an operand off 16 bytes."""
    _check(FR, a, b)
    if rows_per_thread not in SUB_ROWS:
        raise ValueError(f"kzg_fr_sub: {rows_per_thread} rows a thread, not one of {SUB_ROWS}")
    shape, rows, cols, a_rs, a_cs, b_rs, b_cs = sub_view(a, b)
    n = rows * cols
    if n >= 1 << 31 or cols >= 1 << 30:
        raise ValueError(f"kzg_fr_sub: [{rows}, {cols}] exceeds the kernel's 32-bit index (two threads an element)")
    out = torch.empty(shape + (FR.nwords,), dtype=torch.int32, device=a.device)
    if n:
        _check_aligned("kzg_fr_sub", a, b, out)
        _build.launch("kzg_fr_sub", a.device, a, b, out, rows, cols, a_rs, a_cs, b_rs, b_cs, rows_per_thread)
    return out


def neg_mod(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return sub_mod(spec, spec.const("zero", a.device), a)


def _compare(a: torch.Tensor, b: torch.Tensor, mode: int) -> torch.Tensor:
    spec = _BY_WIDTH[a.shape[-1]]
    _check(spec, a, b)
    if a.device.type == "cpu":
        return cmp_plain(a, b, mode)
    return _launch_binary(spec.kernels["cmp"], spec, a, b, torch.uint8, (), mode).bool()


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _compare(a, b, 0)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return _compare(a, _BY_WIDTH[a.shape[-1]].const("zero", a.device), 0)


def geq_mod(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """a >= modulus (word vectors); bool [...]."""
    return _compare(a, spec.const("mod", a.device), 1)


def geq_const(spec: FieldSpec, a: torch.Tensor, bound: int) -> torch.Tensor:
    """a >= bound (an int); bool [...]."""
    return _compare(a, spec.const(bound, a.device), 1)


def ingest_check(blob_bytes: torch.Tensor, flag: torch.Tensor | None = None):
    """Blob ingest and canonicality: big-endian field elements [B, n, 32]
    uint8 -> (words [n, B, 8], domain-major; [n, 8] for one blob's [n, 32]),
    ok: a zero-dim bool tensor on the tensor's device, False iff an element
    is >= r (the words of such a blob are the bytes' integers; the caller
    raises).  Nothing waits for the device.  On the card one launch of
    ``kzg_fr_ingest`` after setting ``flag`` (a zero-dim uint8 tensor, the
    caller's, e.g. a captured graph's own; by default a fresh one) to 1;
    ``ok`` is a view of it.  The bytes are contiguous and start on 16 bytes."""
    if blob_bytes.dtype != torch.uint8 or blob_bytes.dim() not in (2, 3) or blob_bytes.shape[-1] != 32:
        raise ValueError(f"ingest: expected uint8 [B, n, 32] or [n, 32] bytes, got {blob_bytes.dtype} {tuple(blob_bytes.shape)}")
    if blob_bytes.device.type == "cpu":
        return ingest_check_plain(blob_bytes)
    if not blob_bytes.is_contiguous():
        raise ValueError("kzg_fr_ingest: the blob bytes must be contiguous")
    blobs, elems = (1, blob_bytes.shape[0]) if blob_bytes.dim() == 2 else tuple(blob_bytes.shape[:2])
    if blobs * elems >= 1 << 30:
        raise ValueError(f"kzg_fr_ingest: {blobs * elems} elements exceed the kernel's 32-bit index (two threads an element)")
    dev = blob_bytes.device
    if flag is None:
        flag = torch.empty((), dtype=torch.uint8, device=dev)
    elif flag.dtype != torch.uint8 or flag.dim() != 0 or flag.device != dev:
        raise ValueError(f"kzg_fr_ingest: the flag is a zero-dim uint8 tensor on {dev}")
    out = torch.empty(blob_bytes.shape[:-1][::-1] + (FR.nwords,), dtype=torch.int32, device=dev)
    flag.fill_(1)
    if out.numel():
        _check_aligned("kzg_fr_ingest", blob_bytes, out)
        _build.launch("kzg_fr_ingest", dev, blob_bytes, out, flag, blobs, elems)
    return out, flag.view(torch.bool)


SUM_BLOCKS = (256, 64, 32)  # the domain sum's block sizes, widest first
SUM_MAX_PAIRS = 16  # 16-byte halves of a row a block takes at most
_SM_COUNTS: dict = {}


def sum_tiles(inner: int) -> int:
    """The domain sum's tiles (blocks a row block) for ``inner`` columns."""
    return -(-2 * inner // min(SUM_MAX_PAIRS, 1 << (2 * inner - 1).bit_length()))


def sum_config(k: int, inner: int, sms: int) -> tuple[int, int, int]:
    """The domain sum's launch for [k, inner] elements on ``sms`` SMs:
    (threads a block, 16-byte halves a block, row blocks).  A block takes
    up to 16 neighbouring halves of a row (a tile; an element is two) over
    its remaining threads as row lanes; a row block is one block a tile.
    The widest block (256, 64 or 32 threads) that still gives every SM a
    block with a row for each lane; then two blocks an SM with 256-thread
    blocks, one with narrower ones, and at least two row blocks (on the
    H100: [4096, 64] in 8 x 33 blocks of 256, [4096, 1] in 132 of 32,
    [4096, 4096] in 512 x 2 of 256, each the fastest of the sweep)."""
    pairs = min(SUM_MAX_PAIRS, 1 << (2 * inner - 1).bit_length())
    tiles = sum_tiles(inner)
    for threads in SUM_BLOCKS:
        most = -(-k // (threads // pairs))  # row blocks with a row for every lane
        if tiles * most >= sms or threads == SUM_BLOCKS[-1]:
            per_sm = 2 if threads == SUM_BLOCKS[0] else 1
            return threads, pairs, min(most, max(2, -(-per_sm * sms // tiles)))
    raise AssertionError("unreachable")


def _sm_count(device) -> int:
    n = _SM_COUNTS.get(device.index)
    if n is None:
        n = _SM_COUNTS[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return n


def sum_tickets(inner: int, device) -> torch.Tensor:
    """Zeroed tickets for domain sums of ``inner`` columns on ``device``,
    one word a tile; the last block of a tile sets its word back to zero,
    so the tickets stay zero between launches and across CUDA-graph
    replays.  Whoever keeps them for repeated sums owns them (a captured
    graph holds their address), and the launches that share them must
    not overlap: one stream, in order."""
    return torch.zeros(sum_tiles(inner), dtype=torch.int32, device=device)


def sum_mod(spec: FieldSpec, x: torch.Tensor, tickets: torch.Tensor | None = None) -> torch.Tensor:
    """Modular sum along axis 0 of ``[k, ..., nwords]`` (every element <
    N, Montgomery or canonical in, the same form out).  A plain modular
    sum, where the JAX package used one raw column accumulation plus one
    REDC (``limbs.sum_mont_redc``): callers that want that function's
    canonical output apply :func:`from_mont`.  On the card one launch of
    ``kzg_fr_sum_rows`` for any k (raw 64-bit column sums, the row blocks'
    sums added by each tile's last block, one reduction a column), with
    the caller's ``tickets`` (:func:`sum_tickets`) or, by default, tickets
    of its own."""
    _check(spec, x)
    if x.device.type == "cpu":
        return sum_mod_plain(spec, x)
    if spec is not FR:
        raise ValueError("sum_mod: the card's kernel is built for Fr only")
    if x.device.type != "cuda":
        raise RuntimeError(f"kzg_fr_sum_rows: kernels launch only on CUDA tensors, got {x.device}")
    k, inner = x.shape[0], math.prod(x.shape[1:-1])
    if not 1 <= k < 1 << 32:
        raise ValueError(f"sum_mod: {k} rows; the kernel sums 1 to 2^32 - 1")
    x = x.contiguous()
    out = torch.empty(x.shape[1:], dtype=torch.int32, device=x.device)
    if inner:
        if tickets is None:
            tickets = sum_tickets(inner, x.device)
        elif tickets.dtype != torch.int32 or tickets.device != x.device or tickets.numel() < sum_tiles(inner) or not tickets.is_contiguous():
            raise ValueError(f"sum_mod: {inner} columns need {sum_tiles(inner)} contiguous int32 tickets on {x.device}")
        threads, pairs, row_blocks = sum_config(k, inner, _sm_count(x.device))
        partials = torch.empty(row_blocks * 2 * inner * 4, dtype=torch.int64, device=x.device)
        _check_aligned("kzg_fr_sum_rows", x, out, partials)
        _build.launch("kzg_fr_sum_rows", x.device, x, partials, tickets, out, k, inner, threads, pairs, row_blocks)
    return out


def mont_sqr(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return mont_mul(spec, a, a)


def to_mont(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return mont_mul(spec, a, spec.const("r2", a.device))


def from_mont(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return mont_mul(spec, a, spec.const("one", a.device))


def pow_digits(exponent: int) -> bytes:
    """The 4-bit digits of ``exponent`` (1 <= e < 2^384), most significant
    first, the first nonzero: the chain kernels' exponent."""
    if not 1 <= exponent < 1 << (4 * MAX_POW_DIGITS):
        raise ValueError(f"pow_const: exponent {exponent} outside [1, 2^{4 * MAX_POW_DIGITS})")
    return bytes(int(c, 16) for c in f"{exponent:x}")


def mont_pow_const(spec: FieldSpec, a: torch.Tensor, exponent: int) -> torch.Tensor:
    """a^e (Montgomery in and out) for a constant exponent.  On the card one
    launch of the chain kernel for any e >= 1: per element the table
    a^1..a^d for the largest digit d of e, then per further 4-bit digit four
    squarings and a product for a nonzero digit, all in registers and
    shared memory.  e = 0 is mont(1), with no launch."""
    _check(spec, a)
    if exponent == 0:
        return spec.const("one_mont", a.device).expand_as(a).contiguous()
    if a.device.type == "cpu":
        return mont_pow_const_plain(spec, a, exponent)
    name = spec.kernels["pow_const"]
    digits = pow_digits(exponent)
    a = a.contiguous()
    out = torch.empty_like(a)
    n = a.numel() // spec.nwords
    if n >= 1 << 31:
        raise ValueError(f"{name}: {n} elements exceed the kernel's 32-bit index")
    if n:
        _check_aligned(name, a, out)
        _build.launch(name, a.device, a, out, n, digits, len(digits))
    return out


def mont_pow_const_plain(
    spec: FieldSpec, a: torch.Tensor, exponent: int, mul=mont_mul_plain, top: int = 15
) -> torch.Tensor:
    """Plain version of the chain kernels, one ``mul`` per product: 4-bit
    fixed windows (the digits of :func:`pow_digits`) over a table
    a^1..a^top (top - 1 products, top at least the largest digit), then per
    further digit four squarings and one product (skipped for a zero digit).
    ``top=max(pow_digits(e))`` is the kernels' own schedule.  With the
    default table and ``mul=mont_mul`` on the card it is the chain as a
    launch sequence of K1 or K2, one launch per product."""
    if exponent == 0:
        return spec.const("one_mont", a.device).expand_as(a).contiguous()
    digits = pow_digits(exponent)
    table = [None, a]
    for _ in range(top - 1):
        table.append(mul(spec, table[-1], a))
    acc = table[digits[0]]
    for d in digits[1:]:
        for _ in range(4):
            acc = mul(spec, acc, acc)
        if d:
            acc = mul(spec, acc, table[d])
    return acc


class PowChain(NamedTuple):
    """A constant-exponent chain as stage 1's square-root kernel takes it
    (``csrc/stage1_kernels.cu`` SqrtChain): a table of the ``entries`` odd
    powers a^(2k - 1), k = 1 .. entries (after a^2), then ``steps``:
    (squarings, entry) pairs, the first taking its entry alone, the others
    squaring and then multiplying by their entry (none for 0)."""

    entries: int
    steps: tuple

    @property
    def products(self) -> int:
        """Products and squarings the chain takes."""
        table = self.entries - 1 + (self.entries > 1)
        return table + sum(sq + (idx != 0) for sq, idx in self.steps[1:])

    def exponent(self) -> int:
        e = 0
        for sq, idx in self.steps:
            e = (e << sq) + (2 * idx - 1 if idx else 0)
        return e

    def to_bytes(self) -> bytes:
        return bytes([self.entries] + [v for step in self.steps for v in step])


def pow_chain(exponent: int, window: int = 5) -> PowChain:
    """Left-to-right sliding windows of up to ``window`` bits over the odd
    powers a, a^3, .. (e >= 1): each window, from a one bit to the last one
    bit within ``window`` bits, is one product by its odd value's entry
    after as many squarings as it has bits (and the zeros before it)."""
    if exponent < 1 or window < 1:
        raise ValueError("pow_chain: exponent and window at least 1")
    bits = f"{exponent:b}"
    runs, zeros, i = [], 0, 0
    while i < len(bits):
        if bits[i] == "0":
            zeros, i = zeros + 1, i + 1
            continue
        j = min(i + window, len(bits))
        while bits[j - 1] == "0":
            j -= 1
        value = int(bits[i:j], 2)
        runs.append((zeros + j - i if runs else 0, (value + 1) // 2))
        zeros, i = 0, j
    if zeros:
        runs.append((zeros, 0))
    steps = []
    for sq, idx in runs:  # every squaring count below 256
        while sq > 255:
            steps.append((255, 0))
            sq -= 255
        steps.append((sq, idx))
    return PowChain(max(idx for _, idx in runs), tuple(steps))


def mont_pow_chain_plain(spec: FieldSpec, a: torch.Tensor, chain: PowChain, mul=mont_mul_plain) -> torch.Tensor:
    """a^e by ``chain`` (Montgomery in and out), one ``mul`` per product or
    squaring, in the kernel's order."""
    base = mul(spec, a, a) if chain.entries > 1 else a
    table = [None, a]
    for _ in range(chain.entries - 1):
        table.append(mul(spec, table[-1], base))
    acc = table[chain.steps[0][1]]
    for sq, idx in chain.steps[1:]:
        for _ in range(sq):
            acc = mul(spec, acc, acc)
        if idx:
            acc = mul(spec, acc, table[idx])
    return acc


def mont_inv(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """a^-1 via Fermat (a^(N-2)); Montgomery in and out.  inv(0) == 0."""
    return mont_pow_const(spec, a, spec.modulus - 2)


def batch_mont_inv(spec: FieldSpec, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Inverses along ``axis`` by a product tree and one Fermat inversion
    (the JAX package's ``limbs.batch_mont_inv``).  The tree pairs the two
    halves of the axis, not even and odd entries, so on axis 0 every operand
    is a contiguous slice.  A zero anywhere zeroes the root and every
    output; callers keep zeros out."""
    xf = x.movedim(axis, 0).contiguous() if axis % x.dim() else x
    length = xf.shape[0]
    m = 1 << max(length - 1, 0).bit_length()
    if m != length:  # pad with mont(1): product-neutral
        pad = spec.const("one_mont", xf.device).expand((m - length,) + xf.shape[1:])
        xf = torch.cat([xf, pad])
    levels = []
    v = xf
    while v.shape[0] > 1:
        levels.append(v)
        h = v.shape[0] // 2
        v = mont_mul(spec, v[:h], v[h:])
    inv = mont_inv(spec, v)
    for lv in reversed(levels):
        h = lv.shape[0] // 2
        inv = torch.cat([mont_mul(spec, lv[h:], inv), mont_mul(spec, lv[:h], inv)])
    inv = inv[:length]
    return inv.movedim(0, axis) if axis % x.dim() else inv
