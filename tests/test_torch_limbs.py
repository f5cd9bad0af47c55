"""The port's field layer (kzg_rust_tpu_torch.ops.limbs, K1/K2's plain
versions on the CPU) against the JAX package's limbs and Pallas kernels.

Inputs come from a seeded numpy generator and go through both packages;
every comparison is exact (field arithmetic).  Fp values compare as raw
Montgomery words (both packages use R = 2^384); Fr values compare as
canonical integers or through ``jax_state``'s re-radix (2^264 -> 2^256).
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kzg_rust_tpu.ops import fields as jfields
from kzg_rust_tpu.ops import limbs as JL
from kzg_rust_tpu.ops import pallas_kernels as PK
from kzg_rust_tpu.ops import verify_kernels as JV
from kzg_rust_tpu_torch.golden.field import P, R
from kzg_rust_tpu_torch.ops import _build
from kzg_rust_tpu_torch.ops import jax_state as JS
from kzg_rust_tpu_torch.ops import limbs as L
from kzg_rust_tpu_torch.ops import prover_kernels as PRK

from .conftest import REPO_ROOT

TILE = 8  # the Pallas kernels' interpret-mode tile, as tests/test_ops_pallas.py
SPECS = [(L.FP, jfields.FP), (L.FR, jfields.FR)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small tensor ops; one intra-op thread per
    test worker keeps parallel workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _values(seed: int, modulus: int, n: int) -> list[int]:
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, size=(n, 56), dtype=np.uint8).tobytes()
    vals = [int.from_bytes(raw[i * 56 : (i + 1) * 56], "little") % modulus for i in range(n)]
    return vals


def _operands(modulus: int, n: int = 16):
    a, b = _values(1, modulus, n), _values(2, modulus, n)
    a[:3] = [0, modulus - 1, 1]  # edge rows: 0*0, (N-1)^2, 1*x
    b[:2] = [0, modulus - 1]
    return a, b


def test_header_constants_match_the_golden_field():
    """csrc/field.cuh's moduli and Montgomery constants are the golden
    field's (the CUDA source cannot be compiled here): the immediate tables
    that every kernel takes the modulus from, and -N^-1 mod 2^32."""
    text = (REPO_ROOT / "kzg_rust_tpu_torch" / "csrc" / "field.cuh").read_text()

    def value(body):
        return sum(int(w.rstrip("u"), 16) << (32 * i) for i, w in enumerate(re.findall(r"0x[0-9a-f]+u", body)))

    def immediates(name):
        pattern = r"uint32_t " + name + r"\(int j\) \{\s*constexpr uint32_t w\[(\d+)\] = \{([^}]*)\}"
        count, body = re.search(pattern, text).groups()
        assert len(re.findall(r"0x[0-9a-f]+u", body)) == int(count)
        return value(body)

    def inv(name):
        return int(re.search(r"struct " + name + r" \{.*?INV = (0x[0-9a-f]+)u", text, re.S).group(1), 16)

    assert immediates("fp_mod_word") == P and immediates("fr_mod_word") == R
    for name, table in (("Fp", "fp_mod_word"), ("Fr", "fr_mod_word")):  # each field takes its own table
        assert re.search(r"struct " + name + r" \{[^}]*mod\(int i\) \{ return " + table + r"\(i\); \}", text)
    for name, mod in (("Fp", P), ("Fr", R)):
        assert inv(name) * mod % (1 << 32) == (1 << 32) - 1  # -mod^-1 mod 2^32


@pytest.mark.parametrize("specs", SPECS, ids=["fp", "fr"])
def test_mont_mul_matches_xla_and_pallas(specs):
    """K1/K2's plain version against limbs.mont_mul and the Pallas kernel
    (interpret mode), in Montgomery form on both sides: the JAX products are
    carried into the port's radix by jax_state."""
    spec, jspec = specs
    a, b = _operands(spec.modulus)
    jr = 1 << (12 * jspec.nlimbs)
    ja = jnp.asarray(JL.ints_to_limbs(jspec.nlimbs, [x * jr % spec.modulus for x in a]))
    jb = jnp.asarray(JL.ints_to_limbs(jspec.nlimbs, [x * jr % spec.modulus for x in b]))
    want_xla = np.asarray(JL.mont_mul(jspec, ja, jb))
    want_pallas = np.asarray(PK._make_mont_mul(jspec, TILE)(ja, jb))
    assert (want_xla == want_pallas).all()

    pa = L.to_device(spec, [x * spec.mont_r % spec.modulus for x in a], "cpu")
    pb = L.to_device(spec, [x * spec.mont_r % spec.modulus for x in b], "cpu")
    got = L.mont_mul(spec, pa, pb)
    carry = JS.fp_from_jax if spec is L.FP else (lambda x: JS.fr_from_jax(x, mont=True))
    assert torch.equal(got, carry(want_xla))
    # And as canonical integers: (a b) R^-1 with the port's R.
    rinv = pow(spec.mont_r, -1, spec.modulus)
    canon = L.words_to_ints(L.mont_mul(spec, L.to_device(spec, a, "cpu"), L.to_device(spec, b, "cpu")))
    assert canon == [x * y * rinv % spec.modulus for x, y in zip(a, b)]


@pytest.mark.parametrize("specs", SPECS, ids=["fp", "fr"])
def test_add_sub_neg_compare_match_xla(specs):
    spec, jspec = specs
    a, b = _operands(spec.modulus)
    ja = jnp.asarray(JL.ints_to_limbs(jspec.nlimbs, a))
    jb = jnp.asarray(JL.ints_to_limbs(jspec.nlimbs, b))
    pa, pb = L.to_device(spec, a, "cpu"), L.to_device(spec, b, "cpu")
    for port_fn, jax_fn in (
        (L.add_mod(spec, pa, pb), JL.add_mod(jspec, ja, jb)),
        (L.sub_mod(spec, pa, pb), JL.sub_mod(jspec, ja, jb)),
        (L.neg_mod(spec, pa), JL.neg_mod(jspec, ja)),
    ):
        assert L.words_to_ints(port_fn) == JL.limbs_to_ints(np.asarray(jax_fn))
    over = [spec.modulus, spec.modulus - 1, spec.modulus + 7, 0, (1 << (32 * spec.nwords)) - 1]
    jover = jnp.asarray(JL.ints_to_limbs(jspec.nlimbs, [v % (1 << (12 * jspec.nlimbs)) for v in over]))
    got = L.geq_mod(spec, L.to_device(spec, over, "cpu")).tolist()
    assert got == [True, False, True, False, True]
    assert got[:4] == np.asarray(JL.geq_mod(jspec, jover)).tolist()[:4]
    half = spec.modulus // 2
    assert L.geq_const(spec, pa, half).tolist() == [x >= half for x in a]
    assert L.eq(pa, pa).all() and L.eq(pa, pb).tolist() == [x == y for x, y in zip(a, b)]
    assert L.is_zero(pa).tolist() == [x == 0 for x in a]


@pytest.mark.parametrize("spec", [L.FP, L.FR], ids=["fp", "fr"])
def test_pow_inv_and_sum(spec):
    """mont_pow_const, batch_mont_inv (both axes) and sum_mod against Python
    ints."""
    a = _values(3, spec.modulus - 1, 12)
    a = [x + 1 for x in a]  # nonzero: the batch inversion's contract
    am = L.to_mont(spec, L.to_device(spec, a, "cpu"))
    for e in (0, 1, 5, 15, 16, 4096, (spec.modulus + 1) // 4):
        got = L.words_to_ints(L.from_mont(spec, L.mont_pow_const(spec, am, e)))
        assert got == [pow(x, e, spec.modulus) for x in a], e
    inv0 = L.batch_mont_inv(spec, am.reshape(6, 2, -1), axis=0).reshape(12, -1)
    inv1 = L.batch_mont_inv(spec, am.reshape(4, 3, -1), axis=1).reshape(12, -1)
    want = [pow(x, -1, spec.modulus) for x in a]
    assert L.words_to_ints(L.from_mont(spec, inv0)) == want
    assert L.words_to_ints(L.from_mont(spec, inv1)) == want
    assert L.words_to_ints(L.sum_mod(spec, am.reshape(3, 4, -1)))[1] == sum(
        x * spec.mont_r for x in a[1::4]
    ) % spec.modulus


POW_CASES = [("fp", (P + 1) // 4), ("fr", R - 2), ("fr", 4096)]


@pytest.mark.parametrize("field,exponent", POW_CASES, ids=["fp-sqrt", "fr-inverse", "fr-x4096"])
def test_mont_pow_const_matches_jax(field, exponent):
    """The three constant-exponent chains of the verify path (the square
    root, the Fermat inversion, x^4096) on the CPU against the JAX package's
    mont_pow_const, on 12 seeded rows with 0, 1 and N - 1 among them: raw
    Montgomery words for Fp (both packages use R = 2^384), re-radixed through
    jax_state for Fr (2^264 -> 2^256)."""
    spec, jspec = dict(zip(("fp", "fr"), SPECS))[field]
    a = _values(6, spec.modulus, 12)
    a[:3] = [0, 1, spec.modulus - 1]
    jr = 1 << (12 * jspec.nlimbs)
    ja = jnp.asarray(JL.ints_to_limbs(jspec.nlimbs, [x * jr % spec.modulus for x in a]))
    want = np.asarray(JL.mont_pow_const(jspec, ja, exponent))
    got = L.mont_pow_const(spec, L.to_device(spec, [x * spec.mont_r % spec.modulus for x in a], "cpu"), exponent)
    carry = JS.fp_from_jax if spec is L.FP else (lambda x: JS.fr_from_jax(x, mont=True))
    assert torch.equal(got, carry(want))
    rinv = pow(spec.mont_r, -1, spec.modulus)
    assert [v * rinv % spec.modulus for v in L.words_to_ints(got)] == [pow(x, exponent, spec.modulus) for x in a]


@pytest.mark.parametrize("exponent", [1, 5, 15, 16, 4096, (P + 1) // 4, R - 2], ids=lambda e: f"e{e.bit_length()}b{e % 97}")
def test_pow_chain_schedule(exponent):
    """The chain kernels' host side and schedule: the digits handed to the
    kernel rebuild e exactly, and mont_pow_const_plain on the kernel's
    schedule (the table a^1..a^top for the largest digit, then per further
    digit four squarings and, for a nonzero digit, a product by a table
    entry) makes exactly the kernel's count of products and gives a^e on
    both fields, 0, 1 and N - 1 included."""
    digits = L.pow_digits(exponent)
    assert 1 <= len(digits) <= L.MAX_POW_DIGITS and digits[0] != 0 and max(digits) < 16
    assert sum(d << (4 * k) for k, d in enumerate(reversed(digits))) == exponent
    top = max(digits)
    kernel_products = top - 1 + 4 * (len(digits) - 1) + sum(1 for d in digits[1:] if d)
    for spec in (L.FP, L.FR):
        x = [0, 1, spec.modulus - 1] + _values(7, spec.modulus, 3)
        products = []

        def mul(s, u, v):
            products.append(1)
            return L.mont_mul_plain(s, u, v)

        am = L.to_mont(spec, L.to_device(spec, x, "cpu"))
        got = L.mont_pow_const_plain(spec, am, exponent, mul=mul, top=top)
        assert len(products) == kernel_products
        assert L.words_to_ints(L.from_mont(spec, got)) == [pow(v, exponent, spec.modulus) for v in x]
    for bad in (0, 1 << (4 * L.MAX_POW_DIGITS)):
        with pytest.raises(ValueError):
            L.pow_digits(bad)


def test_sum_mod_matches_sum_mont_redc():
    """The port's plain modular sum + from_mont equals the JAX package's
    one-REDC sum (canonical sum of the values)."""
    vals = _values(4, R, 24)
    jr = 1 << (12 * jfields.FR.nlimbs)
    jx = jnp.asarray(JL.ints_to_limbs(jfields.FR.nlimbs, [v * jr % R for v in vals])).reshape(6, 4, -1)
    want = JL.limbs_to_ints(np.asarray(JL.sum_mont_redc(jfields.FR, jx, axis=0)))
    px = L.to_device(L.FR, [v * L.FR.mont_r % R for v in vals], "cpu").reshape(6, 4, -1)
    assert L.words_to_ints(L.from_mont(L.FR, L.sum_mod(L.FR, px))) == want


def test_codecs():
    vals = _values(5, 1 << 381, 7) + [0, (1 << 384) - 1]
    words = L.ints_to_words(12, vals)
    assert words.dtype == np.int32 and L.words_to_ints(words) == vals
    be = torch.from_numpy(np.frombuffer(b"".join(v.to_bytes(48, "big") for v in vals), np.uint8).reshape(-1, 48).copy())
    assert L.words_to_ints(L.bytes_be_to_words(be)) == vals
    # The JAX package's 12-bit limbs carry over (jax_state).
    assert L.words_to_ints(JS.fp_from_jax(JL.ints_to_limbs(32, vals[:7]))) == vals[:7]


def test_broadcast_index_map():
    """Operand index maps of the field launchers: a full operand, a scalar,
    a row and a column of a 2-D batch, and a broadcast that must be
    materialised."""
    x = torch.zeros(3, 1, 8, dtype=torch.int32)
    assert L._index_map(torch.zeros(3, 4, 8, dtype=torch.int32), (3, 4), 8)[:2] == (1, 12)
    assert L._index_map(torch.zeros(8, dtype=torch.int32), (3, 4), 8)[:2] == (1, 1)
    assert L._index_map(x, (3, 4), 8)[:2] == (4, 3)
    assert L._index_map(torch.zeros(4, 8, dtype=torch.int32), (3, 4), 8)[:2] == (1, 4)
    div, mod, mat = L._index_map(torch.zeros(3, 1, 5, 8, dtype=torch.int32), (3, 4, 5), 8)
    assert (div, mod, tuple(mat.shape)) == (1, 60, (3, 4, 5, 8))


def test_unaligned_operand_raises():
    """The field kernels move elements with 16-byte accesses; an operand
    that does not start on 16 bytes raises instead of taking another route."""
    words = torch.zeros(17, 8, dtype=torch.int32)
    L._check_aligned("kzg_fr_mont_mul", words[1:], words[2:])
    with pytest.raises(ValueError, match="16-byte"):
        L._check_aligned("kzg_fr_mont_mul", words.flatten()[1:])


def test_cuda_launch_needs_a_cuda_tensor():
    """A kernel launch on a CPU device raises: the wrappers never fall back."""
    a = torch.zeros(2, 12, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        _build.launch("kzg_fp_mont_mul", a.device, a, a, a, 2, 1, 2, 1, 2)
    assert all(v == 0 for v in _build.LAUNCHES.values())


# ---------------------------------------------------------------------------
# The domain sum's kernel (kzg_fr_sum_rows): its arithmetic mirrored here
# ---------------------------------------------------------------------------


def _sum_rows_mirror(x: np.ndarray, threads: int, pairs: int, row_blocks: int) -> list[int]:
    """kzg_fr_sum_rows' arithmetic on x [k, inner, 8] uint32 words: each
    row block's 64-bit column sums of the 16-byte halves over its row lanes
    (rows j with (j mod row_blocks R) // R == the row block, R = threads /
    pairs), the row blocks' sums added, then per column the carry into nine
    words S and S mod r by Barrett's quotient floor(floor(S / 2^224) mu /
    2^64), mu = floor(2^288 / r), and at most two subtracts of r."""
    k, inner = x.shape[:2]
    lanes = threads // pairs
    halves = x.reshape(k, 2 * inner, 4).astype(np.uint64)
    block_of_row = (np.arange(k) % (row_blocks * lanes)) // lanes
    partials = np.stack([halves[block_of_row == b].sum(0, dtype=np.uint64) for b in range(row_blocks)])
    cols = partials.sum(0, dtype=np.uint64).reshape(inner, 8)
    mu = (1 << 288) // R
    out = []
    for c in range(inner):
        words, carry = [], 0
        for j in range(8):
            w = int(cols[c, j]) + carry
            assert w < 1 << 64  # no 64-bit sum overflows
            words.append(w & 0xFFFFFFFF)
            carry = w >> 32
        assert carry < 1 << 31  # S < 2^287
        s = sum(w << (32 * j) for j, w in enumerate(words)) + (carry << 256)
        q = ((s >> 224) * mu) >> 64
        d = s - q * R
        assert 0 <= d < 3 * R and q < 1 << 34
        for _ in range(2):
            d = d - R if d >= R else d
        out.append(d)
    return out


def _sum_inputs(k: int, inner: int, fill: str) -> tuple[np.ndarray, list[int]]:
    if fill == "max":  # every element r - 1: the largest lazy sum
        vals = [R - 1] * (k * inner)
    else:
        vals = _values(k * 1000 + inner, R, k * inner)
        vals[0] = R - 1
    words = L.ints_to_words(8, vals).view(np.uint32).reshape(k, inner, 8)
    return words, vals


SUM_CASES = [(k, inner, "random") for k in (1, 2, 63, 64, 65, 4096) for inner in (1, 3, 64)] + [
    (4096, 64, "max"),
    (4096, 1, "max"),
    (65, 3, "max"),
]


@pytest.mark.parametrize("k,inner,fill", SUM_CASES, ids=lambda v: str(v))
def test_sum_rows_mirror(k, inner, fill):
    """The domain sum kernel's arithmetic (lazy 64-bit column sums over the
    launch's row blocks, then one reduction a column), at the launch
    sum_config gives a 132-SM card, against the port's plain sum_mod_plain
    (a halving tree of modular adds) and the JAX package's one-REDC
    sum_mont_redc fed the same values in its Montgomery form (whose output
    is the canonical sum)."""
    words, vals = _sum_inputs(k, inner, fill)
    got = _sum_rows_mirror(words, *L.sum_config(k, inner, 132))
    want = [sum(vals[c::inner]) % R for c in range(inner)]
    assert got == want
    plain = L.sum_mod_plain(L.FR, torch.from_numpy(words.view(np.int32)))
    assert L.words_to_ints(plain) == want
    jr = 1 << (12 * jfields.FR.nlimbs)
    jx = jnp.asarray(JL.ints_to_limbs(jfields.FR.nlimbs, [v * jr % R for v in vals])).reshape(k, inner, -1)
    assert JL.limbs_to_ints(np.asarray(JL.sum_mont_redc(jfields.FR, jx, axis=0))) == want


@pytest.mark.parametrize("sms", [132, 114, 16])
def test_sum_config(sms):
    """The domain sum's launch: at the path's shapes it gives every SM a
    block (the barycentric chunk's [4096, 64] with blocks of 256 threads,
    a proof's [4096, 1] with blocks of 32); no row block lacks rows; the
    mirror agrees with every configuration on the same inputs."""
    for k, inner in ((4096, 64), (4096, 1), (4096, 4096), (1, 1), (65, 3)):
        threads, pairs, row_blocks = L.sum_config(k, inner, sms)
        tiles = -(-2 * inner // pairs)
        assert threads in L.SUM_BLOCKS and pairs in (2, 4, 8, 16) and pairs >= min(16, 2 * inner)
        assert L.sum_tiles(inner) == tiles
        assert (row_blocks - 1) * (threads // pairs) < k  # every row block has a row for its first lane
        if (k, inner) in ((4096, 64), (4096, 1)):
            assert tiles * row_blocks >= sms
    assert L.sum_config(4096, 64, 132) == (256, 16, 33)
    assert L.sum_config(4096, 1, 132) == (32, 2, 132)
    assert L.sum_config(4096, 4096, 132) == (256, 16, 2)
    words, vals = _sum_inputs(65, 3, "random")
    want = [sum(vals[c::3]) % R for c in range(3)]
    for threads, pairs, row_blocks in ((256, 8, 1), (64, 8, 9), (64, 8, 17), (64, 16, 2)):
        assert _sum_rows_mirror(words, threads, pairs, row_blocks) == want


def test_sum_kernel_constants_and_wrapper():
    """The domain sum's Barrett factor in csrc/field_kernels.cu is
    floor(2^288 / r); the entry point takes the wrapper's arguments; on a
    tensor off the CPU the wrapper launches or raises (the meta device has
    no kernels: nothing is counted).  Tickets are zero words, one a tile
    (over 1,024 tiles past 8,192 columns)."""
    text = (REPO_ROOT / "kzg_rust_tpu_torch" / "csrc" / "field_kernels.cu").read_text()
    mu = re.search(r"constexpr unsigned long long kFrBarrettMu = (0x[0-9a-f]+)ull;", text).group(1)
    assert int(mu, 16) == (1 << 288) // R
    assert 'extern "C" int kzg_fr_sum_rows(const void* x, void* partials, void* tickets, void* out,' in text
    assert len(_build.ENTRY_POINTS["kzg_fr_sum_rows"][1]) == 10
    for inner, tiles in ((1, 1), (64, 8), (8192, 1024), (16384, 2048)):
        t = L.sum_tickets(inner, "cpu")
        assert t.dtype == torch.int32 and t.numel() == tiles and not t.any()
    _build.reset_launches()
    meta = torch.empty((4096, 1, 8), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="CUDA"):
        L.sum_mod(L.FR, meta)
    assert all(v == 0 for v in _build.LAUNCHES.values())


# ---------------------------------------------------------------------------
# Kernel A's square root: the product over L lanes and the chain, mirrored
# ---------------------------------------------------------------------------

_M32 = (1 << 32) - 1
_FP_INV = (-pow(P, -1, 1 << 32)) % (1 << 32)


def _lookahead(gen: int, prop: int, lanes: int) -> int:
    """field.cuh lane_mul's carry lookahead: the carry into each lane (bit
    r) from its group's generate and propagate bits."""
    a, b = gen, gen | prop
    return ((a + b) ^ a ^ b) & ((1 << lanes) - 1)


def _lane_mul_mirror(a: int, b: int, lanes: int) -> int:
    """field.cuh lane_mul on Python ints, lane by lane: each lane's W words
    and its pending two-word carry e as one integer below 2^(32 (W + 2)),
    the rows a b_i and q p on each lane's part, the shift (a lane's low word
    down to the lane below, where it meets that lane's e), then the lane
    below's e added and the one-bit carries resolved by the lookahead."""
    w = 12 // lanes
    part = lambda v, r: (v >> (32 * w * r)) & ((1 << (32 * w)) - 1)  # noqa: E731
    a_parts = [part(a, r) for r in range(lanes)]
    m_parts = [part(P, r) for r in range(lanes)]
    t = [0] * lanes
    for i in range(12):
        bi = (b >> (32 * i)) & _M32
        t = [t[r] + a_parts[r] * bi for r in range(lanes)]
        q = (t[0] & _M32) * _FP_INV & _M32
        t = [t[r] + m_parts[r] * q for r in range(lanes)]
        assert all(v < 1 << (32 * (w + 2)) for v in t)  # no carry leaves the lane's window
        assert t[0] & _M32 == 0
        up = [t[r + 1] & _M32 for r in range(lanes - 1)] + [0]
        t = [(t[r] >> 32) + (up[r] << (32 * (w - 1))) for r in range(lanes)]
        assert all(v >> (32 * w) < 8 for v in t)  # the new e
    e = [v >> (32 * w) for v in t]
    assert e[-1] == 0  # the value is below 2^384
    parts = [(t[r] & ((1 << (32 * w)) - 1)) + (e[r - 1] if r else 0) for r in range(lanes)]
    gen = sum(1 << r for r in range(lanes) if parts[r] >> (32 * w))
    parts = [v & ((1 << (32 * w)) - 1) for v in parts]
    prop = sum(1 << r for r in range(lanes) if parts[r] == (1 << (32 * w)) - 1)
    carries = _lookahead(gen, prop, lanes)
    parts = [(parts[r] + (carries >> r & 1)) & ((1 << (32 * w)) - 1) for r in range(lanes)]
    return sum(v << (32 * w * r) for r, v in enumerate(parts))


@pytest.mark.parametrize("lanes", [2, 4])
def test_lane_product_mirror(lanes):
    """Kernel A's product over 2 and 4 lanes a point (field.cuh lane_mul),
    mirrored word for word, against mont_mul_plain (K1's plain version): on
    seeded values, on 0, 1 and p - 1, on operands whose words are all ones
    up to a lane boundary (2^256 - 1, 2^352 - 1), and on 2p - 1, the
    largest value the chain hands it.  It returns a value below 2p, equal to
    the plain version's modulo p."""
    vals = _values(9, P, 12) + [0, 1, P - 1, (1 << 256) - 1, (1 << 352) - 1, 2 * P - 1]
    a, b = vals, vals[3:] + vals[:3]
    want = L.words_to_ints(
        L.mont_mul_plain(L.FP, L.to_device(L.FP, [x % P for x in a], "cpu"), L.to_device(L.FP, [y % P for y in b], "cpu"))
    )
    for x, y, wv in zip(a, b, want):
        got = _lane_mul_mirror(x, y, lanes)
        assert got < 2 * P and got % P == wv, (hex(x), hex(y))
    # Chained as the square root runs it: values stay below 2p, the end is
    # the canonical power after one subtract.
    x = _values(10, P, 1)[0]
    acc = x
    for _ in range(40):
        acc = _lane_mul_mirror(acc, acc, lanes)
        assert acc < 2 * P
    rinv = pow(1 << 384, -1, P)
    assert acc % P == pow(x, 1 << 40, P) * pow(rinv, (1 << 40) - 1, P) % P


def test_lane_carry_lookahead():
    """lane_mul's carry lookahead against a ripple carry, for every
    generate and propagate pattern of 2 and 4 lanes (disjoint, as a lane
    that carries out after adding a small carry cannot be all ones)."""
    for lanes in (2, 4):
        for gen in range(1 << lanes):
            for prop in range(1 << lanes):
                if gen & prop:
                    continue
                carry, want = 0, 0
                for r in range(lanes):
                    want |= carry << r
                    carry = (gen >> r & 1) | ((prop >> r & 1) & carry)
                assert _lookahead(gen, prop, lanes) == want


@pytest.mark.parametrize("window", [1, 3, 4, 5])
def test_pow_chain_windows(window):
    """Sliding-window chains (the square root's schedule, ops/limbs.py
    pow_chain) rebuild their exponent for small, wide and sparse exponents,
    and mont_pow_chain_plain on them gives a^e with the chain's count of
    products."""
    exps = [1, 2, 3, 5, 15, 16, 31, 4096, R - 2, (P + 1) // 4, (1 << 600) + 1]
    for e in exps:
        chain = L.pow_chain(e, window)
        assert chain.exponent() == e and all(0 <= sq < 256 for sq, _ in chain.steps)
        assert 1 <= chain.entries <= 1 << max(window - 1, 0)
    x = [0, 1, P - 1] + _values(11, P, 3)
    am = L.to_mont(L.FP, L.to_device(L.FP, x, "cpu"))
    for e in (5, 4096, R - 2):
        chain = L.pow_chain(e, window)
        products = []

        def mul(s, u, v):
            products.append(1)
            return L.mont_mul_plain(s, u, v)

        got = L.mont_pow_chain_plain(L.FP, am, chain, mul=mul)
        assert len(products) == chain.products
        assert L.words_to_ints(L.from_mont(L.FP, got)) == [pow(v, e, P) for v in x]


def test_sqrt_chain_matches_pow_and_jax():
    """The square root's chain (sliding 5-bit windows over the odd powers,
    verify_kernels.SQRT_CHAIN): 16 entries, 375 squarings and 82 products
    (457 against the 481 of the 4-bit fixed windows it replaced), and it
    gives x^((p+1)/4) on 0, 1, p - 1 and seeded values, the raw Montgomery
    words of the JAX package's mont_pow_const."""
    from kzg_rust_tpu_torch.ops import verify_kernels as V

    e = (P + 1) // 4
    chain = V.SQRT_CHAIN
    assert chain == L.pow_chain(e, 5) and chain.exponent() == e
    assert (chain.entries, chain.products) == (16, 457)
    assert sum(sq for sq, _ in chain.steps) == 375
    x = [0, 1, P - 1] + _values(12, P, 5)
    xm = [v * L.FP.mont_r % P for v in x]
    jm = np.asarray(JL.mont_pow_const(jfields.FP, jnp.asarray(JL.ints_to_limbs(jfields.FP.nlimbs, xm)), e))
    got = L.mont_pow_chain_plain(L.FP, L.to_device(L.FP, xm, "cpu"), chain)
    assert torch.equal(got, JS.fp_from_jax(jm))
    rinv = pow(L.FP.mont_r, -1, P)
    assert [v * rinv % P for v in L.words_to_ints(got)] == [pow(v, e, P) for v in x]


# ---------------------------------------------------------------------------
# The blob ingest (kzg_fr_ingest) and the Fr difference (kzg_fr_sub)
# ---------------------------------------------------------------------------

INGEST_BLOBS, INGEST_ELEMS = 3, 8
# Where a non-canonical element sits, by case: (blob, element, value); the
# canonical case holds 0 and r - 1.
INGEST_CASES = {
    "canonical": None,
    "r": (1, 3, R),
    "r+1": (1, 3, R + 1),
    "2^255": (0, 5, 1 << 255),
    "2^256-1": (2, 0, (1 << 256) - 1),
    "last-blob": (INGEST_BLOBS - 1, 2, R),
    "last-row": (0, INGEST_ELEMS - 1, R),
}


def _blob_bytes(case: str, blobs: int) -> np.ndarray:
    """[blobs, INGEST_ELEMS, 32] big-endian elements from a seeded
    generator, 0 and r - 1 among them, and the case's bad element (in the
    last blob where the case names blob 2 or the last one)."""
    vals = _values(6, R, blobs * INGEST_ELEMS)
    vals[:2] = [0, R - 1]
    bad = INGEST_CASES[case]
    if bad is not None:
        b, i, v = bad
        vals[min(b, blobs - 1) * INGEST_ELEMS + i] = v
    raw = b"".join(v.to_bytes(32, "big") for v in vals)
    return np.frombuffer(raw, np.uint8).reshape(blobs, INGEST_ELEMS, 32).copy()


@pytest.mark.parametrize("case", list(INGEST_CASES))
@pytest.mark.parametrize("layout", ["blobs", "one"])
def test_ingest_check_matches_jax(case, layout):
    """The plain ingest-and-check (the verify path's [B, n, 32] to
    domain-major [n, B, 8], and the prover's ingest of one [n, 32] blob)
    against the JAX package's blob_bytes_to_limbs + geq_mod + any, as
    canonical integers and the flag, on the adversarial elements 0, r - 1,
    r, r + 1, 2^255, 2^256 - 1 and a bad element only in the last blob or
    only in the last row."""
    blobs = _blob_bytes(case, INGEST_BLOBS if layout == "blobs" else 1)
    jl = JV.blob_bytes_to_limbs(jnp.asarray(blobs))
    jok = bool(~jnp.any(JL.geq_mod(jfields.FR, jl)))
    want = JS.limbs12_to_ints(np.asarray(jl))  # blob-major
    if layout == "blobs":
        words, ok = L.ingest_check(torch.from_numpy(blobs))
        assert words.shape == (INGEST_ELEMS, INGEST_BLOBS, 8)
        words = words.transpose(0, 1)
    else:
        words, ok = PRK.ingest(torch.from_numpy(blobs[0]))
        assert words.shape == (INGEST_ELEMS, 8)
    assert ok.dtype == torch.bool and ok.dim() == 0
    assert L.words_to_ints(words.reshape(-1, 8)) == want
    assert bool(ok) == jok == (INGEST_CASES[case] is None)


def _ingest_mirror(blobs: np.ndarray) -> tuple[np.ndarray, bool]:
    """kzg_fr_ingest's threads on numpy: thread t = 2o + h writes half h
    (words 4h .. 4h + 3) of output element o = (i, b) = (o // B, o % B)
    from input half 1 - h of element (b, i), word 4h + j the byte-swapped
    input word 3 - j of that half; each half is compared with r's (from its
    top word down), the pair's high half deciding unless equal; a warp of
    32 threads with an element >= r clears the flag."""
    nb, ne = blobs.shape[:2]
    halves = blobs.reshape(nb * ne, 2, 4, 4)  # [element, half, word, byte]
    t = np.arange(2 * nb * ne)
    o, h = t // 2, t % 2
    i, b = o // nb, o % nb
    src = halves[b * ne + i, 1 - h]  # [threads, 4 words, 4 bytes]
    v = np.ascontiguousarray(src[:, ::-1, ::-1]).reshape(-1, 16).view("<u4")  # [threads, 4]
    r_words = L.ints_to_words(8, [R])[0].view(np.uint32).reshape(2, 4)[h]
    gt, eq = np.zeros(len(t), bool), np.ones(len(t), bool)
    for j in range(3, -1, -1):
        differs = eq & (v[:, j] != r_words[:, j])
        gt |= differs & (v[:, j] > r_words[:, j])
        eq &= ~differs
    hi = slice(1, None, 2)
    lo = slice(0, None, 2)
    bad = gt[hi] | (eq[hi] & (gt[lo] | eq[lo]))  # a pair
    bad = np.repeat(bad, 2)
    warps = np.pad(bad, (0, -len(bad) % 32)).reshape(-1, 32).any(1)
    return v.reshape(nb * ne, 8).view(np.int32).reshape(ne, nb, 8), not warps.any()


@pytest.mark.parametrize("case", ["canonical", "last-blob", "last-row"])
def test_ingest_kernel_mirror(case):
    """The ingest kernel's thread mapping (two threads an element), byte
    swap, compare of the halves and warp vote (mirrored) equal the plain
    version, at the blob counts a chunk, a padded batch and a prover blob
    give it; the kernel source swaps with PRMT 0x0123, the loaded half's
    words in reverse order."""
    text = (REPO_ROOT / "kzg_rust_tpu_torch" / "csrc" / "field_kernels.cu").read_text()
    assert "const uint32_t v[4] = {__byte_perm(w.w, 0, 0x0123), __byte_perm(w.z, 0, 0x0123)," in text
    assert "__byte_perm(w.y, 0, 0x0123), __byte_perm(w.x, 0, 0x0123)};" in text
    for nb in (1, 4, INGEST_BLOBS, 64):
        blobs = _blob_bytes(case, nb)
        words, ok = _ingest_mirror(blobs)
        plain_words, plain_ok = L.ingest_check_plain(torch.from_numpy(blobs))
        assert np.array_equal(words, plain_words.numpy()) and ok == bool(plain_ok)


def _fr_tensor(shape, seed):
    n = int(np.prod(shape, dtype=np.int64))
    return torch.from_numpy(L.ints_to_words(8, _values(seed, R, n))).reshape(tuple(shape) + (8,))


def _sub_mirror(a, b, rows_per_thread: int, max_grid_y: int = 65535) -> torch.Tensor:
    """kzg_fr_sub's launch on the host: the entry point's blocks (TX
    threads, two a column, by 256 / TX row groups; the row groups past
    max_grid_y blocks loop), each thread's column, half and R-row groups,
    the operands read at sub_view's strides from their storage; every half
    of every output element is written exactly once."""
    shape, rows, cols, a_rs, a_cs, b_rs, b_cs = L.sub_view(a, b)
    tx = 32
    while tx < 256 and tx < 2 * cols:
        tx *= 2
    ty = 256 // tx
    groups = -(-rows // rows_per_thread)
    grid_y = min(-(-groups // ty), max_grid_y)
    flat = lambda x: x.as_strided((x.untyped_storage().nbytes() // 4 - x.storage_offset(),), (1,)).reshape(-1, 8)  # noqa: E731
    fa, fb = flat(a), flat(b)
    out = torch.zeros(rows * cols, 2, 4, dtype=torch.int32)
    written = np.zeros((rows * cols, 2), np.int64)
    for t in range(-(-2 * cols // tx) * tx):  # thread x of block t // tx
        c, h = t // 2, t % 2
        if c >= cols:
            continue
        for y in range(grid_y * ty):  # thread (by, ty)
            for g in range(y, groups, grid_y * ty):
                for k in range(rows_per_thread):
                    r = g * rows_per_thread + k
                    if r < rows:
                        d = L.sub_mod_plain(L.FR, fa[r * a_rs + c * a_cs], fb[r * b_rs + c * b_cs])
                        out[r * cols + c, h] = d.reshape(2, 4)[h]
                        written[r * cols + c, h] += 1
    assert (written == 1).all()
    return out.reshape(shape + (8,))


N_SUB = 16  # the domain (4096 on the path)
SUB_SHAPES = {  # every Fr sub_mod of the main path, at small sizes
    "bary x_b - w_i": lambda: (_fr_tensor((5,), 1)[None], _fr_tensor((N_SUB,), 2)[:, None]),
    "bary xn - 1": lambda: (_fr_tensor((5,), 3), L.FR.const("one_mont", "cpu")),
    "proof w - z": lambda: (_fr_tensor((N_SUB,), 4), _fr_tensor((1,), 5)),
    "proof neg": lambda: (L.FR.const("zero", "cpu"), _fr_tensor((N_SUB,), 6)),
    "proof e - y": lambda: (_fr_tensor((N_SUB,), 7), _fr_tensor((), 8)[None]),
    "proof z - w": lambda: (_fr_tensor((1,), 9), _fr_tensor((N_SUB,), 10)),
    "full": lambda: (_fr_tensor((N_SUB,), 11), _fr_tensor((N_SUB,), 12)),
    "rows of a wider tensor": lambda: (_fr_tensor((6, 5), 13)[1:], _fr_tensor((5,), 14)),
    "column slice": lambda: (_fr_tensor((N_SUB, 4), 15)[:, 2], _fr_tensor((N_SUB,), 16)),
    "three dims that merge": lambda: (_fr_tensor((3, 4, 5), 17), _fr_tensor((5,), 18)),
}


@pytest.mark.parametrize("name", list(SUB_SHAPES))
def test_sub_view_matches_broadcast(name):
    """The Fr difference's [rows, cols] view and strides, for every caller's
    shape on the path (and strided operands): the kernel's launch mirrored
    at each rows-a-thread variant (and with the row groups looping past a
    capped grid) equals the broadcast plain difference, word for word."""
    a, b = SUB_SHAPES[name]()
    want = L.sub_mod_plain(L.FR, a, b)
    assert tuple(want.shape[:-1]) == tuple(torch.broadcast_shapes(a.shape[:-1], b.shape[:-1]))
    for rows_per_thread in L.SUB_ROWS:
        assert torch.equal(_sub_mirror(a, b, rows_per_thread), want)
    assert torch.equal(_sub_mirror(a, b, 1, max_grid_y=1), want)


def test_sub_view_raises_where_it_cannot_collapse():
    """A broadcast that leaves three dims, or words that are not whole
    contiguous elements, raises: the wrapper never copies an operand."""
    with pytest.raises(ValueError, match="two dims"):
        L.sub_view(_fr_tensor((3, 1, 5), 1), _fr_tensor((4, 1), 2))
    with pytest.raises(ValueError, match="whole contiguous"):
        L.sub_view(_fr_tensor((4, 16), 3).reshape(4, 16, 8)[:, ::2].transpose(1, 2), _fr_tensor((4, 8), 4)[..., :8])
    assert L.sub_view(_fr_tensor((4096, 1), 5)[:1].expand(4096, 64, 8), _fr_tensor((64,), 6))[1:] == (4096, 64, 0, 0, 0, 1)


def test_ingest_and_sub_launch_or_raise():
    """Off the CPU the two wrappers launch their kernels or raise (the meta
    device has none: nothing is counted, nothing falls back); the entry
    points take the wrappers' arguments; bad flags, rows a thread and
    strided bytes raise before any launch."""
    text = (REPO_ROOT / "kzg_rust_tpu_torch" / "csrc" / "field_kernels.cu").read_text()
    assert 'extern "C" int kzg_fr_ingest(const void* in, void* out, void* ok, long long blobs, long long elems,' in text
    assert 'extern "C" int kzg_fr_sub(const void* a, const void* b, void* out, long long rows, long long cols,' in text
    assert "BINARY_ENTRY(kzg_fr_sub" not in text
    assert len(_build.ENTRY_POINTS["kzg_fr_ingest"][1]) == 6 and len(_build.ENTRY_POINTS["kzg_fr_sub"][1]) == 11
    _build.reset_launches()
    meta_bytes = torch.empty((4, 16, 32), dtype=torch.uint8, device="meta")
    meta_words = torch.empty((16, 8), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="CUDA"):
        L.ingest_check(meta_bytes)
    with pytest.raises(RuntimeError, match="CUDA"):
        L.sub_mod(L.FR, meta_words, meta_words[:1])
    with pytest.raises(ValueError, match="flag"):
        L.ingest_check(meta_bytes, torch.empty(1, dtype=torch.uint8, device="meta"))
    with pytest.raises(ValueError, match="contiguous"):
        L.ingest_check(meta_bytes.transpose(0, 1))
    with pytest.raises(ValueError, match="rows a thread"):
        L.fr_sub(meta_words, meta_words, 3)
    assert all(v == 0 for v in _build.LAUNCHES.values())
