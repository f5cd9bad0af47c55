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
from kzg_rust_tpu_torch.golden.field import P, R
from kzg_rust_tpu_torch.ops import _build
from kzg_rust_tpu_torch.ops import jax_state as JS
from kzg_rust_tpu_torch.ops import limbs as L

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
