"""Evaluation-domain utilities: bit-reversal permutation and roots of unity.

Mirrors reference: src/kzg.rs:700-799. Pure index/field math on host; the
results are loaded once into device tensors by the JAX backend.
"""

from __future__ import annotations

from ..errors import BadArgs
from ..golden.field import R, fr_scale2_root_of_unity


def reverse_bits(n: int, order: int) -> int:
    """Reverse the low log2(order) bits of n (reference: kzg.rs:700-710)."""
    bits = order.bit_length() - 1
    result = 0
    for _ in range(bits):
        result = (result << 1) | (n & 1)
        n >>= 1
    return result


def bit_reversal_permutation(values: list, n: int) -> list:
    """Reorder by bit-reversed index (reference: kzg.rs:717-731).

    Rejects empty input, n >= 2^32, non-power-of-two n, and n < 2.
    """
    if (
        len(values) == 0
        or n >> 32 != 0
        or n & (n - 1) != 0
        or n == 0
        or n.bit_length() - 1 == 0
        or len(values) != n
    ):
        raise BadArgs("bit_reversal_permutation: invalid args")
    return [values[reverse_bits(i, n)] for i in range(n)]


def expand_root_of_unity(root: int, width: int) -> list[int]:
    """Powers of root until 1 recurs; must have exactly width+1 entries
    (reference: kzg.rs:734-761)."""
    res = [1, root]
    i = 2
    while res[i - 1] != 1:
        if i > width:
            raise BadArgs("expand_root_of_unity: i > width")
        res.append((res[i - 1] * root) % R)
        i += 1
    if res[-1] != 1 or len(res) != width + 1:
        raise BadArgs("expand_root_of_unity: assertion failed")
    return res


def compute_roots_of_unity(max_scale: int) -> list[int]:
    """Bit-reversed 2^max_scale-th roots of unity (reference: kzg.rs:764-799)."""
    max_width = 1 << max_scale
    root = fr_scale2_root_of_unity(max_scale)
    expanded = expand_root_of_unity(root, max_width)
    expanded.pop()  # drop the trailing 1
    return bit_reversal_permutation(expanded, max_width)
