"""The least time the card could take for the port's work: operations and
bytes a kernel or a stage needs, and the peaks they are held to.

A bound is the larger of the bytes over the HBM rate and the 32-bit
multiply-adds over the integer pipe's rate (``bound_s``).  The counts are
those the port's kernel table is held to (``chip_smoke.py``
``check_kernels``, PERF.md section 6), copied here so that the yardstick
does not move with the program: one function a kernel, and one a stage of
a call, which sums the kernels' work that the stage's real lanes need
(padding lanes are not counted, so padding lowers a share, as waste
should).  A stage is counted whole, not by kernel names, so a later
change that fuses or renames kernels leaves the count right; a change to
the algorithm's own count is a change to this file, which only a
benchmark change may make.

Where the work depends on the data (a digit of zero selects nothing), the
count is the expectation over the traffic's scalars, measured once with
the port's plain recoding over 20,000 scalars and frozen below.
"""

from __future__ import annotations

from dataclasses import dataclass

# Published NVIDIA H100 SXM peaks (data sheet) and the integer pipe rate
# (CUDA C++ Programming Guide, arithmetic throughput, compute capability
# 9.0: 64 32-bit integer multiply-adds a clock an SM).  The SM clock and
# count are read on the card; these are the data sheet's, for a card that
# reports none.
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_CLOCK_PER_SM = 64
H100_SMS = 132
H100_MAX_SM_CLOCK_HZ = 1.98e9

FP_WORDS, FR_WORDS = 12, 8
POINT_BYTES = 3 * FP_WORDS * 4  # a projective point, Montgomery words
# Fp products a complete add, a doubling and a mixed add take (the curve
# kernels' RCB formulas, products by b3 = 12 done as adds).
ADD_PRODUCTS, DOUBLE_PRODUCTS, MIXED_PRODUCTS = 12, 8, 11
# Kernel B: 16 complete adds over the 17 window rows of z^2, beta X1 and
# four cross products.
SUBGROUP_PRODUCTS = 16 * ADD_PRODUCTS + 5
# The square root's chain ((p + 1) / 4, 5-bit sliding windows): 375
# squarings and 82 products; decompression adds to_mont, x^2, x^3, y^2 and
# from_mont (2 squarings, 3 products).
SQRT_SQUARINGS, SQRT_PRODUCTS = 375, 82
# Stage 1's window bases: 66 base-4 windows over 128-bit GLV halves, the
# doubling chain 2 x 66 - 1 steps.
STAGE1_WINDOWS = 66
CHAIN_STEPS = 2 * STAGE1_WINDOWS - 1
# Fr chains with 4-bit fixed windows: the Fermat inversion (r - 2: 252
# squarings, 73 products with the table) and x^4096 (12 squarings).
FR_INV_SQUARINGS, FR_INV_PRODUCTS = 252, 73
X_N_SQUARINGS = 12
# Stage 2: six lanes a blob (proof k1, k2; commitment k1, k2; proof z k1,
# k2), each a signed base-4 digit a window; a nonzero digit is one add,
# the k2 lanes' selections one beta product more.  Share of nonzero
# digits over SHA-256-derived scalars' GLV halves: 0.7223.
STAGE2_LANES = 6
STAGE2_NONZERO = 0.7223
# The generator multiple [sum r^i y_i] G: 64 windows of 4 bits, a
# selection and an add each, then one add onto the rest.
GEN_WINDOWS = 64
# The prover's MSM: 2 GLV halves x 26 signed 5-bit windows a scalar, each
# nonzero digit one mixed add (the phi half one product more) reading 96
# bytes of table.  Share of nonzero digits: 0.9429 over blob elements whose
# top byte is zero (a commitment's scalars), 0.9643 over uniform scalars
# (a proof's quotient).
MSM_WINDOWS = 26
MSM_NONZERO_BLOB = 0.9429
MSM_NONZERO_UNIFORM = 0.9643


@dataclass(frozen=True)
class Work:
    """Bytes moved and 32-bit multiply-adds."""

    bytes: float
    ops: float

    def __add__(self, other: "Work") -> "Work":
        return Work(self.bytes + other.bytes, self.ops + other.ops)

    def __mul__(self, k: float) -> "Work":
        return Work(self.bytes * k, self.ops * k)



def bound_s(work: Work, sm_clock_hz: float = H100_MAX_SM_CLOCK_HZ, sms: int = H100_SMS) -> float:
    """The least seconds for ``work``: bytes at the HBM rate or operations
    at the integer pipe's, whichever takes longer."""
    return max(work.bytes / HBM_BYTES_PER_S, work.ops / (sms * IMAD_PER_CLOCK_PER_SM * sm_clock_hz))


def bound_by(work: Work, sm_clock_hz: float = H100_MAX_SM_CLOCK_HZ, sms: int = H100_SMS) -> str:
    return "bytes" if work.bytes / HBM_BYTES_PER_S >= work.ops / (sms * IMAD_PER_CLOCK_PER_SM * sm_clock_hz) else "operations"


def mont_products(nw: int) -> int:
    """Multiply-adds of one CIOS Montgomery product: 2 a word product."""
    return 2 * (2 * nw * nw + nw)


def mont_squarings(nw: int) -> int:
    """Of one SOS squaring: cross products and squares, then the reduction."""
    return 2 * (nw * (nw + 1) // 2 + nw * nw + nw)


# -- kernels (the rows of the port's kernel table) ---------------------------


def fp_mont_mul(n: int) -> Work:
    return Work(3 * n * FP_WORDS * 4, n * mont_products(FP_WORDS))


def fp_mont_mul_by_const(n: int) -> Work:
    """K1 as stage 2 launches it: n elements times one constant."""
    return Work(2 * n * FP_WORDS * 4 + FP_WORDS * 4, n * mont_products(FP_WORDS))


def fr_mont_mul(n: int) -> Work:
    return Work(3 * n * FR_WORDS * 4, n * mont_products(FR_WORDS))


def pow_chain(nw: int, n: int, squarings: int, products: int) -> Work:
    return Work(2 * n * nw * 4, n * (squarings * mont_squarings(nw) + products * mont_products(nw)))


def fr_inverse(n: int) -> Work:
    return pow_chain(FR_WORDS, n, FR_INV_SQUARINGS, FR_INV_PRODUCTS)


def proj_add(n: int) -> Work:
    return Work(3 * n * POINT_BYTES, n * ADD_PRODUCTS * mont_products(FP_WORDS))


def double_chain(n: int, steps: int = CHAIN_STEPS) -> Work:
    return Work((steps + 1) * n * POINT_BYTES, steps * n * DOUBLE_PRODUCTS * mont_products(FP_WORDS))


def decompress(n: int) -> Work:
    ops = (SQRT_SQUARINGS + 2) * mont_squarings(FP_WORDS) + (SQRT_PRODUCTS + 3) * mont_products(FP_WORDS)
    return Work(n * (48 + POINT_BYTES + 1), n * ops)


def subgroup_check(n: int) -> Work:
    return Work(n * (18 * POINT_BYTES + 1), n * SUBGROUP_PRODUCTS * mont_products(FP_WORDS))


def fr_ingest(elements: int) -> Work:
    """32 big-endian bytes in, 8 words out, an element."""
    return Work(elements * (32 + FR_WORDS * 4), 0)


def fr_sum_rows(k: int, inner: int) -> Work:
    return Work(k * inner * FR_WORDS * 4 + inner * FR_WORDS * 4, k * inner * FR_WORDS)


def glv_digits(n: int) -> Work:
    return Work(n * (FR_WORDS * 4 + 2 * MSM_WINDOWS), n * 2 * (8 * 5 + 4 * 4))


def msm_glv(selections: float, selections_phi: float, points: int) -> Work:
    """M2: each selection a mixed add and 96 bytes of table, the phi half's
    one product more; the digits, the infinity mask and the point."""
    ops = (selections * MIXED_PRODUCTS + selections_phi) * mont_products(FP_WORDS)
    return Work(selections * 96 + 2 * MSM_WINDOWS * points + points + POINT_BYTES, ops)


# -- stages of a call --------------------------------------------------------


def verify_stage1(blobs: int) -> Work:
    """Decompression, the window-base chain and the subgroup check of each
    real lane's commitment and proof."""
    points = 2 * blobs
    return decompress(points) + double_chain(points) + subgroup_check(points)


def barycentric(blobs: int, fe: int) -> Work:
    """y = (x^n - 1)/n sum e_i w_i/(x - w_i) over ingested blobs: the
    differences, the batch inversion (3 products an element and one Fermat
    inversion a blob), the two term products, the domain sum, and x^n with
    three products a blob."""
    elements = blobs * fe
    diffs = Work(elements * FR_WORDS * 4, elements * 3 * FR_WORDS)
    return (
        diffs
        + fr_mont_mul(3 * elements)
        + fr_inverse(blobs)
        + fr_mont_mul(2 * elements)
        + fr_sum_rows(fe, blobs)
        + pow_chain(FR_WORDS, blobs, X_N_SQUARINGS, 0)
        + fr_mont_mul(4 * blobs)
    )


def verify_bary(blobs: int, fe: int) -> Work:
    """Each blob ingested and checked, then evaluated at its challenge."""
    return fr_ingest(blobs * fe) + barycentric(blobs, fe)


def verify_stage2(blobs: int) -> Work:
    """The random linear combination over the window bases: each lane's
    nonzero digits an add (the k2 lanes' a beta product), the generator's
    multiple, and the final add."""
    selections = STAGE2_NONZERO * STAGE1_WINDOWS * STAGE2_LANES * blobs
    return proj_add(int(selections)) + fp_mont_mul_by_const(int(selections / 2)) + proj_add(GEN_WINDOWS + 1)


def verify_call(blobs: int, fe: int, stage2: bool = True) -> Work:
    """A batch verification's device work; ``stage2`` false for a call that
    is refused at the flags' fetch, before stage 2."""
    work = verify_stage1(blobs) + verify_bary(blobs, fe)
    return work + verify_stage2(blobs) if stage2 else work


def _msm(fe: int, nonzero: float) -> Work:
    selections = nonzero * 2 * MSM_WINDOWS * fe
    return glv_digits(fe) + msm_glv(selections, selections / 2, fe)


def prove_commit(fe: int) -> Work:
    """blob_to_kzg_commitment: ingest, M1 and M2 over the blob's elements."""
    return fr_ingest(fe) + _msm(fe, MSM_NONZERO_BLOB)


def prove_proof(fe: int) -> Work:
    """compute_kzg_proof out of the domain: ingest, y (the single-blob
    barycentric evaluation, whose inverses the quotient reuses), the
    quotient (a difference and a product an element), M1 and M2."""
    quotient = Work(fe * FR_WORDS * 4, fe * 3 * FR_WORDS) + fr_mont_mul(fe)
    return fr_ingest(fe) + barycentric(1, fe) + quotient + _msm(fe, MSM_NONZERO_UNIFORM)
