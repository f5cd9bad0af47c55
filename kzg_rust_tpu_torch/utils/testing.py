"""Deterministic insecure trusted setups for tests and the minimal preset,
and the GLV recoding's ripple scalars.

The reference ships only the mainnet ceremony output (trusted_setup.txt);
its README promises a minimal preset as well (reference: README.md:8-9).
Since no minimal ceremony artifact exists, tests (and minimal-preset vector
generation) use a known-secret setup: pick tau, build the Lagrange-basis G1
points over the bit-reversed evaluation domain and the monomial G2 points,
exactly the structure ``load_trusted_setup`` produces from a ceremony file
(reference: kzg.rs:833-899).  INSECURE BY CONSTRUCTION - test use only.
"""

from __future__ import annotations

from ..golden import curve as gc
from ..golden.field import R
from ..ops import glv
from ..presets import Preset
from ..settings import KzgSettings
from ..utils.domain import compute_roots_of_unity


def make_insecure_setup(preset: Preset, tau: int = 0x5EC2E7) -> KzgSettings:
    """A KzgSettings for ``preset`` with secret ``tau`` (G1 in Lagrange
    form over the bit-reversed domain, like the real ceremony output)."""
    n = preset.field_elements_per_blob
    scale = (n - 1).bit_length()
    assert (1 << scale) == n, "preset width must be a power of two"
    roots = compute_roots_of_unity(scale)  # already bit-reversed

    # Lagrange coefficients L_i(tau) over the bit-reversed domain:
    # L_i(tau) = (tau^n - 1) * w_i / (n * (tau - w_i))   (w_i^n == 1)
    zn = (pow(tau, n, R) - 1) % R
    ninv = pow(n, -1, R)
    g1_values = []
    for w in roots:
        li = (zn * w % R) * pow((tau - w) % R, -1, R) % R * ninv % R
        g1_values.append(gc.g1_mul(gc.G1_GENERATOR, li))

    g2_values = [gc.G2_GENERATOR, gc.g2_mul(gc.G2_GENERATOR, tau)]

    return KzgSettings(
        preset=preset,
        max_width=n,
        roots_of_unity=roots,
        g1_values=g1_values,
        g2_values=g2_values,
    )


def write_insecure_setup_file(path, preset: Preset, tau: int = 0x5EC2E7) -> None:
    """Write a ceremony-format text setup file (reference layout:
    kzg.rs:906-979 - counts, then G1 hex lines, then 65 monomial G2 hex
    lines) for ``preset`` with known secret ``tau``.  Loadable through the
    standard ``load_trusted_setup_file`` path, validation included."""
    from ..presets import TRUSTED_SETUP_NUM_G2_POINTS

    settings = make_insecure_setup(preset, tau)
    # Undo the bit-reversal for the on-disk G1 order (the loader re-applies
    # it, reference: kzg.rs:895-896).
    from ..utils.domain import reverse_bits

    n = preset.field_elements_per_blob
    g1_disk = [None] * n
    for i in range(n):
        g1_disk[reverse_bits(i, n)] = settings.g1_values[i]
    g2_disk = [
        gc.g2_mul(gc.G2_GENERATOR, pow(tau, j, R))
        for j in range(TRUSTED_SETUP_NUM_G2_POINTS)
    ]
    with open(path, "w") as fh:
        fh.write(f"{n}\n{TRUSTED_SETUP_NUM_G2_POINTS}\n")
        for p in g1_disk:
            fh.write(gc.g1_compress(p).hex() + "\n")
        for p in g2_disk:
            fh.write(gc.g2_compress(p).hex() + "\n")


def _ripple(runs) -> int:
    """A magnitude whose base-32 windows, least significant first, are each
    run's (first, length): a window ``first`` then ``length`` windows of 16,
    so that after a first of 17 or more a carry crosses the whole run."""
    windows = []
    for first, length in runs:
        windows += [first] + [16] * length
    return sum(w << (5 * j) for j, w in enumerate(windows))


def glv_ripple_scalars() -> list[int]:
    """16 canonical Fr scalars whose GLV halves (the device split: m1 =
    floor(k G1C / 2^264)) hold runs of 16-valued base-32 windows with a
    carry in: k = m (m1 = 0, so k1 = m and k2 = 0) for ripple magnitudes m,
    the first carrying through 24 windows, and (1 << 125) - 1; k with m1 =
    m (k2 = -m); r - m; and three more mixed ones."""
    mags = [
        _ripple([(17, 24)]),
        _ripple([(31, 11), (17, 11)]),
        _ripple([(16, 24)]),  # 16s with no carry in: no borrow at all
        _ripple([(17, 5), (3, 0), (20, 9), (18, 6)]),
        (1 << 125) - 1,
    ]
    ks = list(mags)
    for m in mags[:4]:
        k = -(-(m << 264) // glv.G1C)
        assert (k * glv.G1C) >> 264 == m and k < glv.HALF_R_CEIL
        ks.append(k)
    ks += [R - m for m in mags[:4]]
    return ks + [R - 1 - mags[0], mags[0] * 32 + 1, mags[1] + (mags[1] << 130)]
