"""Consensus-spec presets.

The reference README (reference: README.md:8-9) promises two modules,
``kzg_mainnet`` (4096 field elements per blob) and ``kzg_minimal`` (4), but
the shipped code hard-codes 4096 (reference: src/consts.rs:13). We implement
what the README promises: a runtime-selectable :class:`Preset` carrying every
size constant (reference: src/consts.rs:5-37), so the whole library is
parameterized instead of compile-time fixed.
"""

from __future__ import annotations

from dataclasses import dataclass


BYTES_PER_FIELD_ELEMENT = 32  # reference: consts.rs:5
BYTES_PER_COMMITMENT = 48  # reference: consts.rs:8
BYTES_PER_PROOF = 48  # reference: consts.rs:11
BYTES_PER_G1 = 48  # reference: consts.rs:31
BYTES_PER_G2 = 96  # reference: consts.rs:34
TRUSTED_SETUP_NUM_G2_POINTS = 65  # reference: consts.rs:37

# Fiat-Shamir domain separators (reference: consts.rs:22-25)
FIAT_SHAMIR_PROTOCOL_DOMAIN = b"FSBLOBVERIFY_V1_"
RANDOM_CHALLENGE_KZG_BATCH_DOMAIN = b"RCKZGBATCH___V1_"
DOMAIN_STR_LENGTH = 16


@dataclass(frozen=True)
class Preset:
    """All size constants for one consensus preset."""

    name: str
    field_elements_per_blob: int

    @property
    def bytes_per_blob(self) -> int:
        # reference: consts.rs:16
        return self.field_elements_per_blob * BYTES_PER_FIELD_ELEMENT

    @property
    def challenge_input_size(self) -> int:
        # reference: consts.rs:19 (domain + 16-byte degree + blob + commitment)
        return DOMAIN_STR_LENGTH + 16 + self.bytes_per_blob + BYTES_PER_COMMITMENT

    @property
    def max_scale(self) -> int:
        """log2 of the evaluation-domain width (smallest 2^k >= n)."""
        k = 0
        while (1 << k) < self.field_elements_per_blob:
            k += 1
        return k

    @property
    def max_width(self) -> int:
        return 1 << self.max_scale


MAINNET = Preset(name="mainnet", field_elements_per_blob=4096)
MINIMAL = Preset(name="minimal", field_elements_per_blob=4)

PRESETS = {"mainnet": MAINNET, "minimal": MINIMAL}
