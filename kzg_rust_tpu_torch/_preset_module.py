"""Preset-bound namespace factory for ``kzg_mainnet`` / ``kzg_minimal``.

The reference README promises two preset modules, ``kzg_mainnet`` and
``kzg_minimal`` (reference: README.md:8-9); its mounted code predates that
split and hard-codes 4096 (reference: consts.rs:13; SURVEY.md section 0).
Here each preset gets a thin namespace whose ``Kzg`` loaders default to the
preset and whose ``Blob`` validates the preset's length, so reference users
can port ``kzg_mainnet::Kzg`` / ``kzg_minimal::Kzg`` call sites verbatim.
"""

from __future__ import annotations

from . import types as _types
from .api import Kzg as _Kzg
from .presets import Preset
from .settings import KzgSettings, TrustedSetup


def build(preset: Preset):
    """Return the (Kzg, Blob) pair bound to ``preset``."""

    class Blob(_types.Blob):
        def __new__(cls, data: bytes):
            return super().__new__(cls, data, bytes_per_blob=preset.bytes_per_blob)

        @classmethod
        def from_bytes(cls, data: bytes):
            return cls(bytes(data))

        @classmethod
        def from_hex(cls, hex_str: str):
            return cls(_types.hex_to_bytes(hex_str))

    Blob.__doc__ = (
        f"A {preset.name} blob: {preset.field_elements_per_blob} 32-byte "
        "field elements (reference: kzg.rs:154-178)."
    )

    bound = preset

    class Kzg(_Kzg):
        PRESET = bound

        # Parameter names match the base Kzg exactly so keyword call sites
        # port verbatim; only the defaults are preset-bound.
        @staticmethod
        def load_trusted_setup_file(path, preset: Preset = bound) -> KzgSettings:
            return _Kzg.load_trusted_setup_file(path, preset)

        @staticmethod
        def load_trusted_setup(
            trusted_setup: TrustedSetup, preset: Preset | None = None
        ) -> KzgSettings:
            return _Kzg.load_trusted_setup(trusted_setup, preset or bound)

    Kzg.__doc__ = f"The eight spec functions bound to the {preset.name} preset."
    return Kzg, Blob
