"""Trusted-setup loading and the KzgSettings container.

Mirrors reference: src/kzg.rs:24-79 (KzgSettings + byte loader),
src/kzg.rs:802-979 (core loader, Lagrange-form check, text-file loader) and
src/trusted_setup.rs (JSON parser). Parameterized by preset (mainnet/minimal)
per README.md:8-9 of the reference.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from . import hostcrypto
from .errors import BadArgs, InvalidTrustedSetup
from .presets import BYTES_PER_G1, BYTES_PER_G2, TRUSTED_SETUP_NUM_G2_POINTS, MAINNET, Preset
from .types import hex_to_bytes
from .utils.domain import bit_reversal_permutation, compute_roots_of_unity
from .utils.observability import logger, timed


@dataclass
class KzgSettings:
    """Parsed trusted setup (reference: kzg.rs:27-42).

    * ``roots_of_unity``: bit-reversal order, length ``max_width`` (Fr ints).
    * ``g1_values``: Lagrange-form G1 points in bit-reversal order (affine
      int tuples, None == infinity).
    * ``g2_values``: monomial-form G2 points (65 for the standard ceremony).
    """

    preset: Preset
    max_width: int
    roots_of_unity: list
    g1_values: list
    g2_values: list
    # Device-side mirrors, populated lazily by the torch backend.
    _device_cache: dict = field(default_factory=dict, repr=False)


def is_trusted_setup_in_lagrange_form(g1_values, g2_values) -> None:
    """Error if e(G1[1], G2[0]) == e(G1[0], G2[1]), which would mean the
    setup is in monomial form (reference: kzg.rs:802-830)."""
    if len(g1_values) < 2 or len(g2_values) < 2:
        raise BadArgs("is_trusted_setup_in_lagrange_form: invalid args")
    is_monomial_form = hostcrypto.pairings_verify(
        g1_values[1], g2_values[0], g1_values[0], g2_values[1]
    )
    if is_monomial_form:
        raise BadArgs("is_trusted_setup_in_lagrange_form: not in lagrange form")


def _setup_cache_path(g1_bytes: bytes, g2_bytes: bytes, preset: Preset):
    import hashlib
    import os

    h = hashlib.sha256()
    h.update(preset.name.encode())
    h.update(g1_bytes)
    h.update(g2_bytes)
    d = os.path.join(
        os.path.expanduser(
            os.environ.get("KZG_TORCH_CACHE_DIR", "~/.cache/kzg_rust_tpu_torch")
        )
    )
    return os.path.join(d, f"setup-{h.hexdigest()[:32]}.npz")


def _points_from_cache(path):
    """Load decompressed affine points from an npz bundle, or None.

    The cache is strictly best-effort: any failure (truncated/corrupt npz,
    schema drift, bad shapes) falls back to re-decompressing the inputs."""
    import numpy as np

    try:
        with np.load(path) as z:
            g1x, g1y, g1inf = z["g1x"], z["g1y"], z["g1inf"]
            g2c, g2inf = z["g2c"], z["g2inf"]
            g1 = [
                None
                if g1inf[i]
                else (
                    int.from_bytes(g1x[i].tobytes(), "big"),
                    int.from_bytes(g1y[i].tobytes(), "big"),
                )
                for i in range(g1x.shape[0])
            ]
            g2 = [
                None
                if g2inf[i]
                else (
                    (
                        int.from_bytes(g2c[i, 0, 0].tobytes(), "big"),
                        int.from_bytes(g2c[i, 0, 1].tobytes(), "big"),
                    ),
                    (
                        int.from_bytes(g2c[i, 1, 0].tobytes(), "big"),
                        int.from_bytes(g2c[i, 1, 1].tobytes(), "big"),
                    ),
                )
                for i in range(g2c.shape[0])
            ]
    except Exception:
        return None
    return g1, g2


def _validate_cached_points(g1_values, g2_values, n1: int, n2: int) -> bool:
    """Revalidate a cache hit before trusting it.

    The filename hash keys on the *inputs*, not the file contents, so a
    writable cache dir is part of the trust base.  Cheap checks run
    unconditionally (on-curve for every point, the Lagrange-form pairing
    check); the G1 subgroup sweep runs through the native host engine when
    it loads.  Any failure discards the cache entry and falls back to
    decompressing the original bytes."""
    from .golden import curve as gc

    try:
        if len(g1_values) != n1 or len(g2_values) != n2:
            return False
        with timed("load_trusted_setup.cache_validate", n=len(g1_values)):
            for p in g1_values:
                if p is not None and not gc.g1_is_on_curve(p):
                    return False
            for p in g2_values:
                if p is not None and not gc.g2_is_on_curve(p):
                    return False
            from . import native as _native

            if _native.available():
                if not hostcrypto.g1_subgroup_batch(g1_values):
                    return False
            is_trusted_setup_in_lagrange_form(g1_values, g2_values)
    except Exception:
        return False
    return True


def _points_to_cache(path, g1_values, g2_values) -> None:
    import os
    import tempfile

    import numpy as np

    n1, n2 = len(g1_values), len(g2_values)
    g1x = np.zeros((n1, 48), np.uint8)
    g1y = np.zeros((n1, 48), np.uint8)
    g1inf = np.zeros(n1, bool)
    for i, p in enumerate(g1_values):
        if p is None:
            g1inf[i] = True
        else:
            g1x[i] = np.frombuffer(p[0].to_bytes(48, "big"), np.uint8)
            g1y[i] = np.frombuffer(p[1].to_bytes(48, "big"), np.uint8)
    g2c = np.zeros((n2, 2, 2, 48), np.uint8)
    g2inf = np.zeros(n2, bool)
    for i, p in enumerate(g2_values):
        if p is None:
            g2inf[i] = True
        else:
            for a in range(2):
                for b in range(2):
                    g2c[i, a, b] = np.frombuffer(p[a][b].to_bytes(48, "big"), np.uint8)
    # Best-effort: an unwritable or full cache dir must never fail the load.
    tmp = None
    try:
        os.makedirs(os.path.dirname(path), mode=0o700, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, g1x=g1x, g1y=g1y, g1inf=g1inf, g2c=g2c, g2inf=g2inf)
        os.chmod(tmp, 0o600)
        os.replace(tmp, path)
    except Exception:
        if tmp is not None:
            try:
                os.unlink(tmp)
            except OSError:
                pass


def load_trusted_setup(
    g1_bytes: bytes,
    g2_bytes: bytes,
    n1: int,
    n2: int,
    preset: Preset = MAINNET,
) -> KzgSettings:
    """Core loader (reference: kzg.rs:833-899): uncompress all points
    (on-curve checked), verify Lagrange form via one pairing check, compute
    bit-reversed roots of unity, bit-reverse the G1 points.

    Decompressed points are cached on disk keyed by the input bytes (the
    reference re-decompresses 4161 points on every load, kzg.rs:859-887;
    here the second load of the same ceremony is a bulk array read).  Cache
    hits are revalidated before use (_validate_cached_points) since the
    file contents are not authenticated by the filename hash.  Disable
    caching by setting ``KZG_TORCH_CACHE_DIR`` to an empty string.
    """
    import os

    if n1 != preset.field_elements_per_blob or n2 != TRUSTED_SETUP_NUM_G2_POINTS:
        raise BadArgs("load_trusted_setup invalid params")

    max_scale = preset.max_scale
    max_width = 1 << max_scale

    cache_path = None
    if os.environ.get("KZG_TORCH_CACHE_DIR", True):
        cache_path = _setup_cache_path(g1_bytes, g2_bytes, preset)
        cached = _points_from_cache(cache_path)
        if cached is not None and _validate_cached_points(*cached, n1, n2):
            g1_cached, g2_cached = cached
            logger.debug(
                "load_trusted_setup cache=hit n1=%d n2=%d path=%s", n1, n2, cache_path
            )
            return KzgSettings(
                preset=preset,
                max_width=max_width,
                roots_of_unity=compute_roots_of_unity(max_scale),
                g1_values=bit_reversal_permutation(g1_cached, n1),
                g2_values=g2_cached,
            )

    with timed("load_trusted_setup.uncompress_g1", n=n1):
        try:
            g1_values = hostcrypto.g1_uncompress_batch(
                [g1_bytes[BYTES_PER_G1 * i : BYTES_PER_G1 * (i + 1)] for i in range(n1)]
            )
        except BadArgs:
            raise BadArgs("load_trusted_setup Invalid g1 bytes") from None
    g2_values = []
    with timed("load_trusted_setup.uncompress_g2", n=n2):
        for i in range(n2):
            try:
                g2_values.append(
                    hostcrypto.g2_uncompress(g2_bytes[BYTES_PER_G2 * i : BYTES_PER_G2 * (i + 1)])
                )
            except BadArgs:
                raise BadArgs("load_trusted_setup invalid g2 bytes") from None

    with timed("load_trusted_setup.lagrange_form_check"):
        is_trusted_setup_in_lagrange_form(g1_values, g2_values)

    if cache_path is not None:
        _points_to_cache(cache_path, g1_values, g2_values)

    roots_of_unity = compute_roots_of_unity(max_scale)
    g1_values = bit_reversal_permutation(g1_values, n1)

    return KzgSettings(
        preset=preset,
        max_width=max_width,
        roots_of_unity=roots_of_unity,
        g1_values=g1_values,
        g2_values=g2_values,
    )


def load_trusted_setup_from_arrays(
    g1_points: list[bytes], g2_points: list[bytes], preset: Preset = MAINNET
) -> KzgSettings:
    """Byte-array loader (reference: KzgSettings::load_trusted_setup, kzg.rs:45-78)."""
    if len(g1_points) != preset.field_elements_per_blob:
        raise InvalidTrustedSetup(
            f"Invalid number of g1 points in trusted setup. "
            f"Expected {preset.field_elements_per_blob} got {len(g1_points)}"
        )
    if len(g2_points) != TRUSTED_SETUP_NUM_G2_POINTS:
        raise InvalidTrustedSetup(
            f"Invalid number of g2 points in trusted setup. "
            f"Expected {TRUSTED_SETUP_NUM_G2_POINTS} got {len(g2_points)}"
        )
    for p in g1_points:
        if len(p) != BYTES_PER_G1:
            raise InvalidTrustedSetup("Invalid g1 point size")
    for p in g2_points:
        if len(p) != BYTES_PER_G2:
            raise InvalidTrustedSetup("Invalid g2 point size")
    return load_trusted_setup(
        b"".join(g1_points),
        b"".join(g2_points),
        preset.field_elements_per_blob,
        TRUSTED_SETUP_NUM_G2_POINTS,
        preset,
    )


def load_trusted_setup_file(path, preset: Preset = MAINNET) -> KzgSettings:
    """Text-file loader (reference: kzg.rs:906-979).

    Format: line 1 = n1 (must equal the preset's FIELD_ELEMENTS_PER_BLOB),
    line 2 = 65, then n1 G1 hex lines and 65 G2 hex lines.
    """
    try:
        with open(path) as fh:
            lines = fh.read().splitlines()
    except OSError as e:
        raise InvalidTrustedSetup(f"Failed to open trusted setup file: {e}") from None

    it = iter(lines)

    def next_line(msg: str) -> str:
        try:
            return next(it)
        except StopIteration:
            raise InvalidTrustedSetup(msg) from None

    line1 = next_line("Trusted setup file does not contain valid FIELD_ELEMENTS_PER_BLOB on line 1")
    try:
        field_elements_per_blob = int(line1)
    except ValueError:
        raise InvalidTrustedSetup("FIELD_ELEMENTS_PER_BLOB is not a valid integer") from None
    if field_elements_per_blob != preset.field_elements_per_blob:
        raise InvalidTrustedSetup(
            f"Invalid trusted setup for chosen preset. Selected preset "
            f"FIELD_ELEMENTS_PER_BLOB: {preset.field_elements_per_blob} "
            f"value in file: {field_elements_per_blob}"
        )

    line2 = next_line("Trusted setup file does not contain valid NUM_G2_POINTS on line 2")
    try:
        num_g2_points = int(line2)
    except ValueError:
        raise InvalidTrustedSetup("NUM_G2_POINTS is not a valid integer") from None
    if num_g2_points != TRUSTED_SETUP_NUM_G2_POINTS:
        raise InvalidTrustedSetup(
            f"Invalid trusted setup for chosen preset. Selected preset "
            f"NUM_G2_POINTS: {TRUSTED_SETUP_NUM_G2_POINTS} value in file: {num_g2_points}"
        )

    g1_bytes = bytearray()
    for _ in range(field_elements_per_blob):
        g1_bytes += hex_to_bytes(next_line("Invalid number of g1 points in file"))
    g2_bytes = bytearray()
    for _ in range(num_g2_points):
        g2_bytes += hex_to_bytes(next_line("Invalid number of g2 points in file"))

    return load_trusted_setup(
        bytes(g1_bytes), bytes(g2_bytes), field_elements_per_blob, num_g2_points, preset
    )


class TrustedSetup:
    """JSON trusted-setup parser (reference: src/trusted_setup.rs:21-153).

    Consumes only the ``setup_G1_lagrange`` and ``setup_G2`` keys (the file
    also carries ``setup_G1`` and ``roots_of_unity``, which are ignored) and
    truncates the G1 list to the preset's FIELD_ELEMENTS_PER_BLOB.
    """

    def __init__(self, g1_points: list[bytes], g2_points: list[bytes], preset: Preset = MAINNET):
        self._g1_points = g1_points
        self._g2_points = g2_points
        self.preset = preset

    @classmethod
    def from_json(cls, text: str, preset: Preset = MAINNET) -> "TrustedSetup":
        try:
            doc = json.loads(text)
            g1_hex = doc["setup_G1_lagrange"]
            g2_hex = doc["setup_G2"]
        except (json.JSONDecodeError, KeyError, TypeError) as e:
            raise InvalidTrustedSetup(f"Invalid trusted setup JSON: {e}") from None
        g1_points = [hex_to_bytes(h) for h in g1_hex]
        g2_points = [hex_to_bytes(h) for h in g2_hex]
        for p in g1_points:
            if len(p) != BYTES_PER_G1:
                raise InvalidTrustedSetup("Invalid G1 point hex length")
        for p in g2_points:
            if len(p) != BYTES_PER_G2:
                raise InvalidTrustedSetup("Invalid G2 point hex length")
        # reference: trusted_setup.rs:138-153 truncates to the preset size
        g1_points = g1_points[: preset.field_elements_per_blob]
        return cls(g1_points, g2_points, preset)

    @classmethod
    def from_file(cls, path, preset: Preset = MAINNET) -> "TrustedSetup":
        with open(path) as fh:
            return cls.from_json(fh.read(), preset)

    def g1_points(self) -> list[bytes]:
        return list(self._g1_points)

    def g2_points(self) -> list[bytes]:
        return list(self._g2_points)

    def g1_len(self) -> int:
        return len(self._g1_points)

    def g2_len(self) -> int:
        return len(self._g2_points)
