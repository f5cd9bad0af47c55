"""Pure-Python big-int golden model of BLS12-381 and the KZG protocol.

This subpackage is the correctness oracle: slow, branchy, host-only code that
every JAX/Pallas kernel in ``kzg_rust_tpu.ops`` is tested against, and the
generator for minimal-preset test vectors (the reference ships only mainnet
vectors).
"""

from . import curve, field, pairing  # noqa: F401
