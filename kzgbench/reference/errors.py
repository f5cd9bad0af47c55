"""The reference's one error type and the messages its copied modules raise."""


class BadArgs(ValueError):
    """Invalid input, as the EIP-4844 functions refuse it."""


MSG_BATCH_INV_ZERO = "fr_batch_inv: zero input"
MSG_EXPECT_48 = "g1_uncompress: expected 48 bytes"
MSG_G2_EXPECT_96 = "g2_uncompress: expected 96 bytes"
MSG_G2_UNCOMPRESSED_BIT = "g2_uncompress: uncompressed bit not set"
MSG_G2_BAD_INFINITY = "g2_uncompress: bad infinity encoding"
MSG_G2_X_RANGE = "g2_uncompress: x out of range"
MSG_G2_NOT_ON_CURVE = "g2_uncompress: point not on curve"
