"""bfloat16 bytes in numpy, without ``ml_dtypes`` (the port's codec).

The nv_full datapath stores weights and activations as bfloat16.  The
reference reads and writes those bytes through ``ml_dtypes.bfloat16``; the
port must write the very same bytes (weight image, VP surfaces, the ``ref``
backend's arena) and cannot import ``ml_dtypes``, so its numpy modules go
through these two functions and through nothing else.

Rounding is to nearest, ties to even, as ``ml_dtypes`` does.  NaN maps as
``ml_dtypes`` maps it: the quiet NaN ``0x7FC0`` with the input's sign bit.
(Torch's own float32 -> bfloat16 cast gives ``0xFFFF`` for every NaN, so it is
not used for bytes that must equal the reference's.)  This is a leaf module:
it imports only numpy.
"""

from __future__ import annotations

import numpy as np


def f32_to_bf16_bits(x) -> np.ndarray:
    """float32 array -> uint16 bfloat16 bit patterns, round to nearest even.

    Any other dtype (float64 included) is cast to float32 first, so a float64
    value is rounded twice: to float32, then to bfloat16.
    """
    a = np.ascontiguousarray(x, dtype=np.float32)
    u = a.view(np.uint32)
    nan = (u & 0x7FFFFFFF) > 0x7F800000
    # NaN is masked before the carry: the bare formula would round a NaN's
    # payload up into the exponent and, from 0xFFFF...., into the sign bit.
    v = np.where(nan, np.uint32(0), u)
    bits = ((v + np.uint32(0x7FFF) + ((v >> 16) & 1)) >> 16).astype(np.uint16)
    return np.where(nan, ((u >> 16) & 0x8000).astype(np.uint16) | np.uint16(0x7FC0),
                    bits)


def bf16_bits_to_f32(bits) -> np.ndarray:
    """uint16 bfloat16 bit patterns -> float32 (exact)."""
    b = np.ascontiguousarray(bits, dtype=np.uint16)
    return (b.astype(np.uint32) << 16).view(np.float32)
