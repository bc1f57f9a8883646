"""The port's bfloat16 codec (``repro_torch.core.bf16``) against ``ml_dtypes``.

The port writes nv_full bytes (weight image, VP surfaces, the ``ref``
backend's arena) through this codec instead of ``ml_dtypes``, so it must give
the very same bits: on random float32 values, on every round-to-even tie,
and on the specials (signed zeros, infinities, NaN of either sign with any
payload, subnormals, the largest finite value).  Tolerance: bit equality.
"""

import ml_dtypes
import numpy as np
import pytest

from repro_torch.core.bf16 import bf16_bits_to_f32, f32_to_bf16_bits


def _want(x32: np.ndarray) -> np.ndarray:
    return x32.astype(ml_dtypes.bfloat16).view(np.uint16)


def _f32(bits) -> np.ndarray:
    return np.asarray(bits, np.uint32).view(np.float32)


@pytest.mark.filterwarnings("ignore::RuntimeWarning")
def test_random_bit_patterns():
    """Uniform over all 2^32 float32 bit patterns: NaNs, infinities and
    subnormals included."""
    u = np.random.default_rng(0).integers(0, 2**32, 1_000_000, dtype=np.uint64)
    x = _f32(u.astype(np.uint32))
    np.testing.assert_array_equal(f32_to_bf16_bits(x), _want(x))


def test_random_normal_values():
    x = np.random.default_rng(1).normal(0, 1, 1_000_000).astype(np.float32)
    x *= np.float32(2.0) ** np.random.default_rng(2).integers(-60, 60, x.size)
    np.testing.assert_array_equal(f32_to_bf16_bits(x), _want(x))


@pytest.mark.parametrize("low", [0x8000, 0x7FFF, 0x8001, 0x0000, 0xFFFF])
def test_every_tie_and_its_neighbours(low):
    """All 65,536 upper halves with the lower half exactly at the tie
    (0x8000) and just either side of it."""
    hi = np.arange(65536, dtype=np.uint32)
    x = _f32((hi << 16) | low)
    with np.errstate(invalid="ignore"):
        np.testing.assert_array_equal(f32_to_bf16_bits(x), _want(x))


@pytest.mark.filterwarnings("ignore::RuntimeWarning")
def test_specials():
    tiny = np.finfo(np.float32).tiny
    vals = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan,
                     np.finfo(np.float32).max, -np.finfo(np.float32).max,
                     tiny, -tiny, tiny / 2, -tiny / 3, 1e-45, -1e-45,
                     1.0, -1.0, 3.0, 2.0**-133], np.float32)
    nan_payloads = _f32([0x7F800001, 0xFF800001, 0x7FC00000, 0xFFFFFFFF,
                         0x7FFFFFFF, 0x7F80FFFF, 0xFFBF8000])
    x = np.concatenate([vals, nan_payloads])
    got = f32_to_bf16_bits(x)
    np.testing.assert_array_equal(got, _want(x))
    assert got[4] == 0x7FC0 and got[5] == 0xFFC0      # NaN keeps its sign
    assert got[6] == 0x7F80                           # max finite rounds to inf


def test_float64_is_cast_to_float32_first():
    x = np.random.default_rng(3).normal(0, 1, 100_000)
    np.testing.assert_array_equal(f32_to_bf16_bits(x),
                                  _want(x.astype(np.float32)))


def test_shape_is_kept_and_decoding_is_exact():
    x = np.random.default_rng(4).normal(0, 1, (3, 5, 7)).astype(np.float32)
    bits = f32_to_bf16_bits(x)
    assert bits.shape == x.shape and bits.dtype == np.uint16
    every = np.arange(65536, dtype=np.uint16)
    np.testing.assert_array_equal(
        bf16_bits_to_f32(every).view(np.uint32),
        every.view(ml_dtypes.bfloat16).astype(np.float32).view(np.uint32))
    np.testing.assert_array_equal(bf16_bits_to_f32(bits),
                                  x.astype(ml_dtypes.bfloat16).astype(np.float32))
