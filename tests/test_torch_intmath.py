"""The port's integer twins (``repro_torch.core.intmath``) against the JAX
reference (``repro.core.intmath``).

Inputs are made with numpy from a seed and handed to both.  Tolerance: byte
equality (int32 / int8 results).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import intmath as J
from repro_torch.core import intmath as T

INT32_MIN, INT32_MAX = -2**31, 2**31 - 1


def _acc(seed: int, shape=(16, 37)) -> np.ndarray:
    """int32 accumulators: random, plus ties of both signs and values near
    +-2^31 in the first rows."""
    rng = np.random.default_rng(seed)
    a = rng.integers(INT32_MIN, INT32_MAX + 1, shape, dtype=np.int64)
    edges = [INT32_MIN, INT32_MIN + 1, INT32_MAX, INT32_MAX - 1, 0, 1, -1,
             2, -2, 3, -3, 6, -6, 12, -12, 1 << 20, -(1 << 20),
             (1 << 20) + (1 << 19), -((1 << 20) + (1 << 19))]
    a.reshape(-1)[:len(edges)] = edges
    return a.astype(np.int32)


def _words(seed: int, n: int) -> np.ndarray:
    """Packed scale words in the engine's domain (pre, post in [0, 31]),
    with m = -32768, m = 0 and pre = post = 0 among them."""
    rng = np.random.default_rng(seed)
    m = rng.integers(-32768, 32768, n)
    pre = rng.integers(0, 32, n)
    post = rng.integers(0, 32, n)
    m[:3], pre[:3], post[:3] = (-32768, 0, 32767), (0, 0, 31), (0, 5, 0)
    w = ((m & 0xFFFF) << 16) | (pre << 8) | post
    return w.astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("k", list(range(0, 32)))
def test_rha_shift(k):
    x = _acc(k)
    want = np.asarray(J.rha_shift(jnp.asarray(x), k))
    got = T.rha_shift(torch.from_numpy(x), k).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_rha_shift_ties_both_signs():
    x = np.array([1, -1, 3, -3, 5, -5, 6, -6, 10, -10], np.int32)
    for k in (1, 2):
        np.testing.assert_array_equal(
            T.rha_shift(torch.from_numpy(x), k).numpy(),
            np.asarray(J.rha_shift(jnp.asarray(x), k)))
    # half away from zero: 1 >> 1 = 1, -1 >> 1 = -1, 6 >> 2 = 2, -6 >> 2 = -2
    np.testing.assert_array_equal(
        T.rha_shift(torch.tensor([1, -1, 6, -6], dtype=torch.int32),
                    torch.tensor([1, 1, 2, 2])).numpy(), [1, -1, 2, -2])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_unpack_words(seed):
    w = _words(seed, 64)
    want = J.unpack_words(jnp.asarray(w))
    got = T.unpack_words(torch.from_numpy(w))
    for g, j in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_scale(seed):
    x = _acc(seed, (16, 37))
    m, pre, post = (np.array(a)[:, None]
                    for a in J.unpack_words(jnp.asarray(_words(seed, 16))))
    want = np.asarray(J.apply_scale(jnp.asarray(x), m, pre, post))
    got = T.apply_scale(torch.from_numpy(x), torch.from_numpy(m),
                        torch.from_numpy(pre), torch.from_numpy(post)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_row_epilogue(seed, relu):
    acc = _acc(seed, (24, 19))
    rng = np.random.default_rng(seed + 10)
    bias = rng.integers(INT32_MIN, INT32_MAX + 1, 24, dtype=np.int64).astype(np.int32)
    bias[:2] = (INT32_MAX, INT32_MIN)          # acc + bias wraps
    words = _words(seed, 24)
    want = np.asarray(J.row_epilogue(jnp.asarray(acc), jnp.asarray(bias),
                                     jnp.asarray(words), relu))
    got = T.row_epilogue(torch.from_numpy(acc), torch.from_numpy(bias),
                         torch.from_numpy(words), relu).numpy()
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)


def test_clip8():
    x = _acc(3)
    np.testing.assert_array_equal(T.clip8(torch.from_numpy(x)).numpy(),
                                  np.asarray(J.clip8(jnp.asarray(x))))


@pytest.mark.parametrize("k,stride,pad", [(1, 1, 0), (3, 1, 1), (3, 2, 0),
                                          (5, 2, 2), (7, 2, 3), (2, 3, 1)])
def test_im2col(k, stride, pad):
    x = np.random.default_rng(k * 10 + stride).integers(
        -128, 128, (5, 11, 9)).astype(np.int8)
    want = np.asarray(J.im2col(jnp.asarray(x), k, stride, pad))
    got = T.im2col(torch.from_numpy(x), k, stride, pad).numpy()
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)


def test_im2col_batched_is_per_lane():
    xs = np.random.default_rng(4).integers(-128, 128, (3, 4, 7, 7)).astype(np.int8)
    got = T.im2col(torch.from_numpy(xs), 3, 2, 1).numpy()
    for b in range(3):
        np.testing.assert_array_equal(
            got[b], np.asarray(J.im2col(jnp.asarray(xs[b]), 3, 2, 1)))
