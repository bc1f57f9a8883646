"""Numpy reference semantics for every engine op (the VP's functional model).

The port's own copy of ``repro.core.refops`` (byte-for-byte the same
behaviour): ``repro_torch`` imports nothing of ``repro``.

These are the *oracle* implementations: integer-exact for the nv_small INT8 path
(all int32 intermediates, deterministic across platforms) and float32-accumulate
for the nv_full bf16 path.  The jax executors (core/executor.py) and the Pallas
kernels (kernels/) are tested against these.

Data layout: activations are (C, H, W) int8 (NVDLA feature-data layout, N=1 per
inference as in the paper); conv weights are (K, C/g, R, S) int8 stored row-major
as a (K, C/g*R*S) GEMM matrix — the im2col adaptation that maps NVDLA's direct
convolution onto a TPU MXU-shaped matmul.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import quant


def im2col(x: np.ndarray, k: int, stride: int, pad: int) -> np.ndarray:
    """(C,H,W) -> (C*k*k, P*Q) patch matrix."""
    c, h, w = x.shape
    xp = np.pad(x, ((0, 0), (pad, pad), (pad, pad)))
    p = (h + 2 * pad - k) // stride + 1
    q = (w + 2 * pad - k) // stride + 1
    cols = np.empty((c, k, k, p, q), x.dtype)
    for r in range(k):
        for s in range(k):
            cols[:, r, s] = xp[:, r:r + stride * p:stride, s:s + stride * q:stride]
    return cols.reshape(c * k * k, p * q)


def conv_int8(x: np.ndarray, w: np.ndarray, bias: np.ndarray,
              scale_words: np.ndarray, k: int, stride: int, pad: int,
              groups: int = 1, relu: bool = False) -> np.ndarray:
    """CONV+SDP pipeline: int8 GEMM -> +bias(int32) -> per-ch requant -> relu."""
    c, h, w_in = x.shape
    kk = w.shape[0]
    p = (h + 2 * pad - k) // stride + 1
    q = (w_in + 2 * pad - k) // stride + 1
    if groups == 1:
        cols = im2col(x, k, stride, pad)                         # (C*k*k, P*Q)
        acc = w.astype(np.int32) @ cols.astype(np.int32)          # (K, P*Q)
    else:
        cg, kg = c // groups, kk // groups
        acc = np.empty((kk, p * q), np.int32)
        xg = x.reshape(groups, cg, h, w_in)
        wg = w.reshape(groups, kg, -1)
        for g in range(groups):                                   # vectorised per group
            cols = im2col(xg[g], k, stride, pad)
            acc[g * kg:(g + 1) * kg] = wg[g].astype(np.int32) @ cols.astype(np.int32)
    acc = acc + bias.astype(np.int32)[:, None]
    m, pre, post = _unpack_words(scale_words)
    out = quant.apply_scale(acc, m[:, None], pre[:, None], post[:, None])
    if relu:
        out = np.maximum(out, 0)
    return quant.clip8(out).reshape(kk, p, q)


def fc_int8(x: np.ndarray, w: np.ndarray, bias: np.ndarray,
            scale_words: np.ndarray, relu: bool = False) -> np.ndarray:
    acc = w.astype(np.int32) @ x.reshape(-1).astype(np.int32) + bias.astype(np.int32)
    m, pre, post = _unpack_words(scale_words)
    out = quant.apply_scale(acc, m, pre, post)
    if relu:
        out = np.maximum(out, 0)
    return quant.clip8(out).reshape(-1, 1, 1)


def maxpool_int8(x: np.ndarray, k: int, stride: int, pad: int) -> np.ndarray:
    c, h, w = x.shape
    xp = np.pad(x, ((0, 0), (pad, pad), (pad, pad)), constant_values=quant.INT8_MIN)
    p = (h + 2 * pad - k) // stride + 1
    q = (w + 2 * pad - k) // stride + 1
    out = np.full((c, p, q), quant.INT8_MIN, np.int8)
    for r in range(k):
        for s in range(k):
            out = np.maximum(out, xp[:, r:r + stride * p:stride, s:s + stride * q:stride])
    return out


def avgpool_int8(x: np.ndarray, k: int, stride: int, pad: int,
                 scale_word: int) -> np.ndarray:
    """Sum in int32, then fixed-point multiply by ~1/(k*k) (SDP-style)."""
    c, h, w = x.shape
    xp = np.pad(x.astype(np.int32), ((0, 0), (pad, pad), (pad, pad)))
    p = (h + 2 * pad - k) // stride + 1
    q = (w + 2 * pad - k) // stride + 1
    acc = np.zeros((c, p, q), np.int32)
    for r in range(k):
        for s in range(k):
            acc += xp[:, r:r + stride * p:stride, s:s + stride * q:stride]
    m, pre, post = quant.unpack_scale(int(scale_word))
    return quant.clip8(quant.apply_scale(acc, m, pre, post))


def gap_int8(x: np.ndarray, scale_word: int) -> np.ndarray:
    acc = x.astype(np.int32).sum(axis=(1, 2), keepdims=True)
    m, pre, post = quant.unpack_scale(int(scale_word))
    return quant.clip8(quant.apply_scale(acc, m, pre, post))


def add_int8(a: np.ndarray, b: np.ndarray, word_a: int, word_b: int,
             relu: bool = False) -> np.ndarray:
    """Residual add: both operands rescaled to the output scale, int32 sum."""
    ma, pa, sa = quant.unpack_scale(int(word_a))
    mb, pb, sb = quant.unpack_scale(int(word_b))
    acc = (quant.apply_scale(a.astype(np.int32), ma, pa, sa)
           + quant.apply_scale(b.astype(np.int32), mb, pb, sb))
    if relu:
        acc = np.maximum(acc, 0)
    return quant.clip8(acc)


def _unpack_words(words: np.ndarray):
    w = np.asarray(words, np.uint32)
    m = ((w >> 16) & 0xFFFF).astype(np.int32)
    m = np.where(m & 0x8000, m - 0x10000, m)
    return m, ((w >> 8) & 0xFF).astype(np.int32), (w & 0xFF).astype(np.int32)


# ---------------------------------------------------------------------------
# nv_full bf16 path (float32 accumulation; checked with tolerances, not bit-exact)
# ---------------------------------------------------------------------------
def conv_bf16(x: np.ndarray, w: np.ndarray, bias: np.ndarray, k: int, stride: int,
              pad: int, groups: int = 1, relu: bool = False) -> np.ndarray:
    x32 = x.astype(np.float32)
    w32 = w.astype(np.float32).reshape(w.shape[0], -1)   # accept (K,C/g,R,S) or (K, C/g*R*S)
    c, h, w_in = x.shape
    kk = w.shape[0]
    p = (h + 2 * pad - k) // stride + 1
    q = (w_in + 2 * pad - k) // stride + 1
    if groups == 1:
        acc = w32 @ im2col(x32, k, stride, pad)
    else:
        cg, kg = c // groups, kk // groups
        acc = np.empty((kk, p * q), np.float32)
        xg, wg = x32.reshape(groups, cg, h, w_in), w32.reshape(groups, kg, -1)
        for g in range(groups):
            acc[g * kg:(g + 1) * kg] = wg[g] @ im2col(xg[g], k, stride, pad)
    acc = acc + bias.astype(np.float32)[:, None]
    if relu:
        acc = np.maximum(acc, 0)
    return acc.reshape(kk, p, q)


def fc_bf16(x: np.ndarray, w: np.ndarray, bias: np.ndarray, relu: bool = False) -> np.ndarray:
    acc = w.astype(np.float32) @ x.reshape(-1).astype(np.float32) + bias.astype(np.float32)
    if relu:
        acc = np.maximum(acc, 0)
    return acc.reshape(-1, 1, 1)


def pool_f32(x: np.ndarray, r: int, s: int, stride: int, pad: int,
             mode: str) -> np.ndarray:
    """Float PDP reference (max with -inf fill / avg as sum over window),
    shared by the VP functional model and the ref executor backend — ONE
    copy of the nv_full pooling semantics."""
    c, h, w = x.shape
    fill = -np.inf if mode == "max" else 0.0
    xp = np.pad(x, ((0, 0), (pad, pad), (pad, pad)), constant_values=fill)
    p = (h + 2 * pad - r) // stride + 1
    q = (w + 2 * pad - s) // stride + 1
    acc = np.full((c, p, q), fill, np.float32)
    for i in range(r):
        for j in range(s):
            win = xp[:, i:i + stride * p:stride, j:j + stride * q:stride]
            acc = np.maximum(acc, win) if mode == "max" else acc + win
    return acc if mode == "max" else acc / (r * s)
