"""Torch twins of the engine's integer arithmetic (``repro.core.intmath``).

The reference computes in jnp int32, whose adds, multiplies and ``abs`` wrap
modulo 2^32.  Torch gives no such promise for int32 on every device, so these
twins widen to int64, do each step there, and wrap back to int32 exactly where
the reference's int32 step would wrap (``wrap32``).  Results are int32
tensors, byte-equal to the reference on every input in the engine's domain:
shift counts ``pre``/``post`` in [0, 31], which ``quant.fixed_point``
guarantees (pre <= 16, post <= 30).

These are the plain versions the CUDA kernel (``kernels/int8_conv``) is held
against, and the arithmetic of the executor's PDP/EW ops.  This is a leaf
module: it imports only torch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_I32 = 1 << 31


def wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 two's-complement value of its low 32 bits (int64)."""
    return ((v + _I32) & 0xFFFFFFFF) - _I32


def _i64(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.int64)


def rha_shift(x, k) -> torch.Tensor:
    """Round-half-away-from-zero arithmetic right shift on int32."""
    x, k = _i64(x), _i64(k).to(x.device)
    half = torch.where(k > 0, wrap32(torch.ones_like(k) << (k - 1).clamp(min=0)),
                       torch.zeros_like(k))
    mag = wrap32(wrap32(x.abs()) + half)
    return wrap32(torch.sign(x) * (mag >> k)).to(torch.int32)


def apply_scale(x, m, pre, post) -> torch.Tensor:
    """Fixed-point rescale: ``((x >> pre) * m) >> post`` with rha rounding."""
    t = rha_shift(x, pre).to(torch.int64)
    return rha_shift(wrap32(t * _i64(m).to(t.device)), post)


def unpack_words(words_i32) -> tuple:
    """uint32 scale words (bitcast to int32) -> (m, pre, post) int32 tensors."""
    w = _i64(words_i32) & 0xFFFFFFFF
    m = (w >> 16) & 0xFFFF
    m = torch.where(m >= 0x8000, m - 0x10000, m)
    pre = (w >> 8) & 0xFF
    post = w & 0xFF
    return m.to(torch.int32), pre.to(torch.int32), post.to(torch.int32)


def clip8(x) -> torch.Tensor:
    return torch.as_tensor(x).clamp(-128, 127).to(torch.int8)


def row_epilogue(acc, bias, words, relu: bool) -> torch.Tensor:
    """SDP epilogue, per channel on the M (row) axis: +bias, requant, relu,
    int8 clip.  ``acc`` (M, N) int32; ``bias``/``words`` (M,) int32."""
    acc = wrap32(_i64(acc) + _i64(bias)[:, None])
    m, pre, post = unpack_words(words)
    out = apply_scale(acc, m[:, None], pre[:, None], post[:, None])
    if relu:
        out = out.clamp(min=0)
    return clip8(out)


def windows(xp: torch.Tensor, r: int, s: int, stride: int, p: int, q: int):
    """The r*s strided (..., P, Q) views of a padded surface, row-major in
    the window offset: what im2col and pooling read."""
    return [xp[..., i:i + stride * (p - 1) + 1:stride,
               j:j + stride * (q - 1) + 1:stride]
            for i in range(r) for j in range(s)]


def im2col(x: torch.Tensor, k: int, stride: int, pad: int) -> torch.Tensor:
    """(..., C, H, W) -> (..., C*k*k, P*Q), rows in (c, r, s) order.

    Built from strided slices of a zero-padded view (``F.unfold`` does not
    take int8), in the reference's row order.
    """
    *lead, c, h, w = x.shape
    xp = F.pad(x, (pad, pad, pad, pad)) if pad else x
    p = (h + 2 * pad - k) // stride + 1
    q = (w + 2 * pad - k) // stride + 1
    cols = windows(xp, k, k, stride, p, q)
    return torch.stack(cols, -3).reshape(*lead, c * k * k, p * q)
