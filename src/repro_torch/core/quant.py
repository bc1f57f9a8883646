"""INT8 quantisation + calibration tables (the paper's declared FUTURE WORK).

The port's own copy of ``repro.core.quant`` (byte-for-byte the same
behaviour): ``repro_torch`` imports nothing of ``repro``.

The paper's nv_small path is INT8-only and its stated limitation is the missing
INT8 *calibration tables* for the NVDLA compiler.  We implement that gap:

  * ``calibrate``   — run sample batches through the fp32 reference network and
    record per-layer activation ranges (percentile of |x|), producing a
    ``CalibrationTable`` (the .json the NVDLA compiler expects).
  * symmetric per-channel INT8 weight quantisation,
  * NVDLA-SDP-style *fixed-point* requantisation.  NVDLA's SDP scales with a 16-bit
    multiplier plus truncation shifts; we mirror that exactly:

        out = clip( rha( rha(acc, pre) * m , post ) )        (rha = round-half-away)

    with ``m`` int16, so every intermediate fits int32 — the whole inference is
    integer-only and bit-exact across executors (VP == bare-metal == linux-stack)
    and across numpy / jax backends.

Scale word packing (one uint32 per channel, written to the SDP scale table):
    word = (m & 0xFFFF) << 16 | (pre & 0xFF) << 8 | (post & 0xFF)
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict

import numpy as np

INT8_MIN, INT8_MAX = -128, 127
M_MAX = (1 << 15) - 1          # int16 multiplier magnitude


@dataclasses.dataclass
class CalibrationTable:
    """Per-layer activation scales: fp_value ≈ int8_value * scale."""
    scales: Dict[str, float]

    def to_json(self) -> str:
        return json.dumps({"layer": {k: {"scale": v} for k, v in self.scales.items()}},
                          indent=1, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "CalibrationTable":
        d = json.loads(text)
        return cls({k: float(v["scale"]) for k, v in d["layer"].items()})


def act_scale(samples: np.ndarray, percentile: float = 99.99) -> float:
    """Symmetric activation scale from |x| percentile (à la TensorRT)."""
    amax = float(np.percentile(np.abs(samples), percentile))
    amax = max(amax, 1e-8)
    return amax / INT8_MAX


def quantize_weights(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric per-output-channel INT8: returns (w_int8, scales[K])."""
    k = w.shape[0]
    amax = np.abs(w.reshape(k, -1)).max(axis=1)
    amax = np.maximum(amax, 1e-8)
    scales = (amax / INT8_MAX).astype(np.float32)
    q = np.clip(np.round(w / scales.reshape((k,) + (1,) * (w.ndim - 1))),
                INT8_MIN, INT8_MAX).astype(np.int8)
    return q, scales


def quantize_act(x: np.ndarray, scale: float) -> np.ndarray:
    return np.clip(np.round(x / scale), INT8_MIN, INT8_MAX).astype(np.int8)


def quantize_bias(b: np.ndarray, in_scale: float, w_scales: np.ndarray) -> np.ndarray:
    """Bias folded to int32 at accumulator scale (in_scale * w_scale per channel)."""
    return np.round(b / (in_scale * w_scales)).astype(np.int64).clip(
        -2**31, 2**31 - 1).astype(np.int32)


# ---------------------------------------------------------------------------
# Fixed-point scale words
# ---------------------------------------------------------------------------
def fixed_point(mult: float, max_acc: int) -> tuple[int, int, int]:
    """Fold float ``mult`` into (m, pre, post): x*mult ≈ ((x>>pre)*m)>>post.

    ``max_acc`` bounds |x| so that (x>>pre) fits 15 bits and the int32 product
    (x>>pre)*m never overflows.
    """
    if mult <= 0:
        return 0, 0, 0
    pre = max(0, int(max_acc).bit_length() - 15)
    eff = mult * (1 << pre)      # multiplier applied to the pre-shifted value
    post = 0
    while eff * (1 << (post + 1)) <= M_MAX and post < 30:
        post += 1
    m = int(round(eff * (1 << post)))
    if m > M_MAX:
        m >>= 1
        post -= 1
    return m, pre, max(post, 0)


def pack_scale(m: int, pre: int, post: int) -> int:
    return ((m & 0xFFFF) << 16) | ((pre & 0xFF) << 8) | (post & 0xFF)


def unpack_scale(word: int) -> tuple[int, int, int]:
    m = (word >> 16) & 0xFFFF
    if m & 0x8000:
        m -= 0x10000
    return m, (word >> 8) & 0xFF, word & 0xFF


def requant_table(acc_scales: np.ndarray, out_scale: float, max_acc: int) -> np.ndarray:
    """Per-channel uint32 scale-word table for the SDP."""
    words = np.zeros(acc_scales.shape[0], np.uint32)
    for i, sc in enumerate(np.atleast_1d(acc_scales)):
        words[i] = pack_scale(*fixed_point(float(sc) / out_scale, max_acc))
    return words


def rha_shift(x: np.ndarray, k) -> np.ndarray:
    """Round-half-away-from-zero right shift, int32-exact (numpy reference)."""
    x = x.astype(np.int32)
    k = np.asarray(k, np.int32)
    mag = np.abs(x) + np.where(k > 0, np.int32(1) << np.maximum(k - 1, 0), 0)
    return (np.sign(x) * (mag >> k)).astype(np.int32)


def apply_scale(x: np.ndarray, m, pre, post) -> np.ndarray:
    """x*mult in fixed point (numpy reference; the jax twin lives in vp/executor)."""
    t = rha_shift(x, pre)
    return rha_shift(t * np.asarray(m, np.int32), post)


def clip8(x: np.ndarray) -> np.ndarray:
    return np.clip(x, INT8_MIN, INT8_MAX).astype(np.int8)
