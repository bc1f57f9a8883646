"""The port's hand-written kernels, one package each, and what their entry
points share: argument checks (``check_operands``) and the lane-folded
im2col GEMM of a convolution over a bucket (``conv_batch``/``fc_batch``).
"""

from __future__ import annotations

import torch

from repro_torch.core.intmath import im2col


def check_operands(fn: str, operands) -> torch.device:
    """Raise ``ValueError`` unless every ``(name, tensor, dtype, ndim)`` has
    that dtype and rank, lies on the first operand's device (a CUDA device
    or the CPU) and is contiguous; return that device."""
    dev = operands[0][1].device
    for name, t, dt, nd in operands:
        if t.dtype != dt or t.dim() != nd:
            raise ValueError(f"{fn}: {name} must be a {nd}-d {dt} tensor, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{fn}: {name} is on {t.device}, "
                             f"{operands[0][0]} on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} is not contiguous")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{fn}: no kernel for device {dev}")
    return dev


def conv_batch(gemm, xs, tables, k: int, stride: int, pad: int,
               groups: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, M, P, Q) through ``gemm(w, cols, *rest)``, one
    call per group.

    ``tables`` = (w, *per-channel tables), each with the output channels on
    axis 0, sliced per group.  Each lane's im2col columns are stacked side
    by side on the GEMM N axis (column = lane * P*Q + position), so the
    weights are read once per bucket.
    """
    b, c, h, w_in = xs.shape
    m = tables[0].shape[0]
    p = (h + 2 * pad - k) // stride + 1
    q = (w_in + 2 * pad - k) // stride + 1
    cg, mg = c // groups, m // groups
    outs = []
    for g in range(groups):
        cols = im2col(xs[:, g * cg:(g + 1) * cg], k, stride, pad)  # (B, K, PQ)
        n = cols.shape[2]
        folded = cols.transpose(0, 1).reshape(cols.shape[1], b * n).contiguous()
        w, *rest = (t[g * mg:(g + 1) * mg] for t in tables)
        out = gemm(w, folded, *rest)                                # (Mg, B*PQ)
        outs.append(out.reshape(-1, b, n).transpose(0, 1))
    return torch.cat(outs, 1).reshape(b, m, p, q)


def fc_batch(gemm, xs, tables) -> torch.Tensor:
    """(B, Cin) -> (B, K_out, 1, 1): the bucket is the GEMM N axis, so the
    (K_out, Cin) weights are read once against a (Cin, B) activation block."""
    b = xs.shape[0]
    cols = xs.reshape(b, -1).t().contiguous()
    return gemm(tables[0], cols, *tables[1:]).t().reshape(b, -1, 1, 1)
