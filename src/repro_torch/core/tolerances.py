"""Tolerance model for the bf16 ``nv_full`` datapath — the parity harness.

The port's own copy of ``repro.core.tolerances`` (the same budgets):
``repro_torch`` imports nothing of ``repro``.

The INT8 ``nv_small`` path is bit-exact by construction, so its parity tests
use ``assert_array_equal``.  The bf16 path cannot be: weights and activations
are stored as bfloat16 (8 significand bits) and accumulated in float32, so two
correct implementations of the same layer — numpy ``refops.conv_bf16`` (the VP
oracle), the executors' XLA GEMM, the Pallas block-K kernel — legitimately
differ in f32 *summation order*.  That ordering drift is tiny (~K * 2^-24
relative), but each layer output is rounded back to bf16, and a value sitting
on a rounding boundary can land one bf16 ulp apart between arms.  A flipped
ulp is a 2^-8 relative perturbation that propagates through every downstream
layer.

The harness therefore derives a per-layer budget from the accumulation depth
and composes it over the network:

  * one GEMM layer of contraction depth K:
      ``rtol_layer = BF16_EPS + K * F32_ORDER_EPS``
    — one bf16 output-rounding ulp, plus the worst-case f32 reassociation
    drift of a K-deep sum (both sides round from f32 values at most
    ``K * 2^-22`` apart, relative).
  * a network: layer budgets add — a flipped ulp entering layer *l* is a
    relative perturbation of its inputs, and the layers evaluated here
    (conv/fc/pool/add with ReLU) are 1-Lipschitz in relative terms at this
    granularity, so
      ``rtol_net = sum over CONV/FC layers of rtol_layer``.

``atol`` is tied to the magnitude of the expected tensor (ReLU makes exact
zeros common, where a pure rtol check is vacuous or a pure atol check is
arbitrary): ``atol = rtol * max|expected|``.

These are deliberately *upper* bounds: tight enough that a wrong epilogue, a
bf16 (instead of f32) accumulator, or a transposed weight view fails by orders
of magnitude; loose enough that legal reassociation never flakes.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence

import numpy as np

BF16_EPS = 2.0 ** -8          # one bf16 ulp, relative (8 significand bits)
F32_ORDER_EPS = 2.0 ** -22    # per-element f32 reassociation budget (4 eps)


@dataclasses.dataclass(frozen=True)
class Tolerance:
    """A relative budget plus how to anchor the absolute one."""
    rtol: float

    def atol_for(self, expected: np.ndarray) -> float:
        """Scale-invariant absolute anchor: rtol * max|expected|.

        No magnitude floor — a network whose outputs are all ~0.05 must be
        checked at 0.05's scale or the gate goes vacuous.  The degenerate
        all-zero tensor (both arms produced exact zeros) keeps a tiny
        rtol-sized allowance so it never divides by the signal.
        """
        e = np.asarray(expected, np.float64)
        m = float(np.max(np.abs(e))) if e.size else 0.0
        return self.rtol * (m if m > 0.0 else 1.0)

    def merged(self, other: "Tolerance") -> "Tolerance":
        return Tolerance(rtol=self.rtol + other.rtol)


def gemm_tolerance(contract_k: int) -> Tolerance:
    """Budget for ONE bf16 GEMM layer (conv or fc) of contraction depth K."""
    return Tolerance(rtol=BF16_EPS + max(int(contract_k), 1) * F32_ORDER_EPS)


def net_tolerance(kernel_plan: Optional[Sequence] = None,
                  contract_ks: Optional[Iterable[int]] = None) -> Tolerance:
    """Whole-network budget: per-layer GEMM budgets, summed.

    Pass either the ``Artifacts.kernel_plan`` manifest entries (CONV/FC rows
    carry ``contract_k``) or an explicit iterable of contraction depths.
    """
    if contract_ks is None:
        if kernel_plan is None:
            raise ValueError("need a kernel_plan or explicit contract_ks")
        contract_ks = [e["contract_k"] for e in kernel_plan
                       if e.get("unit") in ("CONV", "FC")]
    ks = list(contract_ks)
    if not ks:
        return Tolerance(rtol=BF16_EPS)
    return Tolerance(rtol=sum(gemm_tolerance(k).rtol for k in ks))


def assert_close(got, want, tol: Tolerance, context: str = "") -> None:
    """``assert_allclose`` with the tolerance model's (rtol, atol) anchoring.

    ``got``/``want`` are compared as float64; ``atol`` is anchored to the
    magnitude of ``want`` so exact zeros (ReLU) don't make the check vacuous.
    """
    got = np.asarray(got, np.float64).reshape(-1)
    want = np.asarray(want, np.float64).reshape(-1)
    np.testing.assert_allclose(
        got, want, rtol=tol.rtol, atol=tol.atol_for(want),
        err_msg=f"bf16 parity exceeded the derived tolerance "
                f"(rtol={tol.rtol:.2e}){' in ' + context if context else ''}")


def max_rel_err(got, want) -> float:
    """Max |got-want| / max|want| — the scalar the benchmarks report."""
    got = np.asarray(got, np.float64).reshape(-1)
    want = np.asarray(want, np.float64).reshape(-1)
    denom = max(float(np.max(np.abs(want))), 1e-30)
    return float(np.max(np.abs(got - want))) / denom
