"""Engine model: a TPU-native analogue of the NVDLA accelerator.

The port's own copy of ``repro.core.engine`` (byte-for-byte the same
behaviour): ``repro_torch`` imports nothing of ``repro``.

The paper couples a µRISC-V control core to NVDLA, whose compute is organised as
fixed-function units driven by memory-mapped registers on the CSB:

  * CONV  (CDMA/CSC/CMAC/CACC) — the MAC array.  TPU analogue: the MXU, fed by an
    im2col GEMM (this is how we *adapt*, not port: NVDLA's direct-conv dataflow is
    re-blocked as a GEMM so it maps onto the systolic array; see DESIGN.md §2).
  * SDP — single-point unit: bias add, per-channel rescale (requantisation), ReLU.
    TPU analogue: the VPU epilogue fused into the GEMM kernel.
  * PDP — planar pooling unit (max/avg).
  * (CDP/RUBIK/BDMA are not needed for the evaluated models and are not modelled.)

Two hardware configurations mirror the paper:

  * ``nv_small`` — INT8 only, 64 MACs, 8-bit datapath (what fits the ZCU102).
  * ``nv_full``  — adds FP16 (we use bf16: the TPU-native 16-bit type), 2048 MACs.

The register map below is a *simplified but faithful in spirit* CSB layout: every op
executed by the engine is described purely by register writes (addresses into the
DRAM arena, packed dimensions, fixed-point requant scales) followed by an OP_ENABLE
write and a STATUS read — exactly the command stream the paper replays from bare-metal
RISC-V assembly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

# ---------------------------------------------------------------------------
# Address map (paper §IV-A2): NVDLA CSB registers live at 0x0..0xFFFFF and DRAM
# at 0x10_0000 upward (512 MB window).
# ---------------------------------------------------------------------------
CSB_BASE = 0x0
CSB_SIZE = 0x10_0000
DRAM_BASE = 0x10_0000
DRAM_SIZE = 512 * 1024 * 1024

# Unit base addresses inside the CSB window (one "descriptor file" per unit).
UNIT_BASE = {
    "GLB": 0x0000,   # global: interrupt/status
    "CONV": 0x5000,  # convolution core (CDMA+CSC+CMAC+CACC collapsed)
    "SDP": 0x7000,   # single-point: bias / rescale / activation
    "PDP": 0x9000,   # planar pooling
    "FC": 0xB000,    # fully-connected (CONV core in 1x1 mode; separate file for clarity)
    "EW": 0xD000,    # element-wise (residual add) — SDP X1 path in real NVDLA
}

# Register offsets (byte offsets, 32-bit registers) within a unit's file.
REG = {
    "OP_ENABLE": 0x00,    # write 1 to kick the op
    "STATUS": 0x04,       # reads 0x1 when done
    "SRC_ADDR": 0x08,     # input surface address (DRAM)
    "SRC_DIMS0": 0x0C,    # (C << 16) | H
    "SRC_DIMS1": 0x10,    # (W << 16) | N
    "DST_ADDR": 0x14,     # output surface address
    "DST_DIMS0": 0x18,    # (K << 16) | P
    "DST_DIMS1": 0x1C,    # (Q << 16) | N
    "WT_ADDR": 0x20,      # weight base address
    "WT_DIMS": 0x24,      # (R << 24) | (S << 16) | reserved
    "STRIDE_PAD": 0x28,   # (stride << 16) | pad
    "BIAS_ADDR": 0x2C,    # int32 bias vector address (SDP)
    "SCALE_ADDR": 0x30,   # per-channel fixed-point scale table address (SDP)
    "FLAGS": 0x34,        # bit0: relu, bits1-2: pool mode (1=max,2=avg), bit3: residual
    "AUX_ADDR": 0x38,     # second operand (element-wise add)
    "AUX_SCALE": 0x3C,    # (m<<16)|(pre<<8)|post fixed-point rescale, aux operand
    "OUT_SCALE": 0x40,    # (m<<16)|(pre<<8)|post output requant (per-tensor ops)
}

REG_WIDTH = 4
DONE = 0x1

# Reverse maps for decoding traces back into descriptors.
_UNIT_BY_BASE = {v: k for k, v in UNIT_BASE.items()}
_REG_BY_OFF = {v: k for k, v in REG.items()}


def reg_addr(unit: str, reg: str) -> int:
    return CSB_BASE + UNIT_BASE[unit] + REG[reg]


def split_reg_addr(addr: int) -> tuple[str, str]:
    """Inverse of :func:`reg_addr`."""
    off = addr - CSB_BASE
    base = off & ~0xFFF
    if base not in _UNIT_BY_BASE:
        raise ValueError(f"address {addr:#x} does not decode to a unit")
    reg_off = off - base
    if reg_off not in _REG_BY_OFF:
        raise ValueError(f"address {addr:#x} does not decode to a register")
    return _UNIT_BY_BASE[base], _REG_BY_OFF[reg_off]


# ---------------------------------------------------------------------------
# Engine configurations (paper Tables II & III)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static description of one engine build (nv_small / nv_full analogue)."""

    name: str
    dtype: str                # "int8" or "bf16"
    macs: int                 # MAC count (nv_small=64, nv_full=2048)
    dbb_bytes_per_cycle: int  # data-backbone width (8B for 64-bit AXI, 64B for 512-bit)
    conv_buf_kib: int         # on-chip conv buffer (VMEM analogue)
    csb_cycles_per_access: int = 4   # cost of one register write/read from the core
    freq_mhz: int = 100              # paper's system clock
    # First-order efficiency derates, calibrated once against the paper's own
    # measurements (Table II): real DDR4 + DMA pipelines do not hit 100% MAC
    # utilisation or bus efficiency, and each hardware-layer launch pays a fixed
    # DMA-programming + completion-polling latency.
    mac_util: float = 0.85
    dbb_eff: float = 0.85
    op_overhead_cycles: int = 64_000

    @property
    def acc_dtype(self) -> str:
        return "int32" if self.dtype == "int8" else "float32"

    @property
    def elem_bytes(self) -> int:
        return 1 if self.dtype == "int8" else 2

    # ---- cycle model -------------------------------------------------------
    # A simple max(compute, memory) + configuration-overhead model, used to derive
    # the "processing time @100MHz" columns of Tables II/III.
    def op_cycles(self, macs_ops: int, bytes_moved: int, n_reg_writes: int) -> int:
        compute = int(np.ceil(macs_ops / (self.macs * self.mac_util)))
        memory = int(np.ceil(bytes_moved / (self.dbb_bytes_per_cycle * self.dbb_eff)))
        config = n_reg_writes * self.csb_cycles_per_access + self.op_overhead_cycles
        return max(compute, memory) + config

    def cycles_to_ms(self, cycles: int) -> float:
        return cycles / (self.freq_mhz * 1e6) * 1e3


NV_SMALL = EngineConfig(
    name="nv_small", dtype="int8", macs=64, dbb_bytes_per_cycle=8, conv_buf_kib=128
)
# nv_full: 2048 MACs, 512-bit AXI (paper §VI), much deeper pipelines -> lower fixed
# per-layer overhead fraction; op overhead calibrated against Table III LeNet row.
NV_FULL = EngineConfig(
    name="nv_full", dtype="bf16", macs=2048, dbb_bytes_per_cycle=64, conv_buf_kib=512,
    op_overhead_cycles=16_000
)

CONFIGS: Dict[str, EngineConfig] = {"nv_small": NV_SMALL, "nv_full": NV_FULL}


# ---------------------------------------------------------------------------
# Descriptors: the decoded form of one engine op's register file.
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Descriptor:
    """One engine operation, as decoded from (or encoded into) register writes."""

    unit: str
    src_addr: int = 0
    src_dims: tuple = (0, 0, 0, 0)   # (N, C, H, W)
    dst_addr: int = 0
    dst_dims: tuple = (0, 0, 0, 0)   # (N, K, P, Q)
    wt_addr: int = 0
    kernel: tuple = (0, 0)           # (R, S)
    groups: int = 1                  # grouped/depthwise conv
    stride: int = 1
    pad: int = 0
    bias_addr: int = -1
    scale_addr: int = -1
    relu: bool = False
    pool_mode: int = 0               # 0 none, 1 max, 2 avg
    residual: bool = False
    aux_addr: int = -1
    aux_scale: tuple = (1, 0, 0)     # (m, pre, post) fixed-point, see core/quant.py
    out_scale: tuple = (1, 0, 0)

    def to_reg_writes(self) -> list[tuple[int, int]]:
        """Encode this descriptor as the (addr, data) register-write sequence."""
        u = self.unit
        n, c, h, w = self.src_dims
        n2, k, p, q = self.dst_dims
        r, s = self.kernel
        flags = (int(self.relu) | (self.pool_mode << 1) | (int(self.residual) << 3))
        writes = [
            (reg_addr(u, "SRC_ADDR"), self.src_addr),
            (reg_addr(u, "SRC_DIMS0"), ((c & 0xFFFF) << 16) | (h & 0xFFFF)),
            (reg_addr(u, "SRC_DIMS1"), ((w & 0xFFFF) << 16) | (n & 0xFFFF)),
            (reg_addr(u, "DST_ADDR"), self.dst_addr),
            (reg_addr(u, "DST_DIMS0"), ((k & 0xFFFF) << 16) | (p & 0xFFFF)),
            (reg_addr(u, "DST_DIMS1"), ((q & 0xFFFF) << 16) | (n2 & 0xFFFF)),
            (reg_addr(u, "WT_ADDR"), self.wt_addr if self.wt_addr >= 0 else 0),
            (reg_addr(u, "WT_DIMS"),
             ((r & 0xFF) << 24) | ((s & 0xFF) << 16) | (self.groups & 0xFFFF)),
            (reg_addr(u, "STRIDE_PAD"), ((self.stride & 0xFFFF) << 16) | (self.pad & 0xFFFF)),
            (reg_addr(u, "FLAGS"), flags),
        ]
        if self.bias_addr >= 0:
            writes.append((reg_addr(u, "BIAS_ADDR"), self.bias_addr))
        if self.scale_addr >= 0:
            writes.append((reg_addr(u, "SCALE_ADDR"), self.scale_addr))
        if self.aux_addr >= 0:
            writes.append((reg_addr(u, "AUX_ADDR"), self.aux_addr))
            writes.append((reg_addr(u, "AUX_SCALE"), _pack_scale(self.aux_scale)))
        writes.append((reg_addr(u, "OUT_SCALE"), _pack_scale(self.out_scale)))
        writes.append((reg_addr(u, "OP_ENABLE"), 1))
        return writes


def decode_descriptors(commands) -> list[Descriptor]:
    """Rebuild descriptors from a ``write_reg``/``read_reg`` command stream.

    This is the bare-metal executor's front-end: given ONLY the trace (no model
    graph), reconstruct what the engine was asked to do.  An op is complete when
    its unit's OP_ENABLE register is written.
    """
    pending: Dict[str, Descriptor] = {}
    out: list[Descriptor] = []
    for cmd in commands:
        if cmd.kind != "write_reg":
            continue
        unit, reg = split_reg_addr(cmd.addr)
        if unit == "GLB":
            continue
        d = pending.setdefault(unit, Descriptor(unit=unit))
        v = cmd.data
        if reg == "SRC_ADDR":
            d.src_addr = v
        elif reg == "SRC_DIMS0":
            c, h = v >> 16, v & 0xFFFF
            d.src_dims = (d.src_dims[0], c, h, d.src_dims[3])
        elif reg == "SRC_DIMS1":
            w, n = v >> 16, v & 0xFFFF
            d.src_dims = (n, d.src_dims[1], d.src_dims[2], w)
        elif reg == "DST_ADDR":
            d.dst_addr = v
        elif reg == "DST_DIMS0":
            k, p = v >> 16, v & 0xFFFF
            d.dst_dims = (d.dst_dims[0], k, p, d.dst_dims[3])
        elif reg == "DST_DIMS1":
            q, n = v >> 16, v & 0xFFFF
            d.dst_dims = (n, d.dst_dims[1], d.dst_dims[2], q)
        elif reg == "WT_ADDR":
            d.wt_addr = v
        elif reg == "WT_DIMS":
            d.kernel = ((v >> 24) & 0xFF, (v >> 16) & 0xFF)
            d.groups = max(v & 0xFFFF, 1)
        elif reg == "STRIDE_PAD":
            d.stride, d.pad = v >> 16, v & 0xFFFF
        elif reg == "BIAS_ADDR":
            d.bias_addr = v
        elif reg == "SCALE_ADDR":
            d.scale_addr = v
        elif reg == "FLAGS":
            d.relu = bool(v & 1)
            d.pool_mode = (v >> 1) & 0x3
            d.residual = bool(v & 0x8)
        elif reg == "AUX_ADDR":
            d.aux_addr = v
        elif reg == "AUX_SCALE":
            d.aux_scale = _unpack_scale(v)
        elif reg == "OUT_SCALE":
            d.out_scale = _unpack_scale(v)
        elif reg == "OP_ENABLE":
            out.append(pending.pop(unit))
    return out


def _pack_scale(mps: tuple) -> int:
    m, pre, post = mps
    return ((m & 0xFFFF) << 16) | ((pre & 0xFF) << 8) | (post & 0xFF)


def _unpack_scale(v: int) -> tuple:
    m = (v >> 16) & 0xFFFF
    if m & 0x8000:
        m -= 0x10000
    return (m, (v >> 8) & 0xFF, v & 0xFF)
