"""Bare-metal RISC-V code generation (paper §IV-B2, final step).

The port's own copy of ``repro.core.asm`` (byte-for-byte the same
behaviour): ``repro_torch`` imports nothing of ``repro``.

Converts a configuration-file Trace into RV32I assembly and assembles it into a
program-memory image.  The paper compiles the equivalent assembly with the Codasip
SDK; we implement the tiny subset assembler ourselves (LUI/ADDI/LW/SW/BNE/JAL use
the real RV32I encodings) so the storage-efficiency numbers (program-memory bytes,
Table I analogue) are measured on a genuine binary.

Generated code shape, per command:

  write_reg A D:      lui/addi t0, A ; lui/addi t1, D ; sw t1, 0(t0)
  read_reg  A E M:    lui/addi t0, A ; lui/addi t1, E ; lui/addi t2, M
                 1:   lw t3, 0(t0) ; and t3, t3, t2 ; bne t3, t1, 1b   (poll)

This is exactly the paper's bare-metal execution model: the core does nothing but
replay stores into the engine's CSB window and poll status reads — no kernel, no
driver, no heap.
"""

from __future__ import annotations

import struct
from typing import List

from repro_torch.core.tracegen import Command, Trace

# register numbers
T0, T1, T2, T3 = 5, 6, 7, 28


def _lui(rd: int, imm20: int) -> int:
    return ((imm20 & 0xFFFFF) << 12) | (rd << 7) | 0x37


def _addi(rd: int, rs1: int, imm12: int) -> int:
    return ((imm12 & 0xFFF) << 20) | (rs1 << 15) | (0 << 12) | (rd << 7) | 0x13


def _sw(rs2: int, rs1: int, imm12: int) -> int:
    imm = imm12 & 0xFFF
    return ((imm >> 5) << 25) | (rs2 << 20) | (rs1 << 15) | (0b010 << 12) | ((imm & 0x1F) << 7) | 0x23


def _lw(rd: int, rs1: int, imm12: int) -> int:
    return ((imm12 & 0xFFF) << 20) | (rs1 << 15) | (0b010 << 12) | (rd << 7) | 0x03


def _and(rd: int, rs1: int, rs2: int) -> int:
    return (rs2 << 20) | (rs1 << 15) | (0b111 << 12) | (rd << 7) | 0x33


def _bne(rs1: int, rs2: int, off: int) -> int:
    imm = off & 0x1FFF
    return (((imm >> 12) & 1) << 31) | (((imm >> 5) & 0x3F) << 25) | (rs2 << 20) \
        | (rs1 << 15) | (0b001 << 12) | (((imm >> 1) & 0xF) << 8) \
        | (((imm >> 11) & 1) << 7) | 0x63


def _jal(rd: int, off: int) -> int:
    imm = off & 0x1FFFFF
    return (((imm >> 20) & 1) << 31) | (((imm >> 1) & 0x3FF) << 21) \
        | (((imm >> 11) & 1) << 20) | (((imm >> 12) & 0xFF) << 12) | (rd << 7) | 0x6F


def _li(rd: int, value: int) -> List[tuple]:
    """Materialise a 32-bit constant: lui + addi (standard li expansion)."""
    value &= 0xFFFFFFFF
    hi = (value + 0x800) >> 12
    lo = value - (hi << 12)
    ops = []
    ops.append(("lui", f"lui x{rd}, {hi:#x}", _lui(rd, hi)))
    ops.append(("addi", f"addi x{rd}, x{rd}, {lo}", _addi(rd, rd, lo)))
    return ops


def assemble(trace: Trace) -> tuple[str, bytes]:
    """Trace -> (assembly text, program-memory binary image)."""
    asm_lines: List[str] = ["# bare-metal NVDLA replay (generated)", ".text", "_start:"]
    words: List[int] = []

    def emit(ops):
        for _, text, word in ops:
            asm_lines.append("    " + text)
            words.append(word)

    for c in trace.commands:
        if c.kind == "write_reg":
            emit(_li(T0, c.addr))
            emit(_li(T1, c.data))
            asm_lines.append(f"    sw x{T1}, 0(x{T0})        # write_reg {c.addr:#x}")
            words.append(_sw(T1, T0, 0))
        else:  # read_reg: poll until (mem[addr] & mask) == expected
            emit(_li(T0, c.addr))
            emit(_li(T1, c.data & c.mask))
            emit(_li(T2, c.mask))
            asm_lines.append(f"poll_{len(words)}:")
            asm_lines.append(f"    lw x{T3}, 0(x{T0})        # read_reg {c.addr:#x}")
            words.append(_lw(T3, T0, 0))
            asm_lines.append(f"    and x{T3}, x{T3}, x{T2}")
            words.append(_and(T3, T3, T2))
            asm_lines.append(f"    bne x{T3}, x{T1}, poll_{len(words) - 2}")
            words.append(_bne(T3, T1, -8))
    # halt: jal x0, 0 (spin)
    asm_lines.append("halt:")
    asm_lines.append("    jal x0, halt")
    words.append(_jal(0, 0))

    binary = b"".join(struct.pack("<I", w) for w in words)
    return "\n".join(asm_lines) + "\n", binary


def disassemble_writes(binary: bytes) -> List[tuple[int, int]]:
    """Recover the (addr, data) store stream from a program image (test helper).

    Walks the binary tracking li-materialised registers and records every
    ``sw t1, 0(t0)``.
    """
    regs = {}
    writes = []
    for i in range(0, len(binary), 4):
        (w,) = struct.unpack("<I", binary[i:i + 4])
        op = w & 0x7F
        if op == 0x37:                                   # lui
            rd = (w >> 7) & 0x1F
            regs[rd] = ((w >> 12) & 0xFFFFF) << 12
        elif op == 0x13 and ((w >> 12) & 7) == 0:        # addi
            rd, rs1 = (w >> 7) & 0x1F, (w >> 15) & 0x1F
            imm = w >> 20
            if imm & 0x800:
                imm -= 0x1000
            regs[rd] = (regs.get(rs1, 0) + imm) & 0xFFFFFFFF
        elif op == 0x23 and ((w >> 12) & 7) == 0b010:    # sw
            rs1, rs2 = (w >> 15) & 0x1F, (w >> 20) & 0x1F
            writes.append((regs.get(rs1, 0), regs.get(rs2, 0)))
    return writes
