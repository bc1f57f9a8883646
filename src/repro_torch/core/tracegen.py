"""Configuration-file generation from VP logs (paper §IV-B2).

The port's own copy of ``repro.core.tracegen`` (byte-for-byte the same
behaviour): ``repro_torch`` imports nothing of ``repro``.

Exactly the paper's methodology:

  * lines containing ``nvdla.csb_adaptor`` are register transactions;
    ``iswrite=1`` -> ``write_reg addr data``; ``iswrite=0`` -> ``read_reg addr
    expected`` (the logged data value is the expected status).
  * lines containing ``nvdla.dbb_adaptor`` are data transactions, consumed by
    ``core/memory.extract_weights`` for the weight file.

The resulting command sequence is the *configuration file* — the single artifact
(besides the weight image) a bare-metal core needs to run the network.  It
serialises to the NVDLA trace-player text format and round-trips losslessly.
"""

from __future__ import annotations

import dataclasses
import re
from typing import List

from repro_torch.core.memory import DbbTxn

_CSB_RE = re.compile(
    r"nvdla\.csb_adaptor:\s*iswrite=(\d)\s*addr=0x([0-9a-fA-F]+)\s*data=0x([0-9a-fA-F]+)")
_DBB_RE = re.compile(
    r"nvdla\.dbb_adaptor:\s*iswrite=(\d)\s*addr=0x([0-9a-fA-F]+)\s*len=(\d+)\s*data=([0-9a-fA-F]*)")


@dataclasses.dataclass(frozen=True)
class Command:
    kind: str        # "write_reg" | "read_reg"
    addr: int
    data: int        # write value, or expected read value
    mask: int = 0xFFFFFFFF


@dataclasses.dataclass
class Trace:
    """The configuration file: an ordered command stream."""
    commands: List[Command]

    # -- serialisation (NVDLA trace-player style text) -----------------------
    def to_text(self) -> str:
        out = []
        for c in self.commands:
            if c.kind == "write_reg":
                out.append(f"write_reg {c.addr:#x} {c.data:#010x}")
            else:
                out.append(f"read_reg {c.addr:#x} {c.data:#010x} {c.mask:#010x}")
        return "\n".join(out) + "\n"

    @classmethod
    def from_text(cls, text: str) -> "Trace":
        cmds = []
        for line in text.splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if parts[0] == "write_reg":
                cmds.append(Command("write_reg", int(parts[1], 16), int(parts[2], 16)))
            elif parts[0] == "read_reg":
                cmds.append(Command("read_reg", int(parts[1], 16), int(parts[2], 16),
                                    int(parts[3], 16)))
            else:
                raise ValueError(f"bad trace line: {line}")
        return cls(cmds)

    @property
    def n_writes(self) -> int:
        return sum(c.kind == "write_reg" for c in self.commands)

    @property
    def n_reads(self) -> int:
        return sum(c.kind == "read_reg" for c in self.commands)


def parse_csb(log: str) -> Trace:
    """VP log -> configuration file (the paper's Python post-processing script)."""
    cmds: List[Command] = []
    for m in _CSB_RE.finditer(log):
        iswrite, addr, data = int(m.group(1)), int(m.group(2), 16), int(m.group(3), 16)
        if iswrite:
            cmds.append(Command("write_reg", addr, data))
        else:
            cmds.append(Command("read_reg", addr, data))
    return Trace(cmds)


def parse_dbb(log: str) -> List[DbbTxn]:
    """VP log -> DBB transaction list (input to weight extraction)."""
    txns: List[DbbTxn] = []
    for m in _DBB_RE.finditer(log):
        iswrite, addr = int(m.group(1)), int(m.group(2), 16)
        data = bytes.fromhex(m.group(4))
        txns.append(DbbTxn(iswrite=iswrite, addr=addr, data=data))
    return txns
