"""Virtual platform (paper Fig. 3): execute a Loadable, log every interface

The port's own copy of ``repro.core.vp``: ``repro_torch`` imports nothing
of ``repro``.  Only the int8 (nv_small) datapath is ported; the bf16
(nv_full) datapath raises ``NotImplementedError`` until its slice lands.
transaction.

The real flow runs the NVDLA compiler's output on a QEMU+SystemC co-simulation and
captures the CSB (register) and DBB (data backbone) adaptors' logs.  Our VP is the
functional twin: it executes each descriptor with the numpy reference ops
(core/refops.py) while emitting log lines in the same shape the paper's scripts
parse:

    <t> ns: nvdla.csb_adaptor: iswrite=1 addr=0x00005008 data=0x00100040
    <t> ns: nvdla.dbb_adaptor: iswrite=0 addr=0x00100040 len=64 data=00ab12...

From this log, ``core/tracegen.py`` produces the bare-metal configuration file and
``core/memory.extract_weights`` reconstructs the preloaded weight image — i.e. the
entire bare-metal artifact is derived from the log alone, as in the paper.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import engine, memory, quant, refops
from repro_torch.core.loadable import Loadable


@dataclasses.dataclass
class VpResult:
    log: str                      # full transaction log
    output_int8: np.ndarray       # raw engine output (int8 / bf16 bytes)
    output: np.ndarray            # dequantised float output
    n_csb_writes: int
    n_csb_reads: int
    dbb_bytes: int


class VirtualPlatform:
    """Functional co-simulation of the SoC (µRISC-V + engine + DRAM)."""

    def __init__(self, loadable: Loadable, beat_bytes: int = 4096,
                 log_weight_refetch: bool = False):
        self.ld = loadable
        self.beat = beat_bytes
        self.refetch = log_weight_refetch
        self._lines: List[str] = []
        self._t = 0
        # DRAM model: flat byte array covering the arena
        self.dram = np.zeros(loadable.plan.arena_size, np.uint8)
        img = loadable.dram_image
        self.dram[:img.size] = img

    # ---- bus-level helpers --------------------------------------------------
    def _tick(self, n: int = 1):
        self._t += n

    def _csb_write(self, addr: int, data: int):
        self._lines.append(
            f"{self._t} ns: nvdla.csb_adaptor: iswrite=1 addr={addr:#010x} data={data & 0xFFFFFFFF:#010x}")
        self._tick(4)

    def _csb_read(self, addr: int, data: int):
        self._lines.append(
            f"{self._t} ns: nvdla.csb_adaptor: iswrite=0 addr={addr:#010x} data={data & 0xFFFFFFFF:#010x}")
        self._tick(4)

    def _dbb(self, iswrite: int, addr: int, buf: bytes):
        """Log one burst as beat-sized transactions."""
        for off in range(0, len(buf), self.beat):
            chunk = buf[off:off + self.beat]
            self._lines.append(
                f"{self._t} ns: nvdla.dbb_adaptor: iswrite={iswrite} "
                f"addr={addr + off:#010x} len={len(chunk)} data={chunk.hex()}")
            self._tick(len(chunk) // 8 + 1)

    def _read_dram(self, addr: int, size: int, log: bool = True) -> bytes:
        off = addr - engine.DRAM_BASE
        buf = self.dram[off:off + size].tobytes()
        if log:
            self._dbb(0, addr, buf)
        return buf

    def _write_dram(self, addr: int, buf: bytes, log: bool = True):
        off = addr - engine.DRAM_BASE
        self.dram[off:off + len(buf)] = np.frombuffer(buf, np.uint8)
        if log:
            self._dbb(1, addr, buf)

    # ---- execution ----------------------------------------------------------
    def run(self, x: np.ndarray) -> VpResult:
        """Execute one inference.  ``x``: float32 (C,H,W) input image."""
        ld = self.ld
        if ld.cfg.dtype != "int8":
            raise NotImplementedError("nv_full is ported in a later slice")
        in_bytes = quant.quantize_act(x, ld.input_scale).tobytes()
        # Host (Zynq in the paper) preloads the input image — logged as DBB writes
        # so weight extraction sees the input surface as preloaded data.
        self._write_dram(ld.input_surface.addr, in_bytes)

        for d, lname in zip(ld.descriptors, ld.desc_layers):
            for addr, val in d.to_reg_writes():
                self._csb_write(addr, val)
            self._execute_int8(d)
            self._csb_read(engine.reg_addr(d.unit, "STATUS"), engine.DONE)

        out_sf = ld.output_surface
        raw = self._read_dram(out_sf.addr, out_sf.size, log=False)
        out_i8 = np.frombuffer(raw, np.int8).copy()
        n = int(np.prod(ld.graph.by_name()[ld.graph.output].out_shape))
        out_i8 = out_i8[:n]
        out = out_i8.astype(np.float32) * ld.output_scale
        log = "\n".join(self._lines)
        nw = sum("csb_adaptor: iswrite=1" in l for l in self._lines)
        nr = sum("csb_adaptor: iswrite=0" in l for l in self._lines)
        dbb_b = sum(int(l.split("len=")[1].split(" ")[0])
                    for l in self._lines if "dbb_adaptor" in l)
        return VpResult(log=log, output_int8=out_i8, output=out,
                        n_csb_writes=nw, n_csb_reads=nr, dbb_bytes=dbb_b)

    # -- engine functional model ---------------------------------------------
    def _surface_i8(self, addr: int, dims: tuple) -> np.ndarray:
        n, c, h, w = dims
        raw = self._read_dram(addr, c * h * w, log=True)
        return np.frombuffer(raw, np.int8).reshape(c, h, w)

    def _execute_int8(self, d: engine.Descriptor):
        _, c, h, w = d.src_dims
        _, k, p, q = d.dst_dims
        if d.unit in ("CONV", "FC"):
            r, s = d.kernel
            cin_g = c // d.groups if d.unit == "CONV" else c * h * w
            wt_elems = (k * cin_g * r * s) if d.unit == "CONV" else k * cin_g
            n_tiles = 1
            if self.refetch:
                n_tiles = max(1, -(-wt_elems // (self.ld.cfg.conv_buf_kib * 1024)))
            for _ in range(n_tiles):   # CDMA refetches weights per output tile
                wraw = self._read_dram(d.wt_addr, wt_elems)
            wq = np.frombuffer(wraw, np.int8).reshape(k, -1)
            braw = self._read_dram(d.bias_addr, k * 4)
            bias = np.frombuffer(braw, np.int32)
            sraw = self._read_dram(d.scale_addr, k * 4)
            words = np.frombuffer(sraw, np.uint32)
            x = self._surface_i8(d.src_addr, d.src_dims)
            if d.unit == "CONV":
                y = refops.conv_int8(x, wq.reshape(k, cin_g, r, s).reshape(k, -1),
                                     bias, words, r, d.stride, d.pad, d.groups, d.relu)
            else:
                y = refops.fc_int8(x, wq, bias, words, d.relu)
            self._write_dram(d.dst_addr, y.tobytes())
        elif d.unit == "PDP":
            x = self._surface_i8(d.src_addr, d.src_dims)
            r, s = d.kernel
            if d.pool_mode == 1:
                y = refops.maxpool_int8(x, r, d.stride, d.pad)
            else:
                word = engine._pack_scale(d.out_scale)
                if (r, s) == (h, w) and d.pad == 0:
                    y = refops.gap_int8(x, word)
                else:
                    y = refops.avgpool_int8(x, r, d.stride, d.pad, word)
            self._write_dram(d.dst_addr, y.tobytes())
        elif d.unit == "EW":
            a = self._surface_i8(d.src_addr, d.src_dims)
            b = self._surface_i8(d.aux_addr, d.src_dims)
            y = refops.add_int8(a, b, engine._pack_scale(d.out_scale),
                                engine._pack_scale(d.aux_scale), d.relu)
            self._write_dram(d.dst_addr, y.tobytes())
        else:
            raise ValueError(d.unit)

