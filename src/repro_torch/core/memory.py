"""Static memory planning + weight extraction (paper §IV-B3).

The port's own copy of ``repro.core.memory`` (byte-for-byte the same
behaviour): ``repro_torch`` imports nothing of ``repro``.

Two pieces:

1. ``ArenaPlanner`` — assigns every weight / bias / scale-table / activation surface a
   static DRAM address before execution (the paper preloads DRAM with a fixed-layout
   weight + input image).  Weights are packed once; activations are placed with a
   liveness-interval first-fit so surfaces whose lifetimes do not overlap share
   memory — the static analogue of malloc that makes the runtime allocation-free.

2. ``extract_weights`` — the paper's weight-file flow: filter DBB transactions, keep
   read transactions (memory fetches == weights), and delete duplicate address
   entries by *retaining the first occurrence*.  Returns the flat weight image.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Tuple

import numpy as np

from repro_torch.core import engine
from repro_torch.core.graph import NetGraph

ALIGN = 64  # DBB beat alignment


def _align(x: int, a: int = ALIGN) -> int:
    return (x + a - 1) & ~(a - 1)


@dataclasses.dataclass
class Surface:
    """One named region of the DRAM arena."""
    name: str
    addr: int          # absolute DRAM address
    size: int          # bytes
    kind: str          # "weight" | "bias" | "scale" | "act" | "input" | "output"


@dataclasses.dataclass
class ArenaPlan:
    surfaces: Dict[str, Surface]
    weight_end: int    # absolute address: end of the static (preloaded) region
    total_end: int     # absolute address: end of the whole arena

    @property
    def arena_size(self) -> int:
        return self.total_end - engine.DRAM_BASE

    def offset(self, name: str) -> int:
        """Offset of a surface inside the flat arena buffer."""
        return self.surfaces[name].addr - engine.DRAM_BASE


def plan_arena(graph: NetGraph, elem_bytes: int, acc_bytes: int = 4) -> ArenaPlan:
    """Assign static addresses for all surfaces of ``graph``.

    Layout (matching the paper's DRAM map, base 0x100000):
      [weights | biases | scale tables]  -- preloaded, immutable
      [activation region]               -- liveness-planned, reused across layers

    ``concat`` layers are handled the NVDLA way: the planner lays the branch outputs
    out adjacently so concatenation is free (pure addressing).
    """
    by = graph.by_name()
    surfaces: Dict[str, Surface] = {}
    cursor = engine.DRAM_BASE

    # ---- static region: weights, biases, per-channel scale tables ----------
    params = graph.init_params(0)
    for lname in (l.name for l in graph.layers if l.name in params):
        l = by[lname]
        p = params[lname]
        wsize = _align(int(p["w"].size))            # int8: 1 byte/elem
        if elem_bytes == 2:
            wsize = _align(int(p["w"].size) * 2)    # bf16 path
        surfaces[f"{lname}.w"] = Surface(f"{lname}.w", cursor, wsize, "weight")
        cursor += wsize
        bsize = _align(int(p["b"].size) * acc_bytes)  # int32/fp32 bias
        surfaces[f"{lname}.b"] = Surface(f"{lname}.b", cursor, bsize, "bias")
        cursor += bsize
        ssize = _align(l.out_channels * 4)          # per-channel (m:int24, s:int8)
        surfaces[f"{lname}.s"] = Surface(f"{lname}.s", cursor, ssize, "scale")
        cursor += ssize
    weight_end = cursor

    # ---- activation region: liveness-interval first-fit --------------------
    # Last use index of each layer output.
    order = {l.name: i for i, l in enumerate(graph.layers)}
    last_use = {l.name: order[l.name] for l in graph.layers}
    for l in graph.layers:
        for inp in l.inputs:
            last_use[inp] = max(last_use[inp], order[l.name])

    # concat members must be placed adjacently inside their concat surface;
    # force them to share the concat's lifetime and skip separate placement.
    concat_member: Dict[str, Tuple[str, int]] = {}
    for l in graph.layers:
        if l.type == "concat":
            off = 0
            for inp in l.inputs:
                member_bytes = int(np.prod(by[inp].out_shape)) * elem_bytes
                concat_member[inp] = (l.name, off)
                off += member_bytes
                last_use[l.name] = max(last_use[l.name], last_use[inp])

    live: List[Tuple[int, int, int]] = []   # (addr, size, free_at_index)
    act_base = weight_end

    def place(size: int, born: int, dies: int) -> int:
        # free expired (strictly-dead-before-birth)
        nonlocal live
        live = [s for s in live if s[2] >= born]
        # first-fit among gaps
        taken = sorted((a, a + s) for a, s, _ in live)
        prev = act_base
        for a, b in taken:
            if a - prev >= size:
                break
            prev = max(prev, b)
        addr = prev
        live.append((addr, size, dies))
        return addr

    # Build the placement worklist: every surface gets (birth, death).  A concat
    # surface is born when its FIRST member is produced (members write straight
    # into it), so it must be placed at that point in liveness order.
    worklist: List[Tuple[int, int, str, int]] = []   # (birth, death, name, size)
    for l in graph.layers:
        if l.type == "input" or l.name in concat_member:
            continue
        size = _align(int(np.prod(l.out_shape)) * elem_bytes)
        if l.type == "concat":
            birth = min(order[i] for i in l.inputs)
        else:
            birth = order[l.name]
        worklist.append((birth, last_use[l.name], l.name, size))

    peak = act_base
    for birth, death, name, size in sorted(worklist):
        addr = place(size, birth, death)
        surfaces[name] = Surface(name, addr, size, "act")
        peak = max(peak, addr + size)

    # concat members alias into the concat surface (resolved after concat placement)
    for inp, (cat, off) in concat_member.items():
        base = surfaces[cat].addr
        size = int(np.prod(by[inp].out_shape)) * elem_bytes
        surfaces[inp] = Surface(inp, base + off, size, "act")

    # graph input gets its own pinned surface at the very end of the static region
    in_size = _align(int(np.prod(graph.input_shape)) * elem_bytes)
    surfaces["data"] = Surface("data", _align(peak), in_size, "input")
    total_end = _align(peak) + in_size

    if total_end - engine.DRAM_BASE > engine.DRAM_SIZE:
        raise MemoryError(f"arena {total_end - engine.DRAM_BASE} exceeds 512MB DRAM window")
    return ArenaPlan(surfaces=surfaces, weight_end=weight_end, total_end=total_end)


# ---------------------------------------------------------------------------
# Weight extraction from the DBB transaction log (paper §IV-B3)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DbbTxn:
    iswrite: int
    addr: int
    data: bytes


def extract_weights(txns: Iterable[DbbTxn]) -> Dict[int, bytes]:
    """Paper §IV-B3: reads (iswrite=0) are weight fetches; duplicates are deleted
    by retaining the FIRST occurrence (the original weights).

    Refinement over the paper's wording: a read of an address the engine itself
    wrote earlier in the run is an *activation* fetch, not preloaded data, so it
    is excluded (the paper's traces behave the same way because NVDLA reads
    weights before producing any output surface at the same address).
    """
    image: Dict[int, bytes] = {}
    written: set = set()
    for t in txns:
        if t.iswrite:
            written.add(t.addr)
        elif t.addr not in image and t.addr not in written:
            image[t.addr] = t.data        # first occurrence wins
    return image


def flatten_image(image: Dict[int, bytes], base: int) -> Tuple[np.ndarray, int]:
    """Pack a sparse {addr: bytes} image into a flat byte array from ``base``.

    Returns (buffer, size).  Gaps are zero-filled (uninitialised DRAM).
    """
    if not image:
        return np.zeros(0, np.uint8), 0
    end = max(a + len(b) for a, b in image.items())
    buf = np.zeros(end - base, np.uint8)
    for a, b in image.items():
        buf[a - base: a - base + len(b)] = np.frombuffer(b, np.uint8)
    return buf, end - base
