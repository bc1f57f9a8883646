"""Bare-metal executor in torch: replay a bundle's descriptors on the card.

``BareMetalExecutor`` consumes ONLY the two bare-metal artifacts, the
configuration trace and the extracted weight image, as the paper's uRISC-V
binary does.  It decodes the register stream back into engine descriptors
and replays them over one flat DRAM arena that stays on the device:

  * the immutable weight, bias and scale tables are sliced out of the arena
    once, when the executor is built, and stay on the device as contiguous
    tensors (int8 weights and int32 tables on nv_small, bfloat16 weights and
    float32 biases on nv_full);
  * the activation region of the arena is resident per bucket size, one row
    of bytes per lane, and ops write their outputs into it in place (a bf16
    surface is a 2-byte-per-element view of those bytes);
  * every CONV/FC runs through ``kernels/int8_conv`` (nv_small) or
    ``kernels/bf16_conv`` (nv_full): the hand-written CUDA kernel on a card,
    its plain version on the CPU, with the lanes of a batch folded onto the
    GEMM N axis, so one launch serves the bucket;
  * PDP (pooling) and EW (residual add) are plain torch ops.

Execution is eager: no program is built per batch shape, so
``compile_count`` stays 0.  (The reference counts XLA compiles there; CUDA
graph captures will count once the port has them.)

bf16 bytes.  The input is encoded on the host by the port's codec
(``core/bf16.py``), byte-equal to the reference's ``ml_dtypes``.  On the
card, every op rounds its float32 result to bfloat16 in the kernel
(``__float2bfloat16_rn``) or through ``.to(torch.bfloat16)``: both round to
nearest even, as the reference does, but a NaN comes out as torch's
``0xFFFF`` (or the kernel's NaN) where ``ml_dtypes`` writes ``0x7FC0``.  The
reference's ``Session`` does not reject NaN inputs, and neither does the
port, so NaN bits may differ on the device path; every finite value rounds
the same.

Port of ``repro.core.executor`` (``_ExecutorBase``, ``BareMetalExecutor`` and
the int8 and bf16 op twins).  The single-image and batch paths are one
replay: a single image is a bucket of one lane.
"""

from __future__ import annotations

import dataclasses
import time
import zlib
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import bf16, engine, intmath, perfmodel, quant
from repro_torch.core.tracegen import Trace
from repro_torch.kernels.bf16_conv import ops as bf16_ops
from repro_torch.kernels.int8_conv import ops as int8_ops


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for ``cpu``.  Raises when a card is asked for and none is present —
    nothing ever carries on on the CPU in its place."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} asked for but no CUDA device is "
                f"available; pass device='cpu' to run the plain versions on "
                f"the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}: the port runs "
                         f"on 'cuda' or 'cpu'")
    return dev


# ---------------------------------------------------------------------------
# int8 op twins, batch-first: every tensor carries a leading lane axis
# ---------------------------------------------------------------------------
def _pool_int8(xs, kern, stride, pad, mode, mps):
    """PDP over (B, C, H, W) int8: max (mode 1) or average with the
    fixed-point rescale ``mps`` = (m, pre, post) int32 device tensor."""
    h, w = xs.shape[-2:]
    r, s = kern
    p = (h + 2 * pad - r) // stride + 1
    q = (w + 2 * pad - s) // stride + 1
    if mode == 1:
        xp = F.pad(xs, (pad, pad, pad, pad), value=-128) if pad else xs
        out = None
        for win in intmath.windows(xp, r, s, stride, p, q):
            out = win if out is None else torch.maximum(out, win)
        return out
    xp = F.pad(xs, (pad, pad, pad, pad)) if pad else xs
    acc = sum(win.to(torch.int64)
              for win in intmath.windows(xp, r, s, stride, p, q))
    return intmath.clip8(intmath.apply_scale(intmath.wrap32(acc), mps[0],
                                             mps[1], mps[2]))


def _add_int8(a, b, mps_a, mps_b, relu):
    acc = intmath.wrap32(
        intmath.apply_scale(a, mps_a[0], mps_a[1], mps_a[2]).to(torch.int64)
        + intmath.apply_scale(b, mps_b[0], mps_b[1], mps_b[2]))
    if relu:
        acc = acc.clamp(min=0)
    return intmath.clip8(acc)


# ---------------------------------------------------------------------------
# bf16 op twins (nv_full), batch-first: float32 arithmetic, one rounding to
# bfloat16 at the end, in the reference executor's order
# ---------------------------------------------------------------------------
def _pool_bf16(xs, kern, stride, pad, mode):
    """PDP over (B, C, H, W) bf16 in float: max with -inf fill, average as
    the f32 sum of the windows in order, divided by the window size (the
    executor's GAP is this average over the whole surface, as in the
    reference executor; the VP and ``ref`` take the mean instead)."""
    x32 = xs.to(torch.float32)
    h, w = xs.shape[-2:]
    r, s = kern
    p = (h + 2 * pad - r) // stride + 1
    q = (w + 2 * pad - s) // stride + 1
    if mode == 1:
        xp = F.pad(x32, (pad, pad, pad, pad), value=-float("inf")) if pad \
            else x32
        out = None
        for win in intmath.windows(xp, r, s, stride, p, q):
            out = win if out is None else torch.maximum(out, win)
        return out.to(torch.bfloat16)
    xp = F.pad(x32, (pad, pad, pad, pad)) if pad else x32
    acc = None
    for win in intmath.windows(xp, r, s, stride, p, q):
        acc = torch.zeros_like(win) + win if acc is None else acc + win
    return (acc / (r * s)).to(torch.bfloat16)


def _add_bf16(a, b, relu):
    acc = a.to(torch.float32) + b.to(torch.float32)
    if relu:
        acc = acc.clamp(min=0.0)
    return acc.to(torch.bfloat16)


# ---------------------------------------------------------------------------
# Descriptor -> op over the resident arena
# ---------------------------------------------------------------------------
def _surface_bytes(dims, elem_bytes: int = 1) -> int:
    """Bytes of an (N, C, H, W) surface of one lane."""
    n, c, h, w = dims
    return c * h * w * elem_bytes


def _overlaps(a: tuple, b: tuple) -> bool:
    return a[0] < b[0] + b[1] and b[0] < a[0] + a[1]


def _batch_plan(descs, input_region: tuple, elem_bytes: int = 1):
    """Dataflow analysis of the replay (as in the reference).

    ``fwd[i]``: op ``i`` reads exactly the previous producer's destination
    (the previous op, or the input surface for op 0), so the value is passed
    tensor to tensor instead of read back from the arena.  ``store[i]``: some
    *other* later read overlaps op ``i``'s destination (concat consumers, EW
    residuals, partial reads), so the value must also be stored.  Forwarding
    changes only where bytes are read from, never their values.
    """
    n = len(descs)
    src_r = [(d.src_addr, _surface_bytes(d.src_dims, elem_bytes))
             for d in descs]
    dst_r = [(d.dst_addr, _surface_bytes(d.dst_dims, elem_bytes))
             for d in descs]
    aux_r = [(d.aux_addr, _surface_bytes(d.src_dims, elem_bytes))
             if d.unit == "EW" else None for d in descs]
    fwd = [src_r[i] == (dst_r[i - 1] if i else input_region) for i in range(n)]

    def store_needed(region: tuple, producer: int) -> bool:
        for j in range(producer + 1, n):
            if _overlaps(region, src_r[j]) and not (j == producer + 1 and fwd[j]):
                return True
            if aux_r[j] is not None and _overlaps(region, aux_r[j]):
                return True
        return False

    store = [store_needed(dst_r[i], i) for i in range(n - 1)]
    store.append(False)          # final output is forwarded out of the replay
    store_input = store_needed(input_region, -1)
    return fwd, store, store_input


def _table(arena0: np.ndarray, off: int, n: int, dtype, device) -> torch.Tensor:
    """Copy ``n`` values of numpy ``dtype`` out of the byte arena (the slice
    may be unaligned, so it is copied, never reinterpreted in place)."""
    raw = np.frombuffer(arena0[off:off + np.dtype(dtype).itemsize * n]
                        .tobytes(), dtype)
    return torch.from_numpy(raw.copy()).to(device)


def _op_from_descriptor(d: engine.Descriptor, base: int, act_lo: int,
                        fwd: bool, store: bool, arena0: np.ndarray, device):
    """Build f(act, y_prev) -> y for one int8 descriptor over a bucket.

    ``act`` (B, act_bytes) int8 is the per-lane activation arena and
    ``y_prev`` (B, bytes) the previous op's output; ``y`` is this op's output
    (B, bytes), also written into ``act`` when ``store``.
    """
    _, c, h, w = d.src_dims
    _, k, p, q = d.dst_dims
    so = d.src_addr - base - act_lo
    do = d.dst_addr - base - act_lo
    s_sz = _surface_bytes(d.src_dims)

    def read_src(act, y_prev):
        if fwd:
            return y_prev.reshape(-1, c, h, w)
        return act[:, so:so + s_sz].reshape(-1, c, h, w)

    def finish(act, y):
        y = y.reshape(y.shape[0], -1)
        if store:
            act[:, do:do + y.shape[1]] = y
        return y

    if d.unit in ("CONV", "FC"):
        r, s = d.kernel
        cin_g = c // d.groups if d.unit == "CONV" else c * h * w
        wt_n = k * cin_g * (r * s if d.unit == "CONV" else 1)
        wo = d.wt_addr - base
        wq = _table(arena0, wo, wt_n, np.int8, device).reshape(k, -1)
        bias = _table(arena0, d.bias_addr - base, k, np.int32, device)
        words = _table(arena0, d.scale_addr - base, k, np.int32, device)

        if d.unit == "CONV":
            def op(act, y_prev):
                y = int8_ops.conv2d_int8_batch(read_src(act, y_prev), wq, bias,
                                               words, r, d.stride, d.pad,
                                               d.groups, d.relu)
                return finish(act, y)
        else:
            def op(act, y_prev):
                xs = read_src(act, y_prev)
                y = int8_ops.fc_int8_batch(xs.reshape(xs.shape[0], -1), wq,
                                           bias, words, d.relu)
                return finish(act, y)
    elif d.unit == "PDP":
        mps = torch.tensor(quant.unpack_scale(engine._pack_scale(d.out_scale)),
                           dtype=torch.int32, device=device)

        def op(act, y_prev):
            y = _pool_int8(read_src(act, y_prev), d.kernel, d.stride, d.pad,
                           d.pool_mode, mps)
            return finish(act, y)
    elif d.unit == "EW":
        ao = d.aux_addr - base - act_lo
        mps_a = torch.tensor(quant.unpack_scale(engine._pack_scale(d.out_scale)),
                             dtype=torch.int32, device=device)
        mps_b = torch.tensor(quant.unpack_scale(engine._pack_scale(d.aux_scale)),
                             dtype=torch.int32, device=device)

        def op(act, y_prev):
            a = read_src(act, y_prev)
            b = act[:, ao:ao + s_sz].reshape(-1, c, h, w)
            return finish(act, _add_int8(a, b, mps_a, mps_b, d.relu))
    else:
        raise ValueError(d.unit)
    return op


def _op_from_descriptor_bf16(d: engine.Descriptor, base: int, act_lo: int,
                             fwd: bool, store: bool, arena0: np.ndarray,
                             device):
    """bf16 twin of ``_op_from_descriptor``: f(act, y_prev) -> y.

    ``act`` stays the per-lane activation arena of raw bytes (B, act_bytes)
    int8, and ``y``/``y_prev`` carry raw bf16 bytes (B, bytes) int8, so both
    datapaths share one replay loop.  A surface is read as a bfloat16 view
    of its bytes: surfaces are 64-byte aligned, so the offset and the row
    width are even (checked when the executor is built).
    """
    _, c, h, w = d.src_dims
    _, k, p, q = d.dst_dims
    so = d.src_addr - base - act_lo
    do = d.dst_addr - base - act_lo
    s_bytes = _surface_bytes(d.src_dims, 2)

    def read_src(act, y_prev):
        raw = y_prev if fwd else act[:, so:so + s_bytes]
        return raw.view(torch.bfloat16).reshape(-1, c, h, w)

    def finish(act, y):
        y = y.reshape(y.shape[0], -1).contiguous().view(torch.int8)
        if store:
            act[:, do:do + y.shape[1]] = y
        return y

    if d.unit in ("CONV", "FC"):
        r, s = d.kernel
        cin_g = c // d.groups if d.unit == "CONV" else c * h * w
        wt_n = k * cin_g * (r * s if d.unit == "CONV" else 1)
        wq = _table(arena0, d.wt_addr - base, wt_n, np.int16, device) \
            .view(torch.bfloat16).reshape(k, -1)
        bias = _table(arena0, d.bias_addr - base, k, np.float32, device)

        if d.unit == "CONV":
            def op(act, y_prev):
                y = bf16_ops.conv2d_bf16_batch(read_src(act, y_prev), wq, bias,
                                               r, d.stride, d.pad, d.groups,
                                               d.relu)
                return finish(act, y)
        else:
            def op(act, y_prev):
                xs = read_src(act, y_prev)
                y = bf16_ops.fc_bf16_batch(xs.reshape(xs.shape[0], -1), wq,
                                           bias, d.relu)
                return finish(act, y)
    elif d.unit == "PDP":
        def op(act, y_prev):
            return finish(act, _pool_bf16(read_src(act, y_prev), d.kernel,
                                          d.stride, d.pad, d.pool_mode))
    elif d.unit == "EW":
        ao = d.aux_addr - base - act_lo

        def op(act, y_prev):
            a = read_src(act, y_prev)
            b = act[:, ao:ao + s_bytes].view(torch.bfloat16).reshape(-1, c, h, w)
            return finish(act, _add_bf16(a, b, d.relu))
    else:
        raise ValueError(d.unit)
    return op


# ---------------------------------------------------------------------------
# Executors
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ExecResult:
    output_int8: np.ndarray     # raw int8 engine output
    output: np.ndarray          # dequantised float32


@dataclasses.dataclass(frozen=True)
class ExecutorCapabilities:
    """What a backend can do (the reference's fields that apply so far).

    ``native_batching`` — ``run_batch`` executes the whole batch as one replay.
    ``resident_arena``  — keeps device state across calls (``reset_arena``).
    ``kernels``         — the GEMM kernels serving this backend's CONV/FC.
    ``profileable``     — ``run_profiled`` times each descriptor.
    """
    native_batching: bool = False
    resident_arena: bool = False
    dtype: str = "int8"
    kernels: tuple = ()
    profileable: bool = False


class _ExecutorBase:
    """Common decode/bind logic from the two bare-metal artifacts."""

    def __init__(self, trace: Trace, weight_image: Dict[int, bytes],
                 cfg: engine.EngineConfig = engine.NV_SMALL,
                 input_scale: float = 1.0, output_scale: float = 1.0,
                 output_elems: Optional[int] = None):
        if cfg.dtype not in ("int8", "bf16"):
            known = ", ".join(f"{n} (dtype={c.dtype})"
                              for n, c in engine.CONFIGS.items())
            raise NotImplementedError(
                f"executor backends implement the int8 (nv_small) and bf16 "
                f"(nv_full) datapaths; engine config {cfg.name!r} declares "
                f"dtype={cfg.dtype!r}.  Known engine configs: {known}")
        self.cfg = cfg
        self.trace = trace
        self.input_scale = input_scale
        self.output_scale = output_scale
        self.descs = engine.decode_descriptors(trace.commands)
        if not self.descs:
            raise ValueError("trace contains no engine ops")
        # eager execution builds no per-shape program (see module docstring)
        self.compile_count = 0
        # Arena geometry, derived from the trace alone.  All addresses are
        # byte addresses; surfaces take elem_bytes per element (1 for int8,
        # 2 for bf16, as core/memory.plan_arena lays them out).
        eb = cfg.elem_bytes
        hi = engine.DRAM_BASE
        for d in self.descs:
            hi = max(hi, d.dst_addr + _surface_bytes(d.dst_dims, eb),
                     d.src_addr + _surface_bytes(d.src_dims, eb))
        for a, b in weight_image.items():
            hi = max(hi, a + len(b))
        self.base = engine.DRAM_BASE
        self.size = hi - self.base
        # Preloaded image: weights + (sample) input, as extracted from the VP log.
        arena0 = np.zeros(self.size, np.uint8)
        for a, b in weight_image.items():
            arena0[a - self.base:a - self.base + len(b)] = np.frombuffer(b, np.uint8)
        self.arena0 = arena0
        # Integrity anchor: the CRC of the preload regions at load time
        # defines "arena intact"; ``reset_arena`` restores them in place.
        self._preload = sorted(
            ((a - self.base, np.frombuffer(b, np.uint8))
             for a, b in weight_image.items()), key=lambda t: t[0])
        self._weight_crc0 = self.weight_checksum()
        # I/O surfaces: input = first op's source; output = last op's dest.
        self.input_off = self.descs[0].src_addr - self.base
        self.input_dims = self.descs[0].src_dims
        self.output_off = self.descs[-1].dst_addr - self.base
        self.output_dims = self.descs[-1].dst_dims
        self.output_elems = output_elems or \
            _surface_bytes(self.output_dims)          # ELEMENT count
        self.output_bytes = self.output_elems * eb    # arena-slice length

    def _quant_in(self, x: np.ndarray) -> np.ndarray:
        """Input image -> the engine's surface encoding: int8 (an int8 input
        passes through) or bfloat16 bit patterns (uint16, the port's codec)."""
        x = np.asarray(x)
        if self.cfg.dtype == "int8":
            if x.dtype == np.int8:
                return x
            return quant.quantize_act(x, self.input_scale)
        return bf16.f32_to_bf16_bits(x)

    def _finish_out(self, y_bytes: np.ndarray) -> ExecResult:
        """Raw output-surface bytes (last axis = ``output_bytes``) ->
        ``ExecResult``.  ``output_int8`` carries the raw engine bytes: int8
        logits for nv_small, the bf16 byte stream (uint8) for nv_full (as
        ``VpResult`` has them); ``output`` is always float32."""
        if self.cfg.dtype == "int8":
            y_i8 = y_bytes.view(np.int8)
            return ExecResult(output_int8=y_i8,
                              output=y_i8.astype(np.float32) * self.output_scale)
        y_u8 = np.ascontiguousarray(y_bytes).view(np.uint8)
        out = bf16.bf16_bits_to_f32(y_u8.view(np.uint16)) * self.output_scale
        return ExecResult(output_int8=y_u8, output=out)

    # -- arena integrity -----------------------------------------------------
    def weight_checksum(self) -> int:
        """CRC32 over the preload regions of ``arena0`` as they are NOW."""
        crc = 0
        for off, b in self._preload:
            crc = zlib.crc32(self.arena0[off:off + b.size], crc)
        return crc

    def arena_ok(self) -> bool:
        """True when the preload regions still carry their load-time bytes."""
        return self.weight_checksum() == self._weight_crc0

    def reset_arena(self) -> None:
        """Restore the pristine preload bytes in place and drop every
        device-resident copy, so the next run rebuilds from a known-good
        arena."""
        for off, b in self._preload:
            self.arena0[off:off + b.size] = b
        self._drop_device_state()

    def _drop_device_state(self) -> None:
        """Invalidate device-resident state (no-op for host-only backends)."""

    def capabilities(self) -> ExecutorCapabilities:
        return ExecutorCapabilities(dtype=self.cfg.dtype)

    def run_batch(self, X: np.ndarray,
                  lanes: Optional[int] = None) -> ExecResult:
        """Batched inference, default: sequential runs of the first ``lanes``
        rows (the rest are padding), stacked."""
        X = np.asarray(X)
        n = X.shape[0] if lanes is None else lanes
        outs = [self.run(x) for x in X[:n]]
        return ExecResult(output_int8=np.stack([o.output_int8 for o in outs]),
                          output=np.stack([o.output for o in outs]))


class BareMetalExecutor(_ExecutorBase):
    """The bundle's descriptors replayed over a device-resident arena."""

    def __init__(self, *args, device="cuda", **kw):
        self.device = resolve_device(device)
        super().__init__(*args, **kw)
        cuda = self.device.type == "cuda"
        int8 = self.cfg.dtype == "int8"
        self.gemm_kernel = {
            (True, True): perfmodel.KERNEL_CUDA_INT8,
            (True, False): perfmodel.KERNEL_TORCH_INT8,
            (False, True): perfmodel.KERNEL_CUDA_BF16,
            (False, False): perfmodel.KERNEL_TORCH_BF16}[(int8, cuda)]
        self._op_builder = (_op_from_descriptor if int8
                            else _op_from_descriptor_bf16)
        self.kernel_plan = [self.gemm_kernel if d.unit in ("CONV", "FC")
                            else perfmodel.KERNEL_VPU for d in self.descs]
        # Only the activation region [act_lo, act_hi) carries a lane axis;
        # the weight tables are shared by every lane.
        eb = self.cfg.elem_bytes
        act_offs = []
        for d in self.descs:
            regions = [(d.src_addr, d.src_dims), (d.dst_addr, d.dst_dims)]
            if d.unit == "EW":
                regions.append((d.aux_addr, d.src_dims))
            act_offs += [(a - self.base, a - self.base + _surface_bytes(dims, eb))
                         for a, dims in regions]
        self._act_lo = min(lo for lo, _ in act_offs)
        self._act_hi = max(hi for _, hi in act_offs)
        if eb == 2 and any((lo - self._act_lo) % 2 or (hi - self._act_lo) % 2
                           for lo, hi in act_offs):
            # a bf16 surface is read as a 2-byte view of the byte arena
            raise ValueError("bf16 surfaces must start and end on even byte "
                             "offsets of the activation region")
        in_region = (self.base + self.input_off,
                     _surface_bytes(self.input_dims, eb))
        self._fwd, self._store, self._store_input = _batch_plan(
            self.descs, in_region, eb)
        self._ops: Optional[list] = None
        self._act: Dict[int, torch.Tensor] = {}   # bucket size -> (B, act)

    def _ensure_ops(self) -> list:
        if self._ops is None:
            self._ops = [self._op_builder(d, self.base, self._act_lo,
                                          self._fwd[i], self._store[i],
                                          self.arena0, self.device)
                         for i, d in enumerate(self.descs)]
        return self._ops

    def _act_state(self, n: int) -> torch.Tensor:
        act = self._act.get(n)
        if act is None:
            row = torch.from_numpy(
                self.arena0[self._act_lo:self._act_hi].view(np.int8).copy())
            act = row.to(self.device).expand(n, -1).contiguous()
            self._act[n] = act
        return act

    def _drop_device_state(self) -> None:
        self._ops = None
        self._act.clear()

    def _stage_input(self, X: np.ndarray):
        """Encode on the host, copy the bytes to the device, seed the arena."""
        xq = self._quant_in(X)
        n = xq.shape[0]
        xs = torch.from_numpy(np.ascontiguousarray(xq).reshape(n, -1)
                              .view(np.int8)).to(self.device)
        act = self._act_state(n)
        if self._store_input:
            lo = self.input_off - self._act_lo
            act[:, lo:lo + xs.shape[1]] = xs
        return act, xs

    def _replay(self, X: np.ndarray) -> np.ndarray:
        act, y = self._stage_input(X)
        for op in self._ensure_ops():
            y = op(act, y)
        return y[:, :self.output_bytes].cpu().numpy()

    def run(self, x: np.ndarray) -> ExecResult:
        """One inference: a bucket of one lane."""
        y = self._replay(np.asarray(x)[None])
        return self._finish_out(y[0])

    def run_batch(self, X: np.ndarray,
                  lanes: Optional[int] = None) -> ExecResult:
        """Run every lane of ``X`` as one replay (byte-exact vs N ``run``
        calls) and return the first ``lanes`` rows (the rest are padding).
        Each CONV/FC is one kernel launch for the whole bucket."""
        y = self._replay(np.asarray(X))
        return self._finish_out(y[:lanes])

    def capabilities(self) -> ExecutorCapabilities:
        return ExecutorCapabilities(native_batching=True, resident_arena=True,
                                    dtype=self.cfg.dtype,
                                    kernels=(self.gemm_kernel,),
                                    profileable=True)

    def run_profiled(self, x: np.ndarray) -> tuple:
        """``(ExecResult, samples)`` with one timing sample per descriptor:
        ``{"index", "unit", "kernel", "bucket", "us"}``.  On a card each op
        is bracketed by CUDA events on its stream, so ``us`` is the stream's
        time for the op: device time, plus any gap the host leaves while it
        launches.  On the CPU it is host time.  Byte-identical to ``run``."""
        cuda = self.device.type == "cuda"
        act, y = self._stage_input(np.asarray(x)[None])
        stream = torch.cuda.current_stream(self.device) if cuda else None
        marks = []
        for op in self._ensure_ops():
            if cuda:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record(stream)
                y = op(act, y)
                e1.record(stream)
                marks.append((e0, e1))
            else:
                t0 = time.perf_counter()
                y = op(act, y)
                marks.append((t0, time.perf_counter()))
        out = y[:, :self.output_bytes].cpu().numpy()
        if cuda:
            torch.cuda.synchronize(self.device)
        samples = []
        for i, ((a, b), d) in enumerate(zip(marks, self.descs)):
            us = a.elapsed_time(b) * 1e3 if cuda else (b - a) * 1e6
            samples.append({"index": i, "unit": d.unit,
                            "kernel": self.kernel_plan[i], "bucket": 1,
                            "us": us})
        return self._finish_out(out[0]), samples
