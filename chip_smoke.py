"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py

Run from the root of a checkout.  It imports ``repro_torch`` from ``src/``
(never JAX, never ``repro``), and every phase raises on failure, so the
script exits non-zero unless all of them pass:

1. card identity: name and power limit from ``nvidia-smi``;
2. build: ``nvcc`` compiles the three kernel sources for sm_90a from the
   checkout, one process each, all started together
   (``kernels/int8_conv/csrc/int8_conv.cu``, ``kernels/bf16_conv/csrc/
   bf16_conv.cu``, ``kernels/int8_gemm/csrc/int8_gemm.cu``);
3. ``int8_conv_gemm`` against its plain version, byte for byte, on the card:
   every distinct CONV/FC GEMM of ResNet-18 (3x32x32, nv_small, full widths)
   with the compiled bundle's own weight/bias/scale tables, single image and
   lane-folded at bucket 8, plus edge cases (all -128 operands, pre = post =
   0, m = -32768, accumulators near +-2^31, ragged N, groups = 2);
4. the nv_small served path: ResNet-18 compiled by the port's
   ``CompilerPipeline`` (random weights from a seed), saved as a bundle,
   served by ``Session.from_bundle`` on cuda: 8 single requests and one
   ``run_batch`` of 5 lanes padded to bucket 8, every output byte-equal to
   the port's numpy ``ref`` backend, with the kernel's launch count equal to
   the CONV/FC descriptors times the passes;
5. ``bf16_conv_gemm`` against its plain version within
   ``tolerances.gemm_tolerance(K)``: the 12 GEMM shapes of ResNet-18 on
   nv_full with the bundle's own bf16 weights and f32 biases, at 1 and 8
   lanes, each lane of the 8-lane launch bit-identical to its own 1-lane
   launch; edge cases (K = 4608 with ragged N = 33, M = 10, groups = 2
   through the wrapper, bias only, magnitudes near 2^100 and 2^-100);
6. ``int8_gemm`` (the W8A8 ``quantized_matmul``) against its plain version,
   byte for byte: the reference's kernel-test shapes, the transposed
   ResNet-18 nv_small GEMMs (M = positions x lanes, N = channels) at 1 and 8
   lanes, also equal to the transposed ``int8_conv_gemm`` result, and the
   int8 edge cases; then its own path, one transposed ResNet-18 pass through
   ``quantized_matmul`` with the launches counted;
7. the nv_full served path: ResNet-18 compiled with ``cfg=NV_FULL``, saved,
   served on cuda: 8 single requests and one ``run_batch`` of 5 lanes padded
   to 8, each output within ``net_tolerance`` of the ``ref`` backend and the
   compile's sample input within it of the VP, every batched lane
   bit-identical to its single request, 21 bf16 launches per pass; then one
   ``Session`` holding the nv_small and the nv_full net, serving alternating
   requests, each checked against its own oracle;
8. times, one JSON line per kernel, GEMM shape and bucket, the whole-net ms
   per image of both datapaths with a profile each, then the ``kernels``
   line and the ``ok`` line.

Every path (nv_small served, nv_full served, the ``quantized_matmul`` pass)
is driven with all launch counts set to 0 just before it and read just after;
launches made to compare a kernel with its plain version are not counted.
Times come from CUDA events over repeated launches after a warm-up; a
kernel's bound is the larger of the bytes it must move over 3.35 TB/s and
its operations over the dense tensor-core rate of its type (1979 TOP/s int8,
989 TFLOP/s bf16): the H100 SXM data-sheet peaks at 700 W.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12           # H100 SXM, data sheet
INT8_OPS_PER_S = 1979e12            # dense int8 tensor-core rate, data sheet
BF16_OPS_PER_S = 989e12             # dense bf16 tensor-core rate, data sheet
SEED = 0
BUCKET = 8


def log(*a):
    print(*a, flush=True)


def card_identity() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False); this script runs only on the card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    return smi.splitlines()[0]


def cuda_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn()`` in ms, from CUDA events over ``reps``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def bound(nbytes: int, ops: int, ops_per_s: float) -> tuple:
    """(bound_ms, bound_by, bytes_ms, ops_ms): the larger of the bytes over
    the memory rate and the operations over the peak rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations",
            t_bytes * 1e3, t_ops * 1e3)


def bound_int8(m: int, k: int, n: int) -> tuple:
    """One fused int8 GEMM: each input read once (both operands, the bias
    and scale words of the M channels), the output written once."""
    return bound(m * k + k * n + 8 * m + m * n, 2 * m * k * n, INT8_OPS_PER_S)


def bound_bf16(m: int, k: int, n: int) -> tuple:
    """One fused bf16 GEMM: bf16 operands, f32 bias, bf16 output."""
    return bound(2 * m * k + 2 * k * n + 4 * m + 2 * m * n, 2 * m * k * n,
                 BF16_OPS_PER_S)


def int_mm_operands(a, b, *tables):
    """Zero-padded copies of int8 ``a`` (M, K), ``b`` (K, N) and the per-row
    tables of ``a @ b`` that ``torch._int_mm`` takes (M >= 24, K and N
    multiples of 8): the operands of the library yardstick, made outside
    its timing."""
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(-(-m // 8) * 8, 24), -(-k // 8) * 8, -(-n // 8) * 8
    ap = torch.zeros((mp, kp), dtype=torch.int8, device=a.device)
    ap[:m, :k] = a
    bp = torch.zeros((kp, np_), dtype=torch.int8, device=a.device)
    bp[:k, :n] = b
    tps = []
    for t in tables:
        tp = torch.zeros(mp, dtype=t.dtype, device=a.device)
        tp[:m] = t
        tps.append(tp)
    return (ap, bp, *tps)


class Totals:
    """Per-kernel sums over one path's GEMMs at batch 1 (the kernels line)."""

    def __init__(self):
        self.ms = self.plain_ms = self.library_ms = 0.0
        self.bound_ms = self.bytes_ms = self.ops_ms = 0.0

    def add(self, ms, plain, lib, b):
        self.ms += ms
        self.plain_ms += plain
        self.library_ms += lib
        self.bound_ms += b[0]
        self.bytes_ms += b[2]
        self.ops_ms += b[3]

    def row(self, name, source, replaces, launches, max_err):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max_err, "ms": self.ms,
                "plain_ms": self.plain_ms, "bound_ms": self.bound_ms,
                "bound_by": ("bytes" if self.bytes_ms >= self.ops_ms
                             else "operations"),
                "library_ms": self.library_ms}


def profile_serving(call, label: str, reps: int = 5) -> dict:
    """Where one served request's time goes: ``torch.profiler`` over
    ``reps`` calls; device-busy time is the sum of the CUDA kernels' and
    copies' self time (one stream, so they do not overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    per_name: dict = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "device_time", None)
        if us is None:
            us = e.cuda_time
        ms, n = per_name.get(e.name, (0.0, 0))
        per_name[e.name] = (ms + us / 1e3 / reps, n + 1)
    busy = sum(ms for ms, _ in per_name.values())
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"phase": "profile", "call": label, "wall_ms": wall_ms,
            "device_busy_ms": busy, "idle_share": 1.0 - busy / wall_ms,
            "device_ops": sum(n for _, n in per_name.values()) / reps,
            "top": [[name[:70], ms, n / reps] for name, (ms, n) in top]}


def net_times(ses, x1, X, label: str) -> None:
    """Whole-net host-clock ms per image at batch 1 and bucket 8, then a
    profile of each."""
    for _ in range(3):
        ses.run(x1)
    torch.cuda.synchronize()
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        ses.run(x1)
    torch.cuda.synchronize()
    net1 = (time.perf_counter() - t0) / reps * 1e3
    ses.run_batch(X)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        ses.run_batch(X)
    torch.cuda.synchronize()
    net8 = (time.perf_counter() - t0) / reps * 1e3
    log(json.dumps({"phase": "net", "net": label, "ms_per_image_batch1": net1,
                    "ms_per_image_bucket8": net8 / BUCKET,
                    "ms_per_batch_bucket8": net8}))
    log(json.dumps(dict(profile_serving(lambda: ses.run(x1), "batch1"),
                        net=label)))
    log(json.dumps(dict(profile_serving(lambda: ses.run_batch(X), "bucket8"),
                        net=label)))


def main() -> None:
    # ---- 1. card identity ------------------------------------------------
    smi = card_identity()
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions need
    torch.backends.cudnn.allow_tf32 = False         # exact float
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    from repro_torch.core import engine, graph, intmath, perfmodel, pipeline
    from repro_torch.core import quant, tolerances
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.bf16_conv import kernel as bf16_kernel
    from repro_torch.kernels.bf16_conv import ops as bf16_ops
    from repro_torch.kernels.bf16_conv import ref as bf16_ref
    from repro_torch.kernels.int8_conv import kernel, ops, ref
    from repro_torch.kernels.int8_gemm import kernel as qm_kernel
    from repro_torch.kernels.int8_gemm import ops as qm_ops
    from repro_torch.kernels.int8_gemm import ref as qm_ref
    from repro_torch.runtime import Session, create_executor

    counters = (ops, bf16_ops, qm_ops)

    def zero_counts():
        for c in counters:
            c.launches = 0

    def counts():
        return tuple(c.launches for c in counters)

    # ---- 2. build (one nvcc per source, all started together) -------------
    libs = (kernel.LIB, bf16_kernel.LIB, qm_kernel.LIB)
    t0 = time.perf_counter()
    cuda_lib.build_all(libs)
    for lib in libs:
        lib.fn()
    log(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0,
                    "libraries": [{
                        "library": lib.library_path().name,
                        "seconds": lib.build_seconds,
                        "ptxas": [l.strip() for l in lib.build_log.splitlines()
                                  if "registers" in l or "spill" in l]}
                        for lib in libs]}))

    # ---- compile ResNet-18 on both datapaths (port's own compiler) --------
    t0 = time.perf_counter()
    g = graph.resnet18()
    art = pipeline.CompilerPipeline(g, seed=SEED).run()
    art_f = pipeline.CompilerPipeline(g, seed=SEED, cfg=engine.NV_FULL).run()
    log(json.dumps({"phase": "compile", "net": g.name,
                    "seconds": time.perf_counter() - t0,
                    "weight_image_bytes": {
                        a.cfg.name: sum(len(b) for b in a.weight_image.values())
                        for a in (art, art_f)}}))
    bm = create_executor("baremetal", art, device=dev)
    bm_f = create_executor("baremetal", art_f, device=dev)
    gemm_descs = [i for i, d in enumerate(bm.descs) if d.unit in ("CONV", "FC")]
    rng = np.random.default_rng(SEED)
    max_err = 0

    def held(w, cols, bias, words, relu, what):
        """Kernel (through its wrapper) vs plain version on the card, byte
        for byte."""
        nonlocal max_err
        got = ops.gemm(w, cols, bias, words, relu)
        torch.cuda.synchronize()
        want = ref.int8_conv_gemm_ref(w, cols, bias, words, relu)
        torch.cuda.synchronize()
        err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
        max_err = max(max_err, err)
        if not torch.equal(got, want):
            raise AssertionError(f"kernel != plain version at {what}: "
                                 f"max |err| {err}")
        return got

    def dev_i8(a):
        return torch.from_numpy(np.array(a, np.int8)).to(dev)

    def dev_i32(a):
        return torch.from_numpy(np.array(a, np.int32)).to(dev)

    def dev_bf16(a):
        return torch.from_numpy(np.array(a, np.float32)).to(dev) \
            .to(torch.bfloat16)

    # ---- 3. int8 kernel against plain, at the bundle's shapes and tables --
    layer_tabs = {}
    for i in gemm_descs:
        d = bm.descs[i]
        base = bm.base
        k_out = d.dst_dims[1]
        kk = perfmodel.contract_k(d)
        w = bm.arena0[d.wt_addr - base:d.wt_addr - base + k_out * kk]
        bias = np.frombuffer(bm.arena0[d.bias_addr - base:
                                       d.bias_addr - base + 4 * k_out]
                             .tobytes(), np.int32)
        words = np.frombuffer(bm.arena0[d.scale_addr - base:
                                        d.scale_addr - base + 4 * k_out]
                              .tobytes(), np.int32)
        layer_tabs[i] = (dev_i8(w.view(np.int8).reshape(k_out, kk)),
                         dev_i32(bias), dev_i32(words), d.relu)
    shapes = {}
    for i in gemm_descs:
        d = bm.descs[i]
        key = (d.dst_dims[1], perfmodel.contract_k(d), perfmodel.gemm_cols(d))
        shapes.setdefault(key, i)
    for (m, kk, n), i in sorted(shapes.items()):
        w, bias, words, relu = layer_tabs[i]
        for lanes in (1, BUCKET):
            cols = dev_i8(rng.integers(-128, 128, (kk, n * lanes)))
            held(w, cols, bias, words, relu, f"M={m} K={kk} N={n * lanes}")
            held(w, cols, bias, words, not relu, f"M={m} K={kk} N={n * lanes} "
                                                 f"relu={not relu}")
    # edge cases
    m, kk = 64, 4608
    w = torch.full((m, kk), -128, dtype=torch.int8, device=dev)
    cols = torch.full((kk, 33), -128, dtype=torch.int8, device=dev)
    int8_edges = []
    for pre, post, mm in ((0, 0, 1), (0, 0, -32768), (16, 30, -32768),
                          (31, 31, 32767), (0, 30, 12345)):
        word = ((mm & 0xFFFF) << 16) | (pre << 8) | post
        words = dev_i32(np.full(m, word, np.uint32).view(np.int32))
        for b0 in (0, 2**31 - 1 - kk * 2**14, -2**31, 2**31 - 1):
            bias = dev_i32(np.full(m, b0, np.int64).astype(np.int32))
            int8_edges.append((bias, words))
            for relu in (False, True):
                held(w, cols, bias, words, relu,
                     f"all -128, K={kk}, bias={b0}, word=({mm},{pre},{post})")
    int8_random = []
    for m, kk, n in ((10, 512, 1), (10, 512, BUCKET), (1, 1, 1), (65, 27, 1000),
                     (130, 1025, 129), (7, 4608, 31)):
        w = dev_i8(rng.integers(-128, 128, (m, kk)))
        cols = dev_i8(rng.integers(-128, 128, (kk, n)))
        bias = dev_i32(rng.integers(-2**20, 2**20, m))
        mps = [(int(rng.integers(-32768, 32768)), int(rng.integers(0, 17)),
                int(rng.integers(0, 31))) for _ in range(m)]
        words = dev_i32(np.array([((a & 0xFFFF) << 16) | (b << 8) | c
                                  for a, b, c in mps], np.uint32).view(np.int32))
        int8_random.append((w, cols, bias, words))
        held(w, cols, bias, words, True, f"M={m} K={kk} N={n}")
    # groups = 2 through the wrapper, against the plain conv on the card
    x = dev_i8(rng.integers(-128, 128, (8, 9, 9)))
    wq = dev_i8(rng.integers(-128, 128, (6, 4 * 9)))
    bias = dev_i32(rng.integers(-2**16, 2**16, 6))
    words = dev_i32(np.full(6, (300 << 16) | (2 << 8) | 9, np.int32))
    got = ops.conv2d_int8(x, wq, bias, words, 3, 2, 1, groups=2, relu=True)
    torch.cuda.synchronize()
    want = ref.conv2d_int8_ref(x, wq, bias, words, 3, 2, 1, groups=2, relu=True)
    if not torch.equal(got, want):
        raise AssertionError("grouped conv: kernel != plain version")
    log(json.dumps({"phase": "kernel_vs_plain", "kernel": "int8_conv_gemm",
                    "shapes": len(shapes), "tolerance": "byte equality",
                    "max_abs_err": max_err}))

    # ---- 4. the nv_small served path ---------------------------------------
    in_shape = g.input_shape
    X = np.random.default_rng(SEED + 7).normal(0, 1, (8,) + in_shape) \
        .astype(np.float32)
    Xb = np.random.default_rng(SEED + 8).normal(0, 1, (5,) + in_shape) \
        .astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        art.save(tmp)
        ses = Session.from_bundle(tmp, device="cuda")
        golden = Session.from_bundle(tmp, backend="ref", device="cuda")
    n_gemm = len(gemm_descs)
    passes = len(X) + 1
    zero_counts()
    t0 = time.perf_counter()
    singles = [ses.run(x) for x in X]
    batch = ses.run_batch(Xb)
    torch.cuda.synchronize()
    served_s = time.perf_counter() - t0
    launches, bf16_l, qm_l = counts()
    if (launches, bf16_l, qm_l) != (n_gemm * passes, 0, 0):
        raise AssertionError(f"nv_small launches (int8_conv, bf16_conv, "
                             f"int8_gemm) = {(launches, bf16_l, qm_l)}, want "
                             f"({n_gemm} CONV/FC descriptors x {passes} "
                             f"passes, 0, 0)")
    for x, r in zip(X, singles):
        want = golden.run(x).output_int8
        if r.output_int8.shape != (art.output_elems,) or \
                not np.array_equal(r.output_int8, want):
            raise AssertionError("served output != ref backend")
        if not np.all(np.isfinite(r.output)):
            raise AssertionError("non-finite served output")
    want_b = np.stack([golden.run(x).output_int8 for x in Xb])
    if batch.output_int8.shape != (5, art.output_elems) or \
            not np.array_equal(batch.output_int8, want_b):
        raise AssertionError("served batch != ref backend")
    # the VP ran the compile's sample input: the served path must agree
    vp_in = pipeline.CompilerPipeline(g, seed=SEED).sample_input
    if not np.array_equal(ses.run(vp_in).output_int8, art.vp_output_int8):
        raise AssertionError("served output != the compiler's VP run")
    res, samples = ses.executor().run_profiled(X[0])
    if not np.array_equal(res.output_int8, singles[0].output_int8) or \
            len(samples) != len(bm.descs):
        raise AssertionError("run_profiled disagrees with run")
    by_unit: dict = {}
    for s in samples:
        by_unit[s["unit"]] = by_unit.get(s["unit"], 0.0) + s["us"]
    log(json.dumps({"phase": "run_profiled", "net": "resnet18/nv_small",
                    "us_by_unit": by_unit}))
    log(json.dumps({"phase": "served", "net": "resnet18/nv_small",
                    "requests": len(X), "batch_lanes": len(Xb),
                    "bucket": ses.bucket_for(len(Xb)), "launches": launches,
                    "gemm_descriptors": n_gemm, "seconds": served_s,
                    "byte_equal_ref": True}))

    # ---- 5. bf16 kernel against plain, at the nv_full bundle's shapes -----
    bf16_err = {"max_abs_err": 0.0, "max_rel_err": 0.0}

    def held_bf16(w, cols, bias, relu, what):
        """Kernel (through its wrapper) vs plain version on the card, within
        gemm_tolerance(K); returns the kernel's output."""
        got = bf16_ops.gemm(w, cols, bias, relu)
        torch.cuda.synchronize()
        want = bf16_ref.bf16_conv_gemm_ref(w, cols, bias, relu)
        torch.cuda.synchronize()
        g32 = got.float().cpu().numpy()
        w32 = want.float().cpu().numpy()
        if not np.all(np.isfinite(g32)):
            raise AssertionError(f"bf16 kernel: non-finite output at {what}")
        tolerances.assert_close(g32, w32, tolerances.gemm_tolerance(
            w.shape[1]), f"bf16_conv_gemm {what}")
        return got, g32, w32

    bf16_tabs = {}
    for i in gemm_descs:
        d = bm_f.descs[i]
        base = bm_f.base
        k_out = d.dst_dims[1]
        kk = perfmodel.contract_k(d)
        wraw = bm_f.arena0[d.wt_addr - base:d.wt_addr - base + 2 * k_out * kk]
        braw = bm_f.arena0[d.bias_addr - base:d.bias_addr - base + 4 * k_out]
        w = torch.from_numpy(np.frombuffer(wraw.tobytes(), np.int16).copy()) \
            .view(torch.bfloat16).reshape(k_out, kk).to(dev)
        bias = torch.from_numpy(np.frombuffer(braw.tobytes(), np.float32)
                                .copy()).to(dev)
        bf16_tabs[i] = (w, bias, d.relu)
    for (m, kk, n), i in sorted(shapes.items()):
        w, bias, relu = bf16_tabs[i]
        lanes = [dev_bf16(rng.normal(0, 1, (kk, n))) for _ in range(BUCKET)]
        for r_ in (relu, not relu):
            got8, g8, w8 = held_bf16(w, torch.cat(lanes, 1).contiguous(), bias,
                                     r_, f"M={m} K={kk} N={n * BUCKET}")
            bf16_err["max_abs_err"] = max(bf16_err["max_abs_err"],
                                          float(np.abs(g8 - w8).max()))
            bf16_err["max_rel_err"] = max(bf16_err["max_rel_err"],
                                          tolerances.max_rel_err(g8, w8))
            for lane, cols in enumerate(lanes):
                got1, _, _ = held_bf16(w, cols, bias, r_, f"M={m} K={kk} N={n}")
                if not torch.equal(got8[:, lane * n:(lane + 1) * n].view(
                        torch.int16), got1.view(torch.int16)):
                    raise AssertionError(
                        f"bf16 kernel: lane {lane} of the {BUCKET}-lane "
                        f"launch differs from its own launch at M={m} "
                        f"K={kk} N={n}")
    # edge cases
    for m, kk, n in ((64, 4608, 33), (10, 512, 1), (10, 512, BUCKET),
                     (1, 1, 1), (65, 27, 1000), (130, 1025, 129)):
        w = dev_bf16(rng.normal(0, 1, (m, kk)))
        cols = dev_bf16(rng.normal(0, 1, (kk, n)))
        bias = torch.from_numpy(rng.normal(0, 1, m).astype(np.float32)).to(dev)
        held_bf16(w, cols, bias, True, f"M={m} K={kk} N={n}")
    w = torch.zeros((64, 576), dtype=torch.bfloat16, device=dev)
    cols = dev_bf16(rng.normal(0, 1, (576, 40)))
    bias = torch.from_numpy(rng.normal(0, 3, 64).astype(np.float32)).to(dev)
    got, _, _ = held_bf16(w, cols, bias, False, "bias only")
    if not torch.equal(got, bias.to(torch.bfloat16)[:, None].expand(64, 40)):
        raise AssertionError("bf16 kernel: zero weights must give bf16(bias)")
    for sw, sc in ((2.0**50, 2.0**50), (2.0**-50, 2.0**-50),
                   (2.0**100, 2.0**-100)):
        w = dev_bf16(rng.normal(0, 1, (64, 4608)) * sw)
        cols = dev_bf16(rng.normal(0, 1, (4608, 33)) * sc)
        zero_b = torch.zeros(64, dtype=torch.float32, device=dev)
        held_bf16(w, cols, zero_b, False, f"magnitudes {sw:g} x {sc:g}")
    x = dev_bf16(rng.normal(0, 1, (8, 9, 9)))
    wq = dev_bf16(rng.normal(0, 0.5, (6, 4 * 9)))
    bias = torch.from_numpy(rng.normal(0, 1, 6).astype(np.float32)).to(dev)
    got = bf16_ops.conv2d_bf16(x, wq, bias, 3, 2, 1, groups=2, relu=True)
    torch.cuda.synchronize()
    want = bf16_ref.conv2d_bf16_ref(x, wq, bias, 3, 2, 1, groups=2, relu=True)
    tolerances.assert_close(got.float().cpu().numpy(),
                            want.float().cpu().numpy(),
                            tolerances.gemm_tolerance(4 * 9), "grouped bf16")
    log(json.dumps({"phase": "kernel_vs_plain", "kernel": "bf16_conv_gemm",
                    "shapes": len(shapes),
                    "tolerance": "tolerances.gemm_tolerance(K); lanes of a "
                                 "bucket-8 launch bit-identical to 1-lane",
                    **bf16_err}))

    # ---- 6. int8_gemm (W8A8 quantized_matmul) against plain ---------------
    qm_err = 0

    def held_qm(x, w, bias, words, relu, what):
        nonlocal qm_err
        got = qm_ops.quantized_matmul(x, w, bias, words, relu)
        torch.cuda.synchronize()
        want = qm_ref.int8_gemm_ref(x, w, bias, words, relu)
        torch.cuda.synchronize()
        err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
        qm_err = max(qm_err, err)
        if not torch.equal(got, want):
            raise AssertionError(f"int8_gemm != plain version at {what}: "
                                 f"max |err| {err}")
        return got

    def scale_words(n, max_acc):
        """Packed (m, pre, post) words, as the reference's kernel test makes
        them."""
        words = [quant.pack_scale(*quant.fixed_point(float(s), max_acc))
                 for s in rng.uniform(1e-5, 1e-3, n)]
        return dev_i32(np.array(words, np.uint32).view(np.int32))

    for m, kk, n in ((128, 128, 128), (256, 384, 128), (128, 128, 384),
                     (100, 200, 60), (1, 576, 10)):
        x = dev_i8(rng.integers(-128, 128, (m, kk)))
        w = dev_i8(rng.integers(-128, 128, (kk, n)))
        bias = dev_i32(rng.integers(-1000, 1000, n))
        words = scale_words(n, kk * 128 * 128)
        for relu in (False, True):
            held_qm(x, w, bias, words, relu, f"M={m} K={kk} N={n}")
    qm_tabs = {i: (layer_tabs[i][0].t().contiguous(),) + layer_tabs[i][1:]
               for i in gemm_descs}
    for (m, kk, n), i in sorted(shapes.items()):
        w_t, bias, words, relu = qm_tabs[i]
        for lanes in (1, BUCKET):
            x_t = dev_i8(rng.integers(-128, 128, (n * lanes, kk)))
            got = held_qm(x_t, w_t, bias, words, relu,
                          f"transposed M={n * lanes} K={kk} N={m}")
            conv = ops.gemm(layer_tabs[i][0], x_t.t().contiguous(), bias,
                            words, relu)
            if not torch.equal(got, conv.t()):
                raise AssertionError("int8_gemm != transposed int8_conv_gemm "
                                     f"at M={n * lanes} K={kk} N={m}")
    w = torch.full((4608, 64), -128, dtype=torch.int8, device=dev)
    x = torch.full((33, 4608), -128, dtype=torch.int8, device=dev)
    for bias, words in int8_edges:
        for relu in (False, True):
            held_qm(x, w, bias, words, relu, "all -128, K=4608")
    for w, cols, bias, words in int8_random:
        held_qm(cols.t().contiguous(), w.t().contiguous(), bias, words, True,
                f"transposed random M={cols.shape[1]} K={w.shape[1]}")
    log(json.dumps({"phase": "kernel_vs_plain", "kernel": "int8_gemm",
                    "tolerance": "byte equality", "max_abs_err": qm_err}))

    # its own path: one transposed ResNet-18 pass through quantized_matmul
    xs_t = {i: dev_i8(rng.integers(-128, 128, (perfmodel.gemm_cols(
        bm.descs[i]), qm_tabs[i][0].shape[0]))) for i in gemm_descs}
    zero_counts()
    outs = [qm_ops.quantized_matmul(xs_t[i], *qm_tabs[i]) for i in gemm_descs]
    torch.cuda.synchronize()
    path_counts = counts()
    if path_counts != (0, 0, n_gemm):
        raise AssertionError(f"quantized_matmul path launches (int8_conv, "
                             f"bf16_conv, int8_gemm) = {path_counts}, want "
                             f"(0, 0, {n_gemm})")
    qm_launches = path_counts[2]
    for i, out in zip(gemm_descs, outs):
        if not torch.equal(out, qm_ref.int8_gemm_ref(xs_t[i], *qm_tabs[i])):
            raise AssertionError("quantized_matmul path != plain version")
    log(json.dumps({"phase": "served", "net": "quantized_matmul over a "
                    "transposed resnet18/nv_small pass", "calls": n_gemm,
                    "launches": qm_launches, "byte_equal_plain": True}))

    # ---- 7. the nv_full served path ---------------------------------------
    tol_net = tolerances.net_tolerance(contract_ks=[
        perfmodel.contract_k(bm_f.descs[i]) for i in gemm_descs])
    with tempfile.TemporaryDirectory() as tmp:
        art_f.save(tmp)
        ses_f = Session.from_bundle(tmp, device="cuda")
        golden_f = Session.from_bundle(tmp, backend="ref", device="cuda")
    zero_counts()
    t0 = time.perf_counter()
    singles_f = [ses_f.run(x) for x in X]
    batch_f = ses_f.run_batch(Xb)
    torch.cuda.synchronize()
    served_f_s = time.perf_counter() - t0
    path_counts = counts()
    if path_counts != (0, n_gemm * passes, 0):
        raise AssertionError(f"nv_full launches (int8_conv, bf16_conv, "
                             f"int8_gemm) = {path_counts}, want (0, {n_gemm} "
                             f"CONV/FC descriptors x {passes} passes, 0)")
    bf16_launches = path_counts[1]
    net_err = 0.0
    for x, r in zip(X, singles_f):
        want = golden_f.run(x).output
        if r.output.shape != (art_f.output_elems,) or \
                r.output_int8.shape != (2 * art_f.output_elems,) or \
                not np.all(np.isfinite(r.output)):
            raise AssertionError("nv_full served output malformed")
        tolerances.assert_close(r.output, want, tol_net, "nv_full vs ref")
        net_err = max(net_err, tolerances.max_rel_err(r.output, want))
    if batch_f.output.shape != (5, art_f.output_elems):
        raise AssertionError("nv_full served batch malformed")
    for lane, x in enumerate(Xb):
        tolerances.assert_close(batch_f.output[lane], golden_f.run(x).output,
                                tol_net, f"nv_full batch lane {lane} vs ref")
        if not np.array_equal(batch_f.output_int8[lane],
                              ses_f.run(x).output_int8):
            raise AssertionError(f"nv_full batch lane {lane} differs from its "
                                 f"single request")
    vp_in_f = pipeline.CompilerPipeline(g, seed=SEED,
                                        cfg=engine.NV_FULL).sample_input
    got_vp = ses_f.run(vp_in_f).output
    tolerances.assert_close(got_vp, art_f.vp_output, tol_net, "nv_full vs VP")
    res_f, samples_f = ses_f.executor().run_profiled(X[0])
    if not np.array_equal(res_f.output_int8, singles_f[0].output_int8):
        raise AssertionError("nv_full run_profiled disagrees with run")
    by_unit = {}
    for s in samples_f:
        by_unit[s["unit"]] = by_unit.get(s["unit"], 0.0) + s["us"]
    log(json.dumps({"phase": "run_profiled", "net": "resnet18/nv_full",
                    "us_by_unit": by_unit}))
    log(json.dumps({"phase": "served", "net": "resnet18/nv_full",
                    "requests": len(X), "batch_lanes": len(Xb),
                    "launches": bf16_launches, "gemm_descriptors": n_gemm,
                    "seconds": served_f_s, "tolerance_rtol": tol_net.rtol,
                    "max_rel_err_vs_ref": net_err,
                    "max_rel_err_vs_vp": tolerances.max_rel_err(
                        got_vp, art_f.vp_output),
                    "batch_lanes_bit_identical": True}))

    # both datapaths resident in one Session, alternating requests
    with tempfile.TemporaryDirectory() as tmp:
        art.save(tmp + "/small")
        art_f.save(tmp + "/full")
        mixed = Session(pipeline.Artifacts.load(tmp + "/small"), name="small",
                        device="cuda")
        mixed.load(pipeline.Artifacts.load(tmp + "/full"), name="full")
    for x in X[:4]:
        if not np.array_equal(mixed.run(x, net="small").output_int8,
                              golden.run(x).output_int8):
            raise AssertionError("mixed session: nv_small != its ref")
        tolerances.assert_close(mixed.run(x, net="full").output,
                                golden_f.run(x).output, tol_net,
                                "mixed session: nv_full vs its ref")
    mb = mixed.run_batch(Xb[:3], net="full")
    for lane in range(3):
        tolerances.assert_close(mb.output[lane], golden_f.run(Xb[lane]).output,
                                tol_net, "mixed session: nv_full batch")
    log(json.dumps({"phase": "mixed_session", "networks": mixed.networks,
                    "dtypes": [mixed.executor(n).capabilities().dtype
                               for n in mixed.networks], "ok": True}))

    # ---- 8. times ----------------------------------------------------------
    tot = Totals()
    for lanes in (1, BUCKET):
        for i in gemm_descs:
            d = bm.descs[i]
            w, bias, words, relu = layer_tabs[i]
            m, kk = w.shape
            n = perfmodel.gemm_cols(d) * lanes
            cols = dev_i8(rng.integers(-128, 128, (kk, n)))
            ms = cuda_ms(lambda: kernel.int8_conv_gemm(w, cols, bias, words,
                                                       relu))
            plain = cuda_ms(lambda: ref.int8_conv_gemm_ref(w, cols, bias,
                                                           words, relu), 10, 2)
            # yardstick: cuBLASLt int8 GEMM + the epilogue in torch
            wp, cp, bp, sp = int_mm_operands(w, cols, bias, words)
            lib_out = intmath.row_epilogue(torch._int_mm(wp, cp), bp, sp, relu)
            if not torch.equal(lib_out[:m, :n],
                               ref.int8_conv_gemm_ref(w, cols, bias, words,
                                                      relu)):
                raise AssertionError("library yardstick disagrees")
            lib = cuda_ms(lambda: intmath.row_epilogue(torch._int_mm(wp, cp),
                                                       bp, sp, relu), 10, 2)
            int_mm = cuda_ms(lambda: torch._int_mm(wp, cp))   # GEMM alone
            b = bound_int8(m, kk, n)
            log(json.dumps({"kernel": "int8_conv_gemm", "layer": i,
                            "unit": d.unit, "bucket": lanes, "M": m, "K": kk,
                            "N": n, "ms": ms, "plain_ms": plain,
                            "library_ms": lib, "int_mm_ms": int_mm,
                            "bound_ms": b[0], "bound_by": b[1]}))
            if lanes == 1:
                tot.add(ms, plain, lib, b)

    # bf16: the yardstick is cuBLAS through torch.mm with an f32 result
    # (out_dtype) where this torch has it, plus the epilogue in torch
    mm_f32 = "dtype" in torch.ops.aten.mm.overloads()

    def bf16_library(w, cols, bias, relu):
        if mm_f32:
            acc = torch.mm(w, cols, out_dtype=torch.float32) + bias[:, None]
        else:     # rounds the product to bf16 before the bias is added
            acc = torch.mm(w, cols).float() + bias[:, None]
        return (acc.clamp(min=0.0) if relu else acc).to(torch.bfloat16)

    log(json.dumps({"phase": "bf16_library", "call":
                    "torch.mm(out_dtype=torch.float32) + torch epilogue"
                    if mm_f32 else "torch.mm in bf16 (rounds before the "
                    "bias) + torch epilogue"}))
    tot_f = Totals()
    for lanes in (1, BUCKET):
        for i in gemm_descs:
            d = bm_f.descs[i]
            w, bias, relu = bf16_tabs[i]
            m, kk = w.shape
            n = perfmodel.gemm_cols(d) * lanes
            cols = dev_bf16(rng.normal(0, 1, (kk, n)))
            ms = cuda_ms(lambda: bf16_kernel.bf16_conv_gemm(w, cols, bias,
                                                            relu))
            plain = cuda_ms(lambda: bf16_ref.bf16_conv_gemm_ref(w, cols, bias,
                                                                relu), 10, 2)
            tolerances.assert_close(
                bf16_library(w, cols, bias, relu).float().cpu().numpy(),
                bf16_ref.bf16_conv_gemm_ref(w, cols, bias, relu).float()
                .cpu().numpy(),
                tolerances.gemm_tolerance(kk).merged(tolerances.Tolerance(
                    rtol=tolerances.BF16_EPS)), "bf16 library yardstick")
            lib = cuda_ms(lambda: bf16_library(w, cols, bias, relu), 10, 2)
            b = bound_bf16(m, kk, n)
            log(json.dumps({"kernel": "bf16_conv_gemm", "layer": i,
                            "unit": d.unit, "bucket": lanes, "M": m, "K": kk,
                            "N": n, "ms": ms, "plain_ms": plain,
                            "library_ms": lib, "bound_ms": b[0],
                            "bound_by": b[1]}))
            if lanes == 1:
                tot_f.add(ms, plain, lib, b)

    tot_q = Totals()
    for lanes in (1, BUCKET):
        for i in gemm_descs:
            w_t, bias, words, relu = qm_tabs[i]
            kk, n = w_t.shape
            m = perfmodel.gemm_cols(bm.descs[i]) * lanes
            x_t = dev_i8(rng.integers(-128, 128, (m, kk)))
            ms = cuda_ms(lambda: qm_kernel.int8_gemm(x_t, w_t, bias, words,
                                                     relu))
            plain = cuda_ms(lambda: qm_ref.int8_gemm_ref(x_t, w_t, bias, words,
                                                         relu), 10, 2)
            # yardstick: cuBLASLt int8 GEMM on the transposed problem
            # (out^T = w^T x^T: the operand shapes the int8_conv yardstick
            # runs) + the epilogue in torch
            wtp, xtp, bp, sp = int_mm_operands(w_t.t(), x_t.t(), bias, words)
            lib_out = intmath.row_epilogue(torch._int_mm(wtp, xtp), bp, sp,
                                           relu).t()
            if not torch.equal(lib_out[:m, :n], qm_ref.int8_gemm_ref(
                    x_t, w_t, bias, words, relu)):
                raise AssertionError("int8_gemm library yardstick disagrees")
            lib = cuda_ms(lambda: intmath.row_epilogue(
                torch._int_mm(wtp, xtp), bp, sp, relu).t(), 10, 2)
            b = bound(m * kk + kk * n + 8 * n + m * n, 2 * m * kk * n,
                      INT8_OPS_PER_S)
            log(json.dumps({"kernel": "int8_gemm", "layer": i,
                            "bucket": lanes, "M": m, "K": kk, "N": n,
                            "ms": ms, "plain_ms": plain, "library_ms": lib,
                            "bound_ms": b[0], "bound_by": b[1]}))
            if lanes == 1:
                tot_q.add(ms, plain, lib, b)

    net_times(ses, X[0], X, "resnet18/nv_small")
    net_times(ses_f, X[0], X, "resnet18/nv_full")

    log(json.dumps({"phase": "done", "seconds_after_identity":
                    time.perf_counter() - t_start}))
    log(json.dumps({"kernels": [
        tot.row("int8_conv_gemm",
                "src/repro_torch/kernels/int8_conv/csrc/int8_conv.cu",
                "src/repro/kernels/int8_conv/kernel.py:49", launches, max_err),
        tot_f.row("bf16_conv_gemm",
                  "src/repro_torch/kernels/bf16_conv/csrc/bf16_conv.cu",
                  "src/repro/kernels/bf16_conv/kernel.py:47", bf16_launches,
                  bf16_err["max_abs_err"]),
        tot_q.row("int8_gemm",
                  "src/repro_torch/kernels/int8_gemm/csrc/int8_gemm.cu",
                  "src/repro/kernels/int8_gemm/kernel.py:62", qm_launches,
                  qm_err)]}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
