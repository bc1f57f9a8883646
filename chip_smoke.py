"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py

Run from the root of a checkout.  It imports ``repro_torch`` from ``src/``
(never JAX, never ``repro``), and every phase raises on failure, so the
script exits non-zero unless all of them pass:

1. card identity: name and power limit from ``nvidia-smi``;
2. build: ``nvcc`` compiles ``kernels/int8_conv/csrc/int8_conv.cu`` for
   sm_90a from the checkout's sources;
3. kernel against its plain version, byte for byte, on the card: every
   distinct CONV/FC GEMM of ResNet-18 (3x32x32, nv_small, full widths) with
   the compiled bundle's own weight/bias/scale tables, single image and
   lane-folded at bucket 8, plus edge cases (all -128 operands, pre = post = 0,
   m = -32768, accumulators near +-2^31, ragged N, groups = 2);
4. the served path: ResNet-18 compiled by the port's ``CompilerPipeline``
   (random weights from a seed), saved as a bundle, served by
   ``Session.from_bundle`` on cuda: 8 single requests and one ``run_batch``
   of 5 lanes padded to bucket 8, every output byte-equal to the port's numpy
   ``ref`` backend, with the kernel's launch count equal to the CONV/FC
   descriptors times the passes;
5. times, one JSON line per ResNet-18 GEMM shape and bucket, the whole-net
   ms per image, then the ``kernels`` line and the ``ok`` line.

Times come from CUDA events over repeated launches after a warm-up; the
bound is the larger of bytes / 3.35 TB/s and 2 * MACs / 1979 TOP/s (the
H100 SXM data-sheet peaks at 700 W).
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


def bound(m: int, k: int, n: int) -> tuple:
    """(bound_ms, bound_by) of one fused GEMM: each input read once (weights,
    columns, bias and scale words), the output written once."""
    nbytes = m * k + k * n + 8 * m + m * n
    ops = 2 * m * k * n
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                        else "operations")


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


def main() -> None:
    # ---- 1. card identity ------------------------------------------------
    smi = card_identity()
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions need
    torch.backends.cudnn.allow_tf32 = False         # exact float
    dev = torch.device("cuda")

    from repro_torch.core import graph, intmath, perfmodel, pipeline
    from repro_torch.kernels.int8_conv import kernel, ops, ref
    from repro_torch.runtime import Session, create_executor

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    kernel._load()
    build_s = time.perf_counter() - t0
    ptxas = [l.strip() for l in kernel.build_log.splitlines()
             if "registers" in l or "spill" in l]
    log(json.dumps({"phase": "build", "seconds": build_s,
                    "library": str(kernel.library_path().name),
                    "ptxas": ptxas}))

    # ---- compile ResNet-18 (port's own compiler) --------------------------
    t0 = time.perf_counter()
    g = graph.resnet18()
    art = pipeline.CompilerPipeline(g, seed=SEED).run()
    log(json.dumps({"phase": "compile", "net": g.name,
                    "seconds": time.perf_counter() - t0,
                    "weight_image_bytes":
                        sum(len(b) for b in art.weight_image.values())}))
    bm = create_executor("baremetal", art, device=dev)
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

    def dev_i8(a):
        return torch.from_numpy(np.array(a, np.int8)).to(dev)

    def dev_i32(a):
        return torch.from_numpy(np.array(a, np.int32)).to(dev)

    # ---- 3. kernel against plain, at the bundle's shapes and tables -------
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
    for pre, post, mm in ((0, 0, 1), (0, 0, -32768), (16, 30, -32768),
                          (31, 31, 32767), (0, 30, 12345)):
        word = ((mm & 0xFFFF) << 16) | (pre << 8) | post
        words = dev_i32(np.full(m, word, np.uint32).view(np.int32))
        for b0 in (0, 2**31 - 1 - kk * 2**14, -2**31, 2**31 - 1):
            bias = dev_i32(np.full(m, b0, np.int64).astype(np.int32))
            for relu in (False, True):
                held(w, cols, bias, words, relu,
                     f"all -128, K={kk}, bias={b0}, word=({mm},{pre},{post})")
    for m, kk, n in ((10, 512, 1), (10, 512, BUCKET), (1, 1, 1), (65, 27, 1000),
                     (130, 1025, 129), (7, 4608, 31)):
        w = dev_i8(rng.integers(-128, 128, (m, kk)))
        cols = dev_i8(rng.integers(-128, 128, (kk, n)))
        bias = dev_i32(rng.integers(-2**20, 2**20, m))
        mps = [(int(rng.integers(-32768, 32768)), int(rng.integers(0, 17)),
                int(rng.integers(0, 31))) for _ in range(m)]
        words = dev_i32(np.array([((a & 0xFFFF) << 16) | (b << 8) | c
                                  for a, b, c in mps], np.uint32).view(np.int32))
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
    log(json.dumps({"phase": "kernel_vs_plain", "shapes": len(shapes),
                    "tolerance": "byte equality", "max_abs_err": max_err}))

    # ---- 4. the served path -------------------------------------------------
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
    ops.launches = 0
    t0 = time.perf_counter()
    singles = [ses.run(x) for x in X]
    batch = ses.run_batch(Xb)
    torch.cuda.synchronize()
    served_s = time.perf_counter() - t0
    launches = ops.launches
    passes = len(X) + 1
    if launches != n_gemm * passes:
        raise AssertionError(f"kernel launches {launches} != {n_gemm} CONV/FC "
                             f"descriptors x {passes} passes")
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
    log(json.dumps({"phase": "run_profiled", "us_by_unit": by_unit}))
    log(json.dumps({"phase": "served", "requests": len(X),
                    "batch_lanes": len(Xb), "bucket": ses.bucket_for(len(Xb)),
                    "launches": launches, "gemm_descriptors": n_gemm,
                    "seconds": served_s, "byte_equal_ref": True}))

    # ---- 5. times ----------------------------------------------------------
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "bytes_ms": 0.0, "ops_ms": 0.0}
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
            # yardstick: cuBLASLt int8 GEMM + the epilogue in torch, operands
            # zero-padded (outside the timing) to _int_mm's layout rules
            mp, kp, np_ = max(-(-m // 8) * 8, 24), -(-kk // 8) * 8, -(-n // 8) * 8
            wp = torch.zeros((mp, kp), dtype=torch.int8, device=dev)
            wp[:m, :kk] = w
            cp = torch.zeros((kp, np_), dtype=torch.int8, device=dev)
            cp[:kk, :n] = cols
            bp = torch.zeros(mp, dtype=torch.int32, device=dev)
            bp[:m] = bias
            sp = torch.zeros(mp, dtype=torch.int32, device=dev)
            sp[:m] = words
            lib_out = intmath.row_epilogue(torch._int_mm(wp, cp), bp, sp, relu)
            if not torch.equal(lib_out[:m, :n],
                               ref.int8_conv_gemm_ref(w, cols, bias, words,
                                                      relu)):
                raise AssertionError("library yardstick disagrees")
            lib = cuda_ms(lambda: intmath.row_epilogue(torch._int_mm(wp, cp),
                                                       bp, sp, relu), 10, 2)
            int_mm = cuda_ms(lambda: torch._int_mm(wp, cp))   # GEMM alone
            b_ms, b_by = bound(m, kk, n)
            row = {"layer": i, "unit": d.unit, "bucket": lanes, "M": m,
                   "K": kk, "N": n, "ms": ms, "plain_ms": plain,
                   "library_ms": lib, "int_mm_ms": int_mm, "bound_ms": b_ms,
                   "bound_by": b_by}
            log(json.dumps(row))
            if lanes == 1:
                tot["ms"] += ms
                tot["plain_ms"] += plain
                tot["library_ms"] += lib
                tot["bound_ms"] += b_ms
                nbytes = m * kk + kk * n + 8 * m + m * n
                tot["bytes_ms"] += nbytes / HBM_BYTES_PER_S * 1e3
                tot["ops_ms"] += 2 * m * kk * n / INT8_OPS_PER_S * 1e3

    x1 = X[0]
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
    log(json.dumps({"phase": "net", "net": g.name, "ms_per_image_batch1": net1,
                    "ms_per_image_bucket8": net8 / BUCKET,
                    "ms_per_batch_bucket8": net8}))
    log(json.dumps(profile_serving(lambda: ses.run(x1), "batch1")))
    log(json.dumps(profile_serving(lambda: ses.run_batch(X), "bucket8")))

    log(json.dumps({"kernels": [{
        "name": "int8_conv_gemm", "route": "cuda",
        "source": "src/repro_torch/kernels/int8_conv/csrc/int8_conv.cu",
        "replaces": "src/repro/kernels/int8_conv/kernel.py:49",
        "launches": launches, "max_abs_err": max_err,
        "ms": tot["ms"], "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"],
        "bound_by": "bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations",
        "library_ms": tot["library_ms"]}]}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
