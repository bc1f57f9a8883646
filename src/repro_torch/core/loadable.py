"""Model compiler: (graph, fp32 params, calibration) -> Loadable.

The port's own copy of ``repro.core.loadable``: ``repro_torch`` imports nothing
of ``repro``.  Its bf16 (nv_full) builder writes the weight image through
the port's own codec (``core/bf16.py``) where the reference uses
``ml_dtypes``; the bytes are the same.

This is the role the NVDLA compiler plays in the paper's Fig. 1: it turns a
Caffe-style model into (a) a fully static sequence of engine descriptors and
(b) the preloaded DRAM image (quantised weights, int32 biases, fixed-point
per-channel scale tables) laid out by the arena planner.

The Loadable is what the virtual platform executes; the CSB/DBB logs of that
execution are then distilled into the bare-metal trace (core/vp.py,
core/tracegen.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import bf16, engine, memory, quant
from repro_torch.core.graph import NetGraph


@dataclasses.dataclass
class Loadable:
    graph: NetGraph
    cfg: engine.EngineConfig
    plan: memory.ArenaPlan
    descriptors: List[engine.Descriptor]
    desc_layers: List[str]              # layer name per descriptor
    dram_image: np.ndarray              # uint8, static region [weights..weight_end)
    input_scale: float
    output_scale: float

    @property
    def input_surface(self) -> memory.Surface:
        return self.plan.surfaces["data"]

    @property
    def output_surface(self) -> memory.Surface:
        return self.plan.surfaces[self.graph.output]


def calibrate(graph: NetGraph, params: Dict[str, Dict[str, np.ndarray]],
              samples: np.ndarray, percentile: float = 99.99) -> quant.CalibrationTable:
    """Run fp32 reference forward passes, record per-layer |activation| scales.

    ``samples``: (N, C, H, W) float32 calibration batch.  Implements the paper's
    future-work item (INT8 calibration-table generation).
    """
    from repro_torch.core import refops   # local import to avoid cycle

    by = graph.by_name()
    maxes: Dict[str, float] = {l.name: 1e-8 for l in graph.layers}
    for x in samples:
        acts: Dict[str, np.ndarray] = {}
        for l in graph.layers:
            if l.type == "input":
                acts[l.name] = x.astype(np.float32)
            elif l.type == "conv":
                p = params[l.name]
                acts[l.name] = refops.conv_bf16(acts[l.inputs[0]], p["w"], p["b"],
                                                l.kernel, l.stride, l.pad, l.groups, l.relu)
            elif l.type == "fc":
                p = params[l.name]
                acts[l.name] = refops.fc_bf16(acts[l.inputs[0]], p["w"], p["b"], l.relu)
            elif l.type == "pool":
                xin = acts[l.inputs[0]]
                if l.pool_mode == "gap":
                    acts[l.name] = xin.mean(axis=(1, 2), keepdims=True)
                elif l.pool_mode == "max":
                    acts[l.name] = _pool_f32(xin, l, "max")
                else:
                    acts[l.name] = _pool_f32(xin, l, "avg")
            elif l.type == "add":
                a = acts[l.inputs[0]] + acts[l.inputs[1]]
                acts[l.name] = np.maximum(a, 0) if l.relu else a
            elif l.type == "concat":
                acts[l.name] = np.concatenate([acts[i] for i in l.inputs], axis=0)
            for name, a in acts.items():
                maxes[name] = max(maxes[name], float(np.percentile(np.abs(a), percentile)))
    scales = {k: v / quant.INT8_MAX for k, v in maxes.items()}

    # Scale unification (standard): pools & concat inherit/unify with their inputs
    # so those ops are scale-free on the engine.
    for l in graph.layers:
        if l.type == "pool" and l.pool_mode == "max":
            scales[l.name] = scales[l.inputs[0]]
        if l.type == "concat":
            for i in l.inputs:
                scales[i] = scales[l.name]
    return quant.CalibrationTable(scales)


def _pool_f32(x: np.ndarray, l, mode: str) -> np.ndarray:
    c, h, w = x.shape
    k, st, pad = l.kernel, l.stride, l.pad
    fill = -np.inf if mode == "max" else 0.0
    xp = np.pad(x, ((0, 0), (pad, pad), (pad, pad)), constant_values=fill)
    p = (h + 2 * pad - k) // st + 1
    q = (w + 2 * pad - k) // st + 1
    acc = np.full((c, p, q), fill, np.float32)
    for r in range(k):
        for s in range(k):
            win = xp[:, r:r + st * p:st, s:s + st * q:st]
            acc = np.maximum(acc, win) if mode == "max" else acc + win
    return acc if mode == "max" else acc / (k * k)


def build_loadable(graph: NetGraph, params: Dict[str, Dict[str, np.ndarray]],
                   cal: quant.CalibrationTable,
                   cfg: engine.EngineConfig = engine.NV_SMALL) -> Loadable:
    if cfg.dtype == "bf16":
        return _build_loadable_bf16(graph, params, cal, cfg)
    if cfg.dtype != "int8":
        known = ", ".join(f"{n} (dtype={c.dtype})"
                          for n, c in engine.CONFIGS.items())
        raise ValueError(
            f"cannot build a loadable for engine dtype {cfg.dtype!r} "
            f"(config {cfg.name!r}); supported datapaths are int8 (nv_small) "
            f"and bf16 (nv_full).  Known engine configs: {known}")
    plan = memory.plan_arena(graph, elem_bytes=1)
    by = graph.by_name()
    image = np.zeros(plan.weight_end - engine.DRAM_BASE, np.uint8)
    descs: List[engine.Descriptor] = []
    names: List[str] = []

    def blit(addr: int, data: np.ndarray):
        off = addr - engine.DRAM_BASE
        raw = data.tobytes()
        image[off:off + len(raw)] = np.frombuffer(raw, np.uint8)

    def dims(name: str) -> tuple:
        c, h, w = by[name].out_shape if by[name].out_shape else graph.input_shape
        return (1, c, h, w)

    for l in graph.layers:
        if l.type in ("input", "concat"):
            continue    # concat is pure addressing (planner laid members adjacently)
        src = l.inputs[0]
        s_in = cal.scales[src]
        s_out = cal.scales[l.name]
        d = engine.Descriptor(
            unit={"conv": "CONV", "fc": "FC", "pool": "PDP", "add": "EW"}[l.type],
            src_addr=plan.surfaces[src].addr,
            src_dims=dims(src),
            dst_addr=plan.surfaces[l.name].addr,
            dst_dims=dims(l.name),
            relu=l.relu,
        )
        if l.type in ("conv", "fc"):
            p = params[l.name]
            wq, wscales = quant.quantize_weights(p["w"])
            cin_g = (by[src].out_shape[0] // l.groups if l.type == "conv"
                     else int(np.prod(by[src].out_shape)))
            kk = l.kernel if l.type == "conv" else 1
            max_acc = cin_g * kk * kk * 128 * 127 + 2**20   # acc bound + bias headroom
            bias_q = quant.quantize_bias(p["b"], s_in, wscales)
            words = quant.requant_table(s_in * wscales, s_out, max_acc)
            blit(plan.surfaces[f"{l.name}.w"].addr, wq.reshape(wq.shape[0], -1))
            blit(plan.surfaces[f"{l.name}.b"].addr, bias_q)
            blit(plan.surfaces[f"{l.name}.s"].addr, words)
            d.wt_addr = plan.surfaces[f"{l.name}.w"].addr
            d.bias_addr = plan.surfaces[f"{l.name}.b"].addr
            d.scale_addr = plan.surfaces[f"{l.name}.s"].addr
            d.kernel = (kk, kk)
            d.stride, d.pad = l.stride, l.pad
            d.groups = l.groups
        elif l.type == "pool":
            d.pool_mode = 1 if l.pool_mode == "max" else 2
            if l.pool_mode == "gap":
                c, h, w = by[src].out_shape
                d.kernel, d.stride, d.pad = (h, w), h, 0
                d.out_scale = quant.fixed_point(s_in / (s_out * h * w), h * w * 128)
            elif l.pool_mode == "avg":
                d.kernel = (l.kernel, l.kernel)
                d.stride, d.pad = l.stride, l.pad
                d.out_scale = quant.fixed_point(
                    s_in / (s_out * l.kernel * l.kernel), l.kernel * l.kernel * 128)
            else:
                d.kernel = (l.kernel, l.kernel)
                d.stride, d.pad = l.stride, l.pad
        elif l.type == "add":
            d.residual = True
            d.aux_addr = plan.surfaces[l.inputs[1]].addr
            d.out_scale = quant.fixed_point(cal.scales[l.inputs[0]] / s_out, 128)
            d.aux_scale = quant.fixed_point(cal.scales[l.inputs[1]] / s_out, 128)
        descs.append(d)
        names.append(l.name)

    return Loadable(graph=graph, cfg=cfg, plan=plan, descriptors=descs,
                    desc_layers=names, dram_image=image,
                    input_scale=cal.scales["data"],
                    output_scale=cal.scales[graph.output])


def _build_loadable_bf16(graph: NetGraph, params, cal, cfg) -> Loadable:
    """nv_full path: bf16 weights/activations, float accumulate, no requant."""
    plan = memory.plan_arena(graph, elem_bytes=2)
    by = graph.by_name()
    image = np.zeros(plan.weight_end - engine.DRAM_BASE, np.uint8)
    descs: List[engine.Descriptor] = []
    names: List[str] = []

    def blit(addr: int, data: np.ndarray):
        off = addr - engine.DRAM_BASE
        raw = data.tobytes()
        image[off:off + len(raw)] = np.frombuffer(raw, np.uint8)

    def dims(name: str) -> tuple:
        c, h, w = by[name].out_shape if by[name].out_shape else graph.input_shape
        return (1, c, h, w)

    for l in graph.layers:
        if l.type in ("input", "concat"):
            continue
        src = l.inputs[0]
        d = engine.Descriptor(
            unit={"conv": "CONV", "fc": "FC", "pool": "PDP", "add": "EW"}[l.type],
            src_addr=plan.surfaces[src].addr, src_dims=dims(src),
            dst_addr=plan.surfaces[l.name].addr, dst_dims=dims(l.name), relu=l.relu)
        if l.type in ("conv", "fc"):
            p = params[l.name]
            kk = l.kernel if l.type == "conv" else 1
            blit(plan.surfaces[f"{l.name}.w"].addr,
                 bf16.f32_to_bf16_bits(p["w"].reshape(p["w"].shape[0], -1)))
            blit(plan.surfaces[f"{l.name}.b"].addr, p["b"].astype(np.float32))
            d.wt_addr = plan.surfaces[f"{l.name}.w"].addr
            d.bias_addr = plan.surfaces[f"{l.name}.b"].addr
            d.kernel = (kk, kk)
            d.stride, d.pad = l.stride, l.pad
            d.groups = l.groups
        elif l.type == "pool":
            d.pool_mode = 1 if l.pool_mode == "max" else 2
            if l.pool_mode == "gap":
                c, h, w = by[src].out_shape
                d.kernel, d.stride, d.pad = (h, w), h, 0
            else:
                d.kernel = (l.kernel, l.kernel)
                d.stride, d.pad = l.stride, l.pad
        elif l.type == "add":
            d.residual = True
            d.aux_addr = plan.surfaces[l.inputs[1]].addr
        descs.append(d)
        names.append(l.name)
    return Loadable(graph=graph, cfg=cfg, plan=plan, descriptors=descs,
                    desc_layers=names, dram_image=image, input_scale=1.0,
                    output_scale=1.0)
