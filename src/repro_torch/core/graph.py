"""Caffe-style network graph IR + builders for the paper's evaluated models.

The port's own copy of ``repro.core.graph`` (byte-for-byte the same
behaviour): ``repro_torch`` imports nothing of ``repro``.

The paper's toolflow consumes *Caffe* models (prototxt + caffemodel).  We model that
input stage with a small layer-graph IR: a topologically ordered list of layers, each
naming its input blobs — the same structure a prototxt describes.  Builders below
construct the six networks evaluated in the paper (Tables II & III): LeNet-5,
ResNet-18, ResNet-50, MobileNet(v1), GoogLeNet and AlexNet.

Layer types (mapping to engine units, see ``core/engine.py``):
  conv  -> CONV+SDP (bias/requant/relu fused, paper's conv pipeline)
  fc    -> FC(+SDP)
  pool  -> PDP (max / avg / global-avg)
  add   -> EW (residual add, two quantised operands rescaled to a common scale)
  concat-> pure address-planning op (no engine work: outputs are laid out adjacently)
  input -> graph input
Activation (ReLU) is a *flag* on conv/fc/add, as in NVDLA's fused SDP datapath.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class Layer:
    name: str
    type: str                      # input|conv|fc|pool|add|concat
    inputs: List[str]
    # conv/fc params
    out_channels: int = 0
    kernel: int = 0
    stride: int = 1
    pad: int = 0
    groups: int = 1                # depthwise = groups == in_channels
    relu: bool = False
    # pool params
    pool_mode: str = ""            # "max" | "avg" | "gap"
    # filled by shape inference: (C, H, W) of this layer's output
    out_shape: Optional[tuple] = None


LAYER_TYPES = ("input", "conv", "fc", "pool", "add", "concat")
POOL_MODES = ("max", "avg", "gap")


@dataclasses.dataclass
class NetGraph:
    name: str
    input_shape: tuple             # (C, H, W)
    layers: List[Layer] = dataclasses.field(default_factory=list)
    # sha256 of the source file for imported nets (see ``repro.frontend``);
    # "" for hand-built graphs.  Mixed into compiler cache keys so two
    # imports that share a graph name never collide.
    source_digest: str = ""

    def layer(self, **kw) -> str:
        lyr = Layer(**kw)
        assert lyr.name not in {l.name for l in self.layers}, f"dup layer {lyr.name}"
        self.layers.append(lyr)
        return lyr.name

    def by_name(self) -> Dict[str, Layer]:
        return {l.name: l for l in self.layers}

    @property
    def output(self) -> str:
        return self.layers[-1].name

    # -- structural validation ----------------------------------------------
    def validate(self) -> "NetGraph":
        """Reject malformed graphs with a descriptive ValueError.

        Checks what the downstream stages (arena planner, loadable builder,
        tracegen) silently assume: exactly one input layer named ``data``,
        unique layer names, no dangling/forward references, known layer
        types, and per-layer shape consistency (windows that fit, matching
        ``add`` operands, concat-able spatials).  Called at
        ``CompilerPipeline`` entry so hand-built and imported graphs fail
        the same way, before any compilation work.
        """
        def err(msg: str):
            raise ValueError(f"invalid NetGraph {self.name!r}: {msg}")

        if not self.layers:
            err("graph has no layers")
        if len(self.input_shape) != 3 or any(d <= 0 for d in self.input_shape):
            err(f"input_shape must be a positive (C, H, W), "
                f"got {self.input_shape}")
        seen: Dict[str, Layer] = {}
        for l in self.layers:
            if l.name in seen:
                err(f"duplicate layer name {l.name!r}")
            if l.type not in LAYER_TYPES:
                err(f"layer {l.name!r} has unknown type {l.type!r} "
                    f"(expected one of {', '.join(LAYER_TYPES)})")
            for src in l.inputs:
                if src not in seen:
                    err(f"layer {l.name!r} reads {src!r}, which is not "
                        f"produced by any earlier layer (dangling or "
                        f"forward reference)")
            seen[l.name] = l
        inputs = [l for l in self.layers if l.type == "input"]
        if len(inputs) != 1 or inputs[0].name != "data":
            err(f"graph must have exactly one input layer named 'data' "
                f"(the loadable/arena input contract), got "
                f"{[l.name for l in inputs]}")
        if inputs[0].inputs:
            err("the input layer must not read other layers")

        # per-layer shape consistency, via a local propagation (does not
        # mutate out_shape — infer_shapes() owns that)
        shapes: Dict[str, tuple] = {}
        for l in self.layers:
            if l.type == "input":
                shapes[l.name] = self.input_shape
                continue
            if not l.inputs:
                err(f"layer {l.name!r} ({l.type}) has no inputs")
            if l.type in ("conv", "fc") and l.out_channels <= 0:
                err(f"layer {l.name!r} ({l.type}) needs out_channels > 0")
            if l.type == "conv":
                c, h, w = shapes[l.inputs[0]]
                if l.kernel <= 0 or l.stride <= 0 or l.pad < 0:
                    err(f"conv {l.name!r} has kernel={l.kernel} "
                        f"stride={l.stride} pad={l.pad}")
                if l.groups <= 0 or c % l.groups or l.out_channels % l.groups:
                    err(f"conv {l.name!r}: groups={l.groups} must divide "
                        f"in_channels={c} and out_channels={l.out_channels}")
                if h + 2 * l.pad < l.kernel or w + 2 * l.pad < l.kernel:
                    err(f"conv {l.name!r}: {l.kernel}x{l.kernel} window "
                        f"does not fit {c}x{h}x{w} input with pad={l.pad}")
                shapes[l.name] = (l.out_channels,
                                  (h + 2 * l.pad - l.kernel) // l.stride + 1,
                                  (w + 2 * l.pad - l.kernel) // l.stride + 1)
            elif l.type == "fc":
                shapes[l.name] = (l.out_channels, 1, 1)
            elif l.type == "pool":
                c, h, w = shapes[l.inputs[0]]
                if l.pool_mode not in POOL_MODES:
                    err(f"pool {l.name!r} has pool_mode={l.pool_mode!r} "
                        f"(expected one of {', '.join(POOL_MODES)})")
                if l.pool_mode == "gap":
                    shapes[l.name] = (c, 1, 1)
                else:
                    if l.kernel <= 0 or l.stride <= 0 or l.pad < 0 or \
                            h + 2 * l.pad < l.kernel or \
                            w + 2 * l.pad < l.kernel:
                        err(f"pool {l.name!r}: {l.kernel}x{l.kernel}/"
                            f"{l.stride} window (pad={l.pad}) does not fit "
                            f"{c}x{h}x{w} input")
                    shapes[l.name] = (c,
                                      (h + 2 * l.pad - l.kernel) // l.stride + 1,
                                      (w + 2 * l.pad - l.kernel) // l.stride + 1)
            elif l.type == "add":
                ops = [shapes[i] for i in l.inputs]
                if len(ops) != 2:
                    err(f"add {l.name!r} needs exactly 2 inputs, "
                        f"got {len(ops)}")
                if ops[0] != ops[1]:
                    err(f"add {l.name!r} operand shapes differ: "
                        f"{l.inputs[0]}={ops[0]} vs {l.inputs[1]}={ops[1]}")
                shapes[l.name] = ops[0]
            else:                          # concat
                ops = [shapes[i] for i in l.inputs]
                if len(ops) < 2:
                    err(f"concat {l.name!r} needs >= 2 inputs")
                if any(o[1:] != ops[0][1:] for o in ops):
                    err(f"concat {l.name!r} spatial dims differ: "
                        f"{dict(zip(l.inputs, ops))}")
                shapes[l.name] = (sum(o[0] for o in ops),) + ops[0][1:]
            if any(d <= 0 for d in shapes[l.name]):
                err(f"layer {l.name!r} ({l.type}) infers non-positive "
                    f"output shape {shapes[l.name]}")
        return self

    # -- shape inference ----------------------------------------------------
    def infer_shapes(self) -> "NetGraph":
        shapes: Dict[str, tuple] = {}
        for l in self.layers:
            if l.type == "input":
                shapes[l.name] = self.input_shape
            elif l.type == "conv":
                c, h, w = shapes[l.inputs[0]]
                p = (h + 2 * l.pad - l.kernel) // l.stride + 1
                q = (w + 2 * l.pad - l.kernel) // l.stride + 1
                shapes[l.name] = (l.out_channels, p, q)
            elif l.type == "fc":
                shapes[l.name] = (l.out_channels, 1, 1)
            elif l.type == "pool":
                c, h, w = shapes[l.inputs[0]]
                if l.pool_mode == "gap":
                    shapes[l.name] = (c, 1, 1)
                else:
                    p = (h + 2 * l.pad - l.kernel) // l.stride + 1
                    q = (w + 2 * l.pad - l.kernel) // l.stride + 1
                    shapes[l.name] = (c, p, q)
            elif l.type == "add":
                shapes[l.name] = shapes[l.inputs[0]]
            elif l.type == "concat":
                cs = [shapes[i] for i in l.inputs]
                assert all(c[1:] == cs[0][1:] for c in cs)
                shapes[l.name] = (sum(c[0] for c in cs),) + cs[0][1:]
            else:
                raise ValueError(l.type)
            l.out_shape = shapes[l.name]
        return self

    # -- parameter initialisation -------------------------------------------
    def init_params(self, seed: int = 0) -> Dict[str, Dict[str, np.ndarray]]:
        """He-init float32 weights, shaped (K, C/groups, R, S) / fc (K, C)."""
        rng = np.random.default_rng(seed)
        shapes = {l.name: l.out_shape for l in self.layers}
        params: Dict[str, Dict[str, np.ndarray]] = {}
        by = self.by_name()
        for l in self.layers:
            if l.type == "conv":
                cin = by[l.inputs[0]].out_shape[0] if by[l.inputs[0]].out_shape else self.input_shape[0]
                cin_g = cin // l.groups
                fan_in = cin_g * l.kernel * l.kernel
                w = rng.normal(0, np.sqrt(2.0 / fan_in),
                               (l.out_channels, cin_g, l.kernel, l.kernel)).astype(np.float32)
                b = rng.normal(0, 0.05, (l.out_channels,)).astype(np.float32)
                params[l.name] = {"w": w, "b": b}
            elif l.type == "fc":
                cin = int(np.prod(by[l.inputs[0]].out_shape))
                w = rng.normal(0, np.sqrt(2.0 / cin), (l.out_channels, cin)).astype(np.float32)
                b = rng.normal(0, 0.05, (l.out_channels,)).astype(np.float32)
                params[l.name] = {"w": w, "b": b}
        return params

    def num_params(self) -> int:
        return sum(int(a.size) for p in self.init_params(0).values() for a in p.values())

    def macs(self) -> int:
        """Total multiply-accumulates for one inference (for the cycle model)."""
        total = 0
        by = self.by_name()
        for l in self.layers:
            if l.type == "conv":
                cin = by[l.inputs[0]].out_shape[0]
                k, p, q = l.out_shape
                total += (cin // l.groups) * l.kernel * l.kernel * k * p * q
            elif l.type == "fc":
                total += int(np.prod(by[l.inputs[0]].out_shape)) * l.out_channels
        return total


# ===========================================================================
# Model builders (paper Tables II & III)
# ===========================================================================
def lenet5() -> NetGraph:
    """LeNet-5, 1x28x28 input (paper: 9 layers incl. input/softmax bookkeeping)."""
    g = NetGraph("lenet5", (1, 28, 28))
    g.layer(name="data", type="input", inputs=[])
    g.layer(name="conv1", type="conv", inputs=["data"], out_channels=6, kernel=5, pad=2, relu=True)
    g.layer(name="pool1", type="pool", inputs=["conv1"], kernel=2, stride=2, pool_mode="max")
    g.layer(name="conv2", type="conv", inputs=["pool1"], out_channels=16, kernel=5, relu=True)
    g.layer(name="pool2", type="pool", inputs=["conv2"], kernel=2, stride=2, pool_mode="max")
    g.layer(name="fc1", type="fc", inputs=["pool2"], out_channels=120, relu=True)
    g.layer(name="fc2", type="fc", inputs=["fc1"], out_channels=84, relu=True)
    g.layer(name="fc3", type="fc", inputs=["fc2"], out_channels=10)
    return g.infer_shapes()


def _res_basic(g: NetGraph, name: str, x: str, cin: int, cout: int, stride: int) -> str:
    c1 = g.layer(name=f"{name}_c1", type="conv", inputs=[x], out_channels=cout,
                 kernel=3, stride=stride, pad=1, relu=True)
    c2 = g.layer(name=f"{name}_c2", type="conv", inputs=[c1], out_channels=cout,
                 kernel=3, stride=1, pad=1)
    if stride != 1 or cin != cout:
        x = g.layer(name=f"{name}_sc", type="conv", inputs=[x], out_channels=cout,
                    kernel=1, stride=stride)
    return g.layer(name=f"{name}_add", type="add", inputs=[c2, x], relu=True)


def _res_bottleneck(g: NetGraph, name: str, x: str, cin: int, cmid: int, stride: int) -> str:
    cout = cmid * 4
    c1 = g.layer(name=f"{name}_c1", type="conv", inputs=[x], out_channels=cmid, kernel=1, relu=True)
    c2 = g.layer(name=f"{name}_c2", type="conv", inputs=[c1], out_channels=cmid,
                 kernel=3, stride=stride, pad=1, relu=True)
    c3 = g.layer(name=f"{name}_c3", type="conv", inputs=[c2], out_channels=cout, kernel=1)
    if stride != 1 or cin != cout:
        x = g.layer(name=f"{name}_sc", type="conv", inputs=[x], out_channels=cout,
                    kernel=1, stride=stride)
    return g.layer(name=f"{name}_add", type="add", inputs=[c3, x], relu=True)


def resnet18() -> NetGraph:
    """ResNet-18 on 3x32x32 (paper Table II input).

    Uses the standard ImageNet-style stride-2 stem (7x7/2 + maxpool/2): the
    paper's 86-layer prototxt and its 16.2 ms @100MHz measurement are only
    consistent with the downsampling stem (~35 MMACs at 32x32), not with the
    CIFAR 3x3/1 stem (~557 MMACs).
    """
    g = NetGraph("resnet18", (3, 32, 32))
    g.layer(name="data", type="input", inputs=[])
    x = g.layer(name="stem", type="conv", inputs=["data"], out_channels=64,
                kernel=7, stride=2, pad=3, relu=True)
    x = g.layer(name="stem_pool", type="pool", inputs=[x], kernel=3, stride=2,
                pad=1, pool_mode="max")
    cin = 64
    for stage, (cout, blocks, stride) in enumerate([(64, 2, 1), (128, 2, 2),
                                                    (256, 2, 2), (512, 2, 2)]):
        for b in range(blocks):
            x = _res_basic(g, f"s{stage}b{b}", x, cin, cout, stride if b == 0 else 1)
            cin = cout
    x = g.layer(name="gap", type="pool", inputs=[x], pool_mode="gap")
    g.layer(name="fc", type="fc", inputs=[x], out_channels=10)
    return g.infer_shapes()


def resnet50() -> NetGraph:
    """ResNet-50 on 3x224x224 (paper Table II/III input)."""
    g = NetGraph("resnet50", (3, 224, 224))
    g.layer(name="data", type="input", inputs=[])
    x = g.layer(name="stem", type="conv", inputs=["data"], out_channels=64,
                kernel=7, stride=2, pad=3, relu=True)
    x = g.layer(name="stem_pool", type="pool", inputs=[x], kernel=3, stride=2,
                pad=1, pool_mode="max")
    cin = 64
    for stage, (cmid, blocks, stride) in enumerate([(64, 3, 1), (128, 4, 2),
                                                    (256, 6, 2), (512, 3, 2)]):
        for b in range(blocks):
            x = _res_bottleneck(g, f"s{stage}b{b}", x, cin, cmid, stride if b == 0 else 1)
            cin = cmid * 4
    x = g.layer(name="gap", type="pool", inputs=[x], pool_mode="gap")
    g.layer(name="fc", type="fc", inputs=[x], out_channels=1000)
    return g.infer_shapes()


def alexnet() -> NetGraph:
    """AlexNet on 3x227x227 (paper Table III input)."""
    g = NetGraph("alexnet", (3, 227, 227))
    g.layer(name="data", type="input", inputs=[])
    x = g.layer(name="conv1", type="conv", inputs=["data"], out_channels=96,
                kernel=11, stride=4, relu=True)
    x = g.layer(name="pool1", type="pool", inputs=[x], kernel=3, stride=2, pool_mode="max")
    x = g.layer(name="conv2", type="conv", inputs=[x], out_channels=256, kernel=5,
                pad=2, relu=True)
    x = g.layer(name="pool2", type="pool", inputs=[x], kernel=3, stride=2, pool_mode="max")
    x = g.layer(name="conv3", type="conv", inputs=[x], out_channels=384, kernel=3,
                pad=1, relu=True)
    x = g.layer(name="conv4", type="conv", inputs=[x], out_channels=384, kernel=3,
                pad=1, relu=True)
    x = g.layer(name="conv5", type="conv", inputs=[x], out_channels=256, kernel=3,
                pad=1, relu=True)
    x = g.layer(name="pool5", type="pool", inputs=[x], kernel=3, stride=2, pool_mode="max")
    x = g.layer(name="fc6", type="fc", inputs=[x], out_channels=4096, relu=True)
    x = g.layer(name="fc7", type="fc", inputs=[x], out_channels=4096, relu=True)
    g.layer(name="fc8", type="fc", inputs=[x], out_channels=1000)
    return g.infer_shapes()


def mobilenet_v1() -> NetGraph:
    """MobileNet v1 on 3x224x224 (paper Table III input); depthwise-separable convs."""
    g = NetGraph("mobilenet", (3, 224, 224))
    g.layer(name="data", type="input", inputs=[])
    x = g.layer(name="stem", type="conv", inputs=["data"], out_channels=32,
                kernel=3, stride=2, pad=1, relu=True)
    cin = 32
    cfg = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
           (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2), (1024, 1)]
    for i, (cout, stride) in enumerate(cfg):
        x = g.layer(name=f"dw{i}", type="conv", inputs=[x], out_channels=cin,
                    kernel=3, stride=stride, pad=1, groups=cin, relu=True)
        x = g.layer(name=f"pw{i}", type="conv", inputs=[x], out_channels=cout,
                    kernel=1, relu=True)
        cin = cout
    x = g.layer(name="gap", type="pool", inputs=[x], pool_mode="gap")
    g.layer(name="fc", type="fc", inputs=[x], out_channels=1000)
    return g.infer_shapes()


def _inception(g: NetGraph, name: str, x: str, c1: int, c3r: int, c3: int,
               c5r: int, c5: int, cp: int) -> str:
    b1 = g.layer(name=f"{name}_1x1", type="conv", inputs=[x], out_channels=c1, kernel=1, relu=True)
    b2a = g.layer(name=f"{name}_3x3r", type="conv", inputs=[x], out_channels=c3r, kernel=1, relu=True)
    b2 = g.layer(name=f"{name}_3x3", type="conv", inputs=[b2a], out_channels=c3,
                 kernel=3, pad=1, relu=True)
    b3a = g.layer(name=f"{name}_5x5r", type="conv", inputs=[x], out_channels=c5r, kernel=1, relu=True)
    b3 = g.layer(name=f"{name}_5x5", type="conv", inputs=[b3a], out_channels=c5,
                 kernel=5, pad=2, relu=True)
    b4a = g.layer(name=f"{name}_pool", type="pool", inputs=[x], kernel=3, stride=1,
                  pad=1, pool_mode="max")
    b4 = g.layer(name=f"{name}_poolp", type="conv", inputs=[b4a], out_channels=cp,
                 kernel=1, relu=True)
    return g.layer(name=f"{name}_cat", type="concat", inputs=[b1, b2, b3, b4])


def googlenet() -> NetGraph:
    """GoogLeNet on 3x224x224 (paper Table III input)."""
    g = NetGraph("googlenet", (3, 224, 224))
    g.layer(name="data", type="input", inputs=[])
    x = g.layer(name="conv1", type="conv", inputs=["data"], out_channels=64,
                kernel=7, stride=2, pad=3, relu=True)
    x = g.layer(name="pool1", type="pool", inputs=[x], kernel=3, stride=2, pad=1, pool_mode="max")
    x = g.layer(name="conv2r", type="conv", inputs=[x], out_channels=64, kernel=1, relu=True)
    x = g.layer(name="conv2", type="conv", inputs=[x], out_channels=192, kernel=3,
                pad=1, relu=True)
    x = g.layer(name="pool2", type="pool", inputs=[x], kernel=3, stride=2, pad=1, pool_mode="max")
    x = _inception(g, "i3a", x, 64, 96, 128, 16, 32, 32)
    x = _inception(g, "i3b", x, 128, 128, 192, 32, 96, 64)
    x = g.layer(name="pool3", type="pool", inputs=[x], kernel=3, stride=2, pad=1, pool_mode="max")
    x = _inception(g, "i4a", x, 192, 96, 208, 16, 48, 64)
    x = _inception(g, "i4b", x, 160, 112, 224, 24, 64, 64)
    x = _inception(g, "i4c", x, 128, 128, 256, 24, 64, 64)
    x = _inception(g, "i4d", x, 112, 144, 288, 32, 64, 64)
    x = _inception(g, "i4e", x, 256, 160, 320, 32, 128, 128)
    x = g.layer(name="pool4", type="pool", inputs=[x], kernel=3, stride=2, pad=1, pool_mode="max")
    x = _inception(g, "i5a", x, 256, 160, 320, 32, 128, 128)
    x = _inception(g, "i5b", x, 384, 192, 384, 48, 128, 128)
    x = g.layer(name="gap", type="pool", inputs=[x], pool_mode="gap")
    g.layer(name="fc", type="fc", inputs=[x], out_channels=1000)
    return g.infer_shapes()


BUILDERS = {
    "lenet5": lenet5,
    "resnet18": resnet18,
    "resnet50": resnet50,
    "alexnet": alexnet,
    "mobilenet": mobilenet_v1,
    "googlenet": googlenet,
}
