"""Staged compiler pipeline (paper Fig. 1), with inspectable intermediates.

The port's copy of ``repro.core.pipeline``:

    calibrate -> build_loadable -> vp_run -> {parse_trace, extract_weights}
                                          -> assemble

``CompilerPipeline`` exposes those stages by name; each runs only the stages
it depends on, keeps its output for inspection, and is memoised in a
process-wide content-hash cache (SHA-256 over the stage inputs, chained
through the dependency graph).  The reference's ``cost_model`` stage and its
on-disk cache tier come with a later slice.

``Artifacts.save(path)`` writes the bare-metal bundle in the reference's
format 1 (``trace.cfg``, ``weights.img``, ``program.bin``, ``manifest.json``)
and ``Artifacts.load(path)`` rebuilds a runnable artifact set from it, so a
bundle saved by either package loads in the other.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import json
import pathlib
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch.core import asm as asm_mod
from repro_torch.core import engine, memory, tracegen
from repro_torch.core.graph import NetGraph
from repro_torch.core.loadable import Loadable, build_loadable, calibrate
from repro_torch.core.tracegen import Trace
from repro_torch.core.vp import VirtualPlatform

# ---------------------------------------------------------------------------
# Artifacts: the pipeline's product, and the shippable bare-metal bundle
# ---------------------------------------------------------------------------
_BUNDLE_FILES = ("trace.cfg", "weights.img", "program.bin", "manifest.json")


@dataclasses.dataclass
class Artifacts:
    """Everything the bare-metal SoC needs (and nothing else).

    The first block is the shipped bundle (the paper's three files + scales);
    the second block holds compile-time intermediates that only exist on a
    freshly compiled artifact set (``None`` after ``Artifacts.load``).
    """
    graph_name: str
    cfg: engine.EngineConfig
    trace: Trace                     # configuration file
    trace_text: str                  # its serialised form
    weight_image: Dict[int, bytes]   # extracted, deduped preload image
    program_binary: bytes            # assembled program-memory image
    input_scale: float
    output_scale: float
    output_elems: int
    # kernel plans a bundle's manifest may carry (the reference compiler's
    # cost_model stage writes them).  This port's compiler has no cost_model
    # stage yet and leaves them None; a loaded bundle keeps them as they were
    # so it saves back unchanged.  Bucket keys are stringified in the JSON
    # manifest and normalised back to int on load.
    kernel_plan: Optional[list] = None
    batched_kernel_plans: Optional[dict] = None
    # -- compile-time intermediates (not shipped) ----------------------------
    asm_text: str = ""               # RISC-V assembly listing
    loadable: Optional[Loadable] = None
    vp_output: Optional[np.ndarray] = None      # VP reference output (float)
    vp_output_int8: Optional[np.ndarray] = None

    # -- storage accounting (Table I analogue) -------------------------------
    def storage_report(self) -> Dict[str, int]:
        wbytes = sum(len(b) for b in self.weight_image.values())
        return {
            "config_file_bytes": len(self.trace_text.encode()),
            "program_binary_bytes": len(self.program_binary),
            "weight_image_bytes": wbytes,
            "n_write_reg": self.trace.n_writes,
            "n_read_reg": self.trace.n_reads,
        }

    # -- bundle serialisation ------------------------------------------------
    def save(self, path) -> pathlib.Path:
        """Write the bare-metal bundle: trace.cfg + weights.img + program.bin.

        The weight image is stored as one flat blob; the manifest records the
        (address, length) segment table plus the engine config and I/O scales.
        """
        p = pathlib.Path(path)
        p.mkdir(parents=True, exist_ok=True)
        segs = sorted(self.weight_image.items())
        (p / "trace.cfg").write_text(self.trace_text)
        (p / "weights.img").write_bytes(b"".join(b for _, b in segs))
        (p / "program.bin").write_bytes(self.program_binary)
        manifest = {
            "format": 1,
            "graph_name": self.graph_name,
            "cfg": dataclasses.asdict(self.cfg),
            "input_scale": self.input_scale,
            "output_scale": self.output_scale,
            "output_elems": self.output_elems,
            "weight_segments": [[addr, len(b)] for addr, b in segs],
        }
        if self.kernel_plan is not None:
            manifest["kernel_plan"] = self.kernel_plan
        if self.batched_kernel_plans is not None:
            manifest["batched_kernel_plans"] = {
                str(b): plan for b, plan in
                sorted(self.batched_kernel_plans.items())}
        (p / "manifest.json").write_text(json.dumps(manifest, indent=1))
        return p

    @classmethod
    def load(cls, path) -> "Artifacts":
        """Rebuild a runnable artifact set from a saved bundle (no recompile).

        Raises ``FileNotFoundError`` when bundle files are missing, and
        ``ValueError`` (naming the file and the problem) for a corrupt
        manifest, an unsupported bundle format version, or a weight image
        shorter than its manifest segment table claims.
        """
        p = pathlib.Path(path)
        missing = [f for f in _BUNDLE_FILES if not (p / f).exists()]
        if missing:
            raise FileNotFoundError(f"{p} is not an artifact bundle "
                                    f"(missing {', '.join(missing)})")
        try:
            manifest = json.loads((p / "manifest.json").read_text())
        except json.JSONDecodeError as e:
            raise ValueError(f"{p / 'manifest.json'}: corrupt manifest "
                             f"(not valid JSON: {e})") from None
        fmt = manifest.get("format")
        if fmt != 1:
            raise ValueError(f"{p / 'manifest.json'}: unsupported bundle "
                             f"format version {fmt!r} (this build reads "
                             f"format 1)")
        required = ("graph_name", "cfg", "input_scale", "output_scale",
                    "output_elems", "weight_segments")
        absent = [k for k in required if k not in manifest]
        if absent:
            raise ValueError(f"{p / 'manifest.json'}: manifest missing "
                             f"required keys: {', '.join(absent)}")
        trace_text = (p / "trace.cfg").read_text()
        blob = (p / "weights.img").read_bytes()
        need = sum(n for _, n in manifest["weight_segments"])
        if need > len(blob):
            raise ValueError(
                f"{p / 'weights.img'}: truncated weight image — manifest "
                f"segment table needs {need} bytes, file has {len(blob)}")
        weight_image: Dict[int, bytes] = {}
        off = 0
        for addr, n in manifest["weight_segments"]:
            weight_image[addr] = blob[off:off + n]
            off += n
        return cls(
            graph_name=manifest["graph_name"],
            cfg=engine.EngineConfig(**manifest["cfg"]),
            trace=Trace.from_text(trace_text),
            trace_text=trace_text,
            weight_image=weight_image,
            program_binary=(p / "program.bin").read_bytes(),
            input_scale=manifest["input_scale"],
            output_scale=manifest["output_scale"],
            output_elems=manifest["output_elems"],
            kernel_plan=manifest.get("kernel_plan"),
            batched_kernel_plans={
                int(b): plan for b, plan in
                manifest["batched_kernel_plans"].items()}
            if "batched_kernel_plans" in manifest else None,
        )



# ---------------------------------------------------------------------------
# Content-hash stage cache (process-wide, bounded LRU).  Cached objects are
# shared between pipelines with equal fingerprints — treat stage outputs and
# the Artifacts built from them as immutable.
# ---------------------------------------------------------------------------
_CACHE: "collections.OrderedDict[str, Any]" = collections.OrderedDict()
_CACHE_MAX = 128
_CACHE_STATS = {"hits": 0, "misses": 0}


def clear_cache() -> None:
    """Reset the cache and its counters."""
    _CACHE.clear()
    for k in _CACHE_STATS:
        _CACHE_STATS[k] = 0


def cache_stats() -> Dict[str, int]:
    return dict(_CACHE_STATS, entries=len(_CACHE))


def _cache_put(key: str, value: Any) -> None:
    _CACHE[key] = value
    _CACHE.move_to_end(key)
    while len(_CACHE) > _CACHE_MAX:
        _CACHE.popitem(last=False)


def _hash_update_array(h, a: Optional[np.ndarray]) -> None:
    if a is None:
        h.update(b"none")
    else:
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(np.ascontiguousarray(a).tobytes())


def _fingerprint(graph: NetGraph, params, calib_samples, cfg, sample_input,
                 calibration=None) -> str:
    """SHA-256 over everything the pipeline's output depends on."""
    h = hashlib.sha256()
    if calibration is not None:
        h.update(repr(sorted(calibration.scales.items())).encode())
    h.update(graph.name.encode())
    h.update(graph.source_digest.encode())
    h.update(str(graph.input_shape).encode())
    for l in graph.layers:
        h.update(repr(dataclasses.astuple(l)).encode())
    for lname in sorted(params):
        h.update(lname.encode())
        for k in sorted(params[lname]):
            _hash_update_array(h, params[lname][k])
    _hash_update_array(h, calib_samples)
    _hash_update_array(h, sample_input)
    h.update(repr(dataclasses.astuple(cfg)).encode())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# Stage graph
# ---------------------------------------------------------------------------
def _stage_calibrate(p: "CompilerPipeline"):
    return calibrate(p.graph, p.params, p.calib_samples)


def _stage_build_loadable(p: "CompilerPipeline"):
    return build_loadable(p.graph, p.params, p.stage("calibrate"), p.cfg)


def _stage_vp_run(p: "CompilerPipeline"):
    return VirtualPlatform(p.stage("build_loadable")).run(p.sample_input)


def _stage_parse_trace(p: "CompilerPipeline"):
    return tracegen.parse_csb(p.stage("vp_run").log)


def _stage_extract_weights(p: "CompilerPipeline"):
    return memory.extract_weights(tracegen.parse_dbb(p.stage("vp_run").log))


def _stage_assemble(p: "CompilerPipeline"):
    return asm_mod.assemble(p.stage("parse_trace"))


_STAGES: Dict[str, Tuple[Tuple[str, ...], Callable]] = {
    # name            -> (dependencies, fn)
    "calibrate":       ((), _stage_calibrate),
    "build_loadable":  (("calibrate",), _stage_build_loadable),
    "vp_run":          (("build_loadable",), _stage_vp_run),
    "parse_trace":     (("vp_run",), _stage_parse_trace),
    "extract_weights": (("vp_run",), _stage_extract_weights),
    "assemble":        (("parse_trace",), _stage_assemble),
}

STAGE_NAMES = tuple(_STAGES)


class CompilerPipeline:
    """The paper's toolflow as named, individually-runnable stages.

        pipe = CompilerPipeline(graph)
        cal = pipe.run_stage("calibrate")      # inspect any intermediate
        art = pipe.run()                       # full Artifacts

    Defaults match the reference: ``params`` from ``graph.init_params(seed)``
    and two calibration samples from ``default_rng(seed + 1)``, so both
    packages compile the same bundle from the same graph and seed.
    """

    stages = STAGE_NAMES

    def __init__(self, graph: NetGraph, params=None,
                 calib_samples: Optional[np.ndarray] = None,
                 cfg: engine.EngineConfig = engine.NV_SMALL,
                 sample_input: Optional[np.ndarray] = None,
                 seed: int = 0, use_cache: bool = True, calibration=None):
        self.graph = graph.validate()
        self.cfg = cfg
        self.use_cache = use_cache
        self.params = params if params is not None else graph.init_params(seed)
        if calib_samples is None:
            rng = np.random.default_rng(seed + 1)
            calib_samples = rng.normal(
                0, 1, (2,) + graph.input_shape).astype(np.float32)
        self.calib_samples = calib_samples
        self.sample_input = (sample_input if sample_input is not None
                             else calib_samples[0])
        self._results: Dict[str, Any] = {}
        # a pre-computed CalibrationTable overrides the calibrate stage
        if calibration is not None:
            self._results["calibrate"] = calibration
        self._root = _fingerprint(graph, self.params, self.calib_samples,
                                  cfg, self.sample_input, calibration)
        self._keys: Dict[str, str] = {}

    def _key(self, name: str) -> str:
        if name not in self._keys:
            deps, _ = _STAGES[name]
            h = hashlib.sha256(self._root.encode())
            h.update(name.encode())
            for d in deps:
                h.update(self._key(d).encode())
            self._keys[name] = h.hexdigest()
        return self._keys[name]

    def run_stage(self, name: str):
        """Run one stage (and any stages it depends on); return its output."""
        if name not in _STAGES:
            raise ValueError(f"unknown stage {name!r}; stages: "
                             f"{', '.join(STAGE_NAMES)}")
        if name in self._results:
            return self._results[name]
        key = self._key(name)
        if self.use_cache and key in _CACHE:
            _CACHE_STATS["hits"] += 1
            _CACHE.move_to_end(key)
            out = _CACHE[key]
        else:
            deps, fn = _STAGES[name]
            for d in deps:
                self.run_stage(d)
            _CACHE_STATS["misses"] += 1
            out = fn(self)
            if self.use_cache:
                _cache_put(key, out)
        self._results[name] = out
        return out

    # alias used by the stage functions themselves
    stage = run_stage

    @property
    def results(self) -> Dict[str, Any]:
        """Stage outputs computed so far (inspectable intermediates)."""
        return dict(self._results)

    def run(self) -> Artifacts:
        """Run every stage and assemble the final Artifacts."""
        for name in STAGE_NAMES:
            self.run_stage(name)
        r = self._results
        trace: Trace = r["parse_trace"]
        asm_text, binary = r["assemble"]
        ld: Loadable = r["build_loadable"]
        vp = r["vp_run"]
        out_shape = self.graph.by_name()[self.graph.output].out_shape
        return Artifacts(
            graph_name=self.graph.name, cfg=self.cfg,
            trace=trace, trace_text=trace.to_text(),
            weight_image=r["extract_weights"],
            program_binary=binary, asm_text=asm_text,
            input_scale=ld.input_scale, output_scale=ld.output_scale,
            output_elems=int(np.prod(out_shape)),
            loadable=ld, vp_output=vp.output, vp_output_int8=vp.output_int8)
