"""Serving-side Session API (synchronous).

A ``Session`` owns one or more compiled networks, each bound to a registered
executor backend on one device:

    art = CompilerPipeline(graph.resnet18()).run()
    ses = Session(art)                        # baremetal on cuda
    y = ses.run(x)                            # one image
    ys = ses.run_batch(X)                     # (N, ...), byte-exact vs N runs
    ses = Session.from_bundle("bundle_dir/")  # serve a saved bundle

``run_batch`` cuts ``X`` into groups of at most ``MAX_BATCH`` lanes, pads
each group with zero lanes to the next rung of the bucket ladder
(``perfmodel.bucket_ladder(MAX_BATCH)``, the reference scheduler's default
ladder), runs it as one batch and trims the padding, as the reference
scheduler's ``pad_batch`` does.

The reference's threaded scheduler (coalescing, deadlines, watchdog, circuit
breaker), fault injection, observability and HTTP serving come with a later
slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import perfmodel
from repro_torch.core.executor import ExecResult, resolve_device
from repro_torch.core.pipeline import Artifacts
from repro_torch.runtime import registry

MAX_BATCH = 8           # the reference SchedulerConfig's default ceiling
BUCKETS = perfmodel.bucket_ladder(MAX_BATCH)


def pad_batch(xs, bucket: int) -> np.ndarray:
    """Stack request inputs into a (bucket, ...) batch, zero-padding the tail
    lanes.  Padding changes no live lane's bytes: the replay is
    lane-independent."""
    X = np.stack([np.asarray(x) for x in xs])
    if X.shape[0] < bucket:
        pad = np.zeros((bucket - X.shape[0],) + X.shape[1:], X.dtype)
        X = np.concatenate([X, pad])
    return X


@dataclasses.dataclass
class _Net:
    name: str
    executor: object
    input_elems: Optional[int] = None


class Session:
    """Multi-network inference session over registered executor backends."""

    def __init__(self, artifacts: Optional[Artifacts] = None,
                 backend: str = "baremetal", name: Optional[str] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.default_backend = backend
        self._nets: Dict[str, _Net] = {}
        self._order: List[str] = []
        if artifacts is not None:
            self.load(artifacts, name=name, backend=backend)

    @classmethod
    def from_bundle(cls, path, backend: str = "baremetal",
                    name: Optional[str] = None, device="cuda") -> "Session":
        """Build a Session straight from a saved bundle — no recompilation."""
        return cls(Artifacts.load(path), backend=backend, name=name,
                   device=device)

    # -- residency -----------------------------------------------------------
    def load(self, artifacts: Artifacts, name: Optional[str] = None,
             backend: Optional[str] = None) -> str:
        """Make ``artifacts`` resident under ``name``; returns the name."""
        name = name or artifacts.graph_name
        if name in self._nets:
            raise ValueError(f"network {name!r} already resident "
                             f"(load it under a different name)")
        ex = registry.create(backend or self.default_backend, artifacts,
                             device=self.device)
        dims = getattr(ex, "input_dims", None)
        self._order.append(name)
        self._nets[name] = _Net(
            name=name, executor=ex,
            input_elems=int(np.prod(dims[1:])) if dims is not None else None)
        return name

    @property
    def networks(self) -> List[str]:
        return list(self._order)

    def _resolve(self, net: Optional[str]) -> _Net:
        if net is None:
            if not self._order:
                raise ValueError("session has no resident network; "
                                 "load(artifacts) first")
            net = self._order[0]
        try:
            return self._nets[net]
        except KeyError:
            raise KeyError(f"no resident network {net!r}; resident: "
                           f"{', '.join(self._order) or '(none)'}") from None

    def executor(self, net: Optional[str] = None):
        return self._resolve(net).executor

    # -- serving -------------------------------------------------------------
    def _check_input(self, n: _Net, x) -> np.ndarray:
        """Fail fast on a malformed input; canonicalise to a flat int8
        (pre-quantised, passed through) or float32 vector."""
        x = np.asarray(x)
        want = n.input_elems
        if want is not None and (x.dtype == object or x.size != want):
            raise ValueError(
                f"bad input for network {n.name!r}: got dtype={x.dtype} "
                f"size={x.size}, expected {want} elements")
        if x.dtype != np.int8:
            x = x.astype(np.float32, copy=False)
        return x.reshape(-1)

    def run(self, x: np.ndarray, net: Optional[str] = None) -> ExecResult:
        """One inference on one input image."""
        n = self._resolve(net)
        return n.executor.run(self._check_input(n, x))

    @staticmethod
    def bucket_for(lanes: int) -> int:
        """The smallest rung of the ladder that holds ``lanes``."""
        return next(b for b in BUCKETS if b >= lanes)

    def run_batch(self, X: np.ndarray, net: Optional[str] = None) -> ExecResult:
        """Batched inference over ``X`` of shape ``(N, ...)``, byte-exact
        (int8) against N sequential ``run`` calls."""
        n = self._resolve(net)
        xs = [self._check_input(n, x) for x in np.asarray(X)]
        outs = []
        for lo in range(0, len(xs), MAX_BATCH):
            group = xs[lo:lo + MAX_BATCH]
            padded = pad_batch(group, self.bucket_for(len(group)))
            outs.append(n.executor.run_batch(padded, lanes=len(group)))
        return ExecResult(
            output_int8=np.concatenate([o.output_int8 for o in outs]),
            output=np.concatenate([o.output for o in outs]))
