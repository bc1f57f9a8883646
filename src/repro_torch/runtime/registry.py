"""Executor-backend registry (the port's copy of ``repro.runtime.registry``).

Backends register themselves with the ``@register_backend("name")`` decorator;
``create(kind, artifacts)`` instantiates one from an :class:`Artifacts` set
and verifies it satisfies the uniform executor contract (``run`` /
``run_batch(padded, lanes)`` / ``capabilities()``) — the Session drives
every backend through that contract alone, with no per-backend special
cases.  Unknown backend names raise with the list of
registered backends — no silent fallback.
"""

from __future__ import annotations

from typing import Callable, Dict, List

_PROTOCOL_METHODS = ("run", "run_batch", "capabilities")


_BACKENDS: Dict[str, Callable] = {}


def register_backend(name: str) -> Callable:
    """Decorator: register ``factory(artifacts, **kw) -> executor`` as ``name``."""
    def deco(factory: Callable) -> Callable:
        if name in _BACKENDS:
            raise ValueError(f"backend {name!r} already registered")
        _BACKENDS[name] = factory
        return factory
    return deco


def backend_names() -> List[str]:
    return sorted(_BACKENDS)


def create(kind: str, artifacts, **kw):
    """Instantiate the ``kind`` backend over ``artifacts``.

    Raises ``ValueError`` naming the registered backends for unknown kinds,
    and ``TypeError`` when a factory returns an object that does not satisfy
    the ``ExecutorBackend`` protocol.
    """
    try:
        factory = _BACKENDS[kind]
    except KeyError:
        raise ValueError(
            f"unknown executor backend {kind!r}; registered backends: "
            f"{', '.join(backend_names())}") from None
    ex = factory(artifacts, **kw)
    missing = [m for m in _PROTOCOL_METHODS
               if not callable(getattr(ex, m, None))]
    if missing:
        raise TypeError(
            f"backend {kind!r} factory returned {type(ex).__name__}, which "
            f"does not satisfy the executor contract "
            f"(missing: {', '.join(missing)}); executors must provide "
            f"run(x), run_batch(X, lanes=None) and capabilities()")
    return ex
