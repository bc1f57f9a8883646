"""Carry a network's float parameters from the reference package to the port.

Parameters are plain data in both packages: ``NetGraph.init_params`` returns
``{layer: {"w": array, "b": array}}`` of float32 numpy arrays, conv weights
shaped (K, C/groups, R, S) and fc weights (K, C).  ``params_from_reference``
checks such a dict against the port's graph (names, shapes, dtypes) and
returns the port's own copy, from which both compilers build the same bundle.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core.graph import NetGraph


def param_shapes(graph: NetGraph) -> Dict[str, Dict[str, tuple]]:
    """The shape of every parameter ``graph.init_params`` would make."""
    by = graph.by_name()
    shapes: Dict[str, Dict[str, tuple]] = {}
    for l in graph.layers:
        if l.type == "conv":
            cin = by[l.inputs[0]].out_shape[0]
            shapes[l.name] = {"w": (l.out_channels, cin // l.groups,
                                    l.kernel, l.kernel),
                              "b": (l.out_channels,)}
        elif l.type == "fc":
            cin = int(np.prod(by[l.inputs[0]].out_shape))
            shapes[l.name] = {"w": (l.out_channels, cin),
                              "b": (l.out_channels,)}
    return shapes


def params_from_reference(params, graph: NetGraph) -> Dict[str, Dict[str, np.ndarray]]:
    """Checked float32 copies of the reference's parameters for ``graph``.

    Raises ``ValueError`` naming the first layer or tensor whose name, shape
    or dtype does not match what the port's graph expects.
    """
    want = param_shapes(graph)
    if set(params) != set(want):
        raise ValueError(f"parameter layers {sorted(params)} do not match the "
                         f"graph's CONV/FC layers {sorted(want)}")
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for name, tensors in want.items():
        got = params[name]
        if set(got) != set(tensors):
            raise ValueError(f"{name}: tensors {sorted(got)}, expected "
                             f"{sorted(tensors)}")
        out[name] = {}
        for key, shape in tensors.items():
            a = np.asarray(got[key])
            if a.dtype != np.float32:
                raise ValueError(f"{name}.{key}: dtype {a.dtype}, expected "
                                 f"float32")
            if a.shape != shape:
                raise ValueError(f"{name}.{key}: shape {a.shape}, expected "
                                 f"{shape}")
            out[name][key] = a.copy()
    return out
