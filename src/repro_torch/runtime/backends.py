"""Registered executor backends.

``baremetal`` — the bundle's descriptors replayed over a device-resident
                arena, every CONV/FC through the int8 conv kernel (the
                paper's SoC).
``ref``       — pure-numpy descriptor replay on the reference ops
                (``core/refops.py``); the slow golden model the fast backend
                is held against.  It runs on the host whatever the device.

Both consume ONLY the two bare-metal artifacts (configuration trace + weight
image), so every backend can serve a bundle loaded from disk.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import engine, refops
from repro_torch.core.executor import (BareMetalExecutor, ExecResult,
                                       ExecutorCapabilities, _ExecutorBase)
from repro_torch.runtime.registry import register_backend


def _executor_kwargs(art) -> dict:
    return dict(input_scale=art.input_scale, output_scale=art.output_scale,
                output_elems=art.output_elems)


@register_backend("baremetal")
def _make_baremetal(art, device="cuda", **kw):
    return BareMetalExecutor(art.trace, art.weight_image, art.cfg,
                             device=device, **_executor_kwargs(art), **kw)


class RefExecutor(_ExecutorBase):
    """Numpy golden model: replays the decoded descriptors with core/refops
    (integer-exact int8)."""

    def capabilities(self) -> ExecutorCapabilities:
        return ExecutorCapabilities(dtype=self.cfg.dtype, kernels=("refops",))

    def run(self, x: np.ndarray) -> ExecResult:
        xq = self._quant_in(x)
        dram = self.arena0.copy()
        x_bytes = np.ascontiguousarray(xq.reshape(-1)).view(np.uint8)
        dram[self.input_off:self.input_off + x_bytes.size] = x_bytes
        for d in self.descs:
            self._exec(d, dram)
        out = dram[self.output_off:self.output_off + self.output_bytes]
        return self._finish_out(out.copy().view(np.int8))

    def _exec(self, d: engine.Descriptor, dram: np.ndarray) -> None:
        base = self.base
        _, c, h, w = d.src_dims
        _, k, p, q = d.dst_dims

        def surf(addr, dims):
            _, c_, h_, w_ = dims
            off = addr - base
            return dram[off:off + c_ * h_ * w_].view(np.int8).reshape(c_, h_, w_)

        if d.unit in ("CONV", "FC"):
            r, s = d.kernel
            cin_g = c // d.groups if d.unit == "CONV" else c * h * w
            wt_n = k * cin_g * (r * s if d.unit == "CONV" else 1)
            wo, bo, so = d.wt_addr - base, d.bias_addr - base, d.scale_addr - base
            wq = dram[wo:wo + wt_n].view(np.int8).reshape(k, -1)
            bias = dram[bo:bo + 4 * k].view(np.int32)
            words = dram[so:so + 4 * k].view(np.uint32)
            x = surf(d.src_addr, d.src_dims)
            if d.unit == "CONV":
                y = refops.conv_int8(x, wq, bias, words, r, d.stride, d.pad,
                                     d.groups, d.relu)
            else:
                y = refops.fc_int8(x, wq, bias, words, d.relu)
        elif d.unit == "PDP":
            x = surf(d.src_addr, d.src_dims)
            r, s = d.kernel
            if d.pool_mode == 1:
                y = refops.maxpool_int8(x, r, d.stride, d.pad)
            else:
                word = engine._pack_scale(d.out_scale)
                if (r, s) == (h, w) and d.pad == 0:
                    y = refops.gap_int8(x, word)
                else:
                    y = refops.avgpool_int8(x, r, d.stride, d.pad, word)
        elif d.unit == "EW":
            a = surf(d.src_addr, d.src_dims)
            b = surf(d.aux_addr, d.src_dims)
            y = refops.add_int8(a, b, engine._pack_scale(d.out_scale),
                                engine._pack_scale(d.aux_scale), d.relu)
        else:
            raise ValueError(d.unit)
        flat = np.asarray(y).reshape(-1)
        doff = d.dst_addr - base
        dram[doff:doff + flat.size] = flat.view(np.uint8)


@register_backend("ref")
def _make_ref(art, device=None, **kw):
    del device                      # the numpy golden model runs on the host
    return RefExecutor(art.trace, art.weight_image, art.cfg,
                       **_executor_kwargs(art), **kw)
