"""The port's ``BareMetalExecutor`` and ``Session`` against the reference.

Every net is compiled by both packages from the same parameters; the port
runs on the CPU (plain versions of its kernels) and its int8 outputs must be
byte-equal to the reference's ``BareMetalExecutor`` and ``VirtualPlatform``,
single image and batched with dead (zero) padding lanes.  Reference
``linuxstack`` is never the oracle (it corrupts the heap on
``_stride_pad_net``).  Tolerance: byte equality.
"""

import numpy as np
import pytest

from repro.core import graph as jgraph
from repro.core import pipeline as jpipe
from repro.core.vp import VirtualPlatform
from repro.runtime import create_executor as jcreate
from repro_torch.convert import params_from_reference
from repro_torch.core import graph as tgraph
from repro_torch.core import perfmodel
from repro_torch.core import pipeline as tpipe
from repro_torch.runtime import Session, backend_names, create_executor


def _residual_net(g_mod):
    g = g_mod.NetGraph("resid", (3, 12, 12))
    g.layer(name="data", type="input", inputs=[])
    x = g.layer(name="stem", type="conv", inputs=["data"], out_channels=6,
                kernel=3, pad=1, relu=True)
    c1 = g.layer(name="c1", type="conv", inputs=[x], out_channels=6,
                 kernel=3, pad=1, relu=True)
    c2 = g.layer(name="c2", type="conv", inputs=[c1], out_channels=6,
                 kernel=3, pad=1)
    x = g.layer(name="add", type="add", inputs=[c2, x], relu=True)
    x = g.layer(name="gap", type="pool", inputs=[x], pool_mode="gap")
    g.layer(name="fc", type="fc", inputs=[x], out_channels=4)
    return g.infer_shapes()


def _stride_pad_net(g_mod):
    g = g_mod.NetGraph("stride_pad", (3, 17, 17))
    g.layer(name="data", type="input", inputs=[])
    x = g.layer(name="c1", type="conv", inputs=["data"], out_channels=8,
                kernel=5, stride=2, pad=2, relu=True)
    x = g.layer(name="c2", type="conv", inputs=[x], out_channels=12,
                kernel=3, stride=2, pad=1, relu=True)
    x = g.layer(name="p1", type="pool", inputs=[x], kernel=3, stride=2, pad=1,
                pool_mode="max")
    x = g.layer(name="c3", type="conv", inputs=[x], out_channels=16,
                kernel=3, stride=1, pad=0, relu=True)
    g.layer(name="fc", type="fc", inputs=[x], out_channels=5)
    return g.infer_shapes()


def _bigk_net(g_mod):
    """K = 520*9 = 4680 > EXACT_K (mirrors the reference's large-K test)."""
    g = g_mod.NetGraph("bigk", (520, 4, 4))
    g.layer(name="data", type="input", inputs=[])
    x = g.layer(name="c1", type="conv", inputs=["data"], out_channels=8,
                kernel=3, pad=1, relu=True)
    g.layer(name="fc", type="fc", inputs=[x], out_channels=3)
    return g.infer_shapes()


NETS = {"lenet5": lambda m: m.lenet5(), "stride": _stride_pad_net,
        "resid": _residual_net, "bigk": _bigk_net}


def _compile(build, seed=0):
    jg, tg = build(jgraph), build(tgraph)
    params = jg.init_params(seed)
    ja = jpipe.CompilerPipeline(jg, params=params).run()
    ta = tpipe.CompilerPipeline(tg, params=params_from_reference(params, tg)).run()
    return ja, ta


def _inputs(shape, n, seed):
    return np.random.default_rng(seed).normal(0, 1, (n,) + shape).astype(np.float32)


@pytest.fixture(scope="module", params=sorted(NETS))
def net(request):
    ja, ta = _compile(NETS[request.param])
    return request.param, ja, ta


def test_single_image_matches_reference_and_vp(net):
    _, ja, ta = net
    shape = ta.loadable.graph.input_shape
    ses = Session(ta, device="cpu")
    jex = jcreate("baremetal", ja)
    vp = VirtualPlatform(ja.loadable)
    for x in _inputs(shape, 3, 1):
        got = ses.run(x)
        want = jex.run(x).output_int8
        np.testing.assert_array_equal(got.output_int8, want)
        np.testing.assert_array_equal(got.output_int8, vp.run(x).output_int8)
        np.testing.assert_array_equal(got.output,
                                      want.astype(np.float32) * ta.output_scale)


def test_run_batch_with_dead_lanes_matches_reference(net):
    """5 live lanes padded with zero lanes to bucket 8, trimmed to 5."""
    _, ja, ta = net
    shape = ta.loadable.graph.input_shape
    X = _inputs(shape, 5, 2)
    ses = Session(ta, device="cpu")
    assert ses.bucket_for(5) == 8
    got = ses.run_batch(X).output_int8
    assert got.shape == (5, ta.output_elems)
    seq = np.stack([ses.run(x).output_int8 for x in X])
    np.testing.assert_array_equal(got, seq)
    padded = np.concatenate([X, np.zeros((3,) + shape, np.float32)])
    want = jcreate("baremetal", ja).run_batch(padded, lanes=5).output_int8
    np.testing.assert_array_equal(got, want)


def test_ref_backend_is_byte_equal(net):
    _, _, ta = net
    x = _inputs(ta.loadable.graph.input_shape, 1, 3)[0]
    np.testing.assert_array_equal(
        create_executor("ref", ta).run(x).output_int8,
        create_executor("baremetal", ta, device="cpu").run(x).output_int8)


@pytest.fixture(scope="module")
def resnet18():
    return _compile(lambda m: m.resnet18())


def test_resnet18_full_width(resnet18):
    """ResNet-18 at full widths (64..512, K up to 4608): single images and a
    3-lane batch (bucket 4, one dead lane) byte-equal to the reference."""
    ja, ta = resnet18
    X = _inputs(ta.loadable.graph.input_shape, 3, 4)
    jex = jcreate("baremetal", ja)
    want = np.stack([jex.run(x).output_int8 for x in X])
    ses = Session(ta, device="cpu")
    np.testing.assert_array_equal(ses.run(X[0]).output_int8, want[0])
    np.testing.assert_array_equal(ses.run_batch(X).output_int8, want)
    np.testing.assert_array_equal(ses.run(X[1]).output_int8, want[1])


def test_resnet18_matches_compile_time_vp(resnet18):
    _, ta = resnet18
    x = tpipe.CompilerPipeline(tgraph.resnet18()).sample_input
    ex = create_executor("baremetal", ta, device="cpu")
    np.testing.assert_array_equal(ex.run(x).output_int8, ta.vp_output_int8)


@pytest.fixture(scope="module")
def lenet_art():
    return tpipe.CompilerPipeline(tgraph.lenet5()).run()


def test_executor_contract(lenet_art):
    ex = create_executor("baremetal", lenet_art, device="cpu")
    caps = ex.capabilities()
    assert caps.native_batching and caps.resident_arena and caps.profileable
    assert caps.kernels == (perfmodel.KERNEL_TORCH_INT8,)
    assert ex.compile_count == 0
    X = _inputs((1, 28, 28), 8, 5)
    full = ex.run_batch(X)
    assert full.output_int8.shape == (8, lenet_art.output_elems)
    np.testing.assert_array_equal(ex.run_batch(X, lanes=3).output_int8,
                                  full.output_int8[:3])
    # the resident arena is reused across calls without leaking state
    np.testing.assert_array_equal(ex.run(X[0]).output_int8, full.output_int8[0])
    np.testing.assert_array_equal(ex.run(X[7]).output_int8, full.output_int8[7])
    xq = ((X[2] / ex.input_scale).round().clip(-128, 127)).astype(np.int8)
    np.testing.assert_array_equal(ex.run(xq).output_int8, full.output_int8[2])


def test_arena_integrity(lenet_art):
    ex = create_executor("baremetal", lenet_art, device="cpu")
    x = _inputs((1, 28, 28), 1, 6)[0]
    want = ex.run(x).output_int8
    assert ex.arena_ok()
    off, b = ex._preload[0]
    ex.arena0[off:off + 4] ^= 0xFF
    assert not ex.arena_ok()
    ex.reset_arena()
    assert ex.arena_ok()
    np.testing.assert_array_equal(ex.run(x).output_int8, want)


def test_run_profiled(lenet_art):
    ex = create_executor("baremetal", lenet_art, device="cpu")
    x = _inputs((1, 28, 28), 1, 7)[0]
    res, samples = ex.run_profiled(x)
    np.testing.assert_array_equal(res.output_int8, ex.run(x).output_int8)
    assert [s["unit"] for s in samples] == [d.unit for d in ex.descs]
    assert all(s["us"] >= 0 for s in samples)
    gemms = [s for s in samples if s["unit"] in ("CONV", "FC")]
    assert {s["kernel"] for s in gemms} == {perfmodel.KERNEL_TORCH_INT8}


def test_session_api(lenet_art, tmp_path):
    assert backend_names() == ["baremetal", "ref"]
    lenet_art.save(tmp_path)
    ses = Session.from_bundle(tmp_path, device="cpu")
    assert ses.networks == ["lenet5"]
    ses.load(lenet_art, name="golden", backend="ref")
    assert ses.networks == ["lenet5", "golden"]
    x = _inputs((1, 28, 28), 1, 8)[0]
    np.testing.assert_array_equal(ses.run(x).output_int8,
                                  ses.run(x, net="golden").output_int8)
    with pytest.raises(ValueError, match="already resident"):
        ses.load(lenet_art)
    with pytest.raises(KeyError, match="no resident network"):
        ses.run(x, net="nope")
    with pytest.raises(ValueError, match="bad input"):
        ses.run(np.zeros(5, np.float32))
    with pytest.raises(ValueError, match="unknown executor backend"):
        Session(lenet_art, backend="linuxstack", device="cpu")
    X = _inputs((1, 28, 28), 11, 9)              # 8 + 3: two groups
    got = ses.run_batch(X).output_int8
    np.testing.assert_array_equal(got, np.stack([ses.run(v).output_int8
                                                 for v in X]))
