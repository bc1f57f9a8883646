"""The port's nv_full (bf16) datapath, end to end, against the reference.

Both packages compile the same graph at ``NV_FULL`` from the same float
parameters (carried across by ``repro_torch.convert.params_from_reference``):

  * the compilers emit byte-identical bundles (trace, weight image, program
    binary) and VP output bytes, and a bundle saved by either package loads
    in the other;
  * the port's numpy ``ref`` backend is byte-identical to the reference's;
  * the port's ``BareMetalExecutor`` and ``Session`` on the CPU (plain
    versions of the bf16 kernel) are within ``tolerances.net_tolerance`` of
    the reference's ``BareMetalExecutor`` and VP, single image and
    ``run_batch`` with padded lanes, and every batched lane is bit-identical
    to its single image;
  * an nv_small and an nv_full net are served side by side from one
    ``Session``, and a bf16 net takes every input, int8 included, as float.

Tolerance: byte equality where the same numpy code meets itself (compiler,
VP, ``ref``); ``net_tolerance`` (the sum over CONV/FC layers of one bf16 ulp
plus K * 2^-22) against other implementations.
"""

import numpy as np
import pytest

from repro.core import engine as jengine
from repro.core import graph as jgraph
from repro.core import pipeline as jpipe
from repro.core import tolerances as jtol
from repro.core.vp import VirtualPlatform
from repro.runtime import create_executor as jcreate
from repro_torch.convert import params_from_reference
from repro_torch.core import engine as tengine
from repro_torch.core import graph as tgraph
from repro_torch.core import perfmodel, tolerances
from repro_torch.core import pipeline as tpipe
from repro_torch.core.tolerances import assert_close, net_tolerance
from repro_torch.runtime import Session, create_executor

BUNDLE_FILES = ("trace.cfg", "weights.img", "program.bin")


def _mini_net(g_mod):
    """Copy of ``tests/test_nvfull.py::_mini_net`` for either package: a
    small residual net with CONV, PDP (max and GAP), EW and FC."""
    g = g_mod.NetGraph("mini_nvfull", (3, 16, 16))
    g.layer(name="data", type="input", inputs=[])
    x = g.layer(name="stem", type="conv", inputs=["data"], out_channels=8,
                kernel=3, stride=1, pad=1, relu=True)
    c1 = g.layer(name="b_c1", type="conv", inputs=[x], out_channels=8,
                 kernel=3, stride=1, pad=1, relu=True)
    c2 = g.layer(name="b_c2", type="conv", inputs=[c1], out_channels=8,
                 kernel=3, stride=1, pad=1)
    x = g.layer(name="b_add", type="add", inputs=[c2, x], relu=True)
    x = g.layer(name="pool", type="pool", inputs=[x], kernel=2, stride=2,
                pool_mode="max")
    x = g.layer(name="gap", type="pool", inputs=[x], pool_mode="gap")
    g.layer(name="fc", type="fc", inputs=[x], out_channels=4)
    return g.infer_shapes()


NETS = {"lenet5": lambda m: m.lenet5(), "mini": _mini_net}


def _compile(build, seed=0, cfg_name="nv_full"):
    jg, tg = build(jgraph), build(tgraph)
    params = jg.init_params(seed)
    jp = jpipe.CompilerPipeline(jg, params=params,
                                cfg=jengine.CONFIGS[cfg_name], use_cache=False)
    ta = tpipe.CompilerPipeline(tg, params=params_from_reference(params, tg),
                                cfg=tengine.CONFIGS[cfg_name],
                                use_cache=False).run()
    return jp, jp.run(), ta


def _tol(art) -> tolerances.Tolerance:
    descs = create_executor("ref", art).descs
    return net_tolerance(contract_ks=[perfmodel.contract_k(d) for d in descs
                                      if d.unit in ("CONV", "FC")])


def _inputs(shape, n, seed):
    return np.random.default_rng(seed).normal(0, 1, (n,) + shape).astype(np.float32)


@pytest.fixture(scope="module", params=sorted(NETS))
def net(request):
    jp, ja, ta = _compile(NETS[request.param], seed=3)
    return request.param, jp, ja, ta


def test_bundles_and_vp_bytes_identical(net):
    _, _, ja, ta = net
    assert ta.cfg == tengine.NV_FULL
    assert ta.trace_text == ja.trace_text
    assert ta.weight_image == ja.weight_image
    assert ta.program_binary == ja.program_binary
    assert (ta.input_scale, ta.output_scale, ta.output_elems) == \
        (ja.input_scale, ja.output_scale, ja.output_elems)
    assert ta.vp_output_int8.dtype == np.uint8
    np.testing.assert_array_equal(ta.vp_output_int8, ja.vp_output_int8)
    np.testing.assert_array_equal(ta.vp_output, ja.vp_output)


def test_converted_params_give_identical_bundle_files(net, tmp_path):
    """``params_from_reference`` carries the float parameters unchanged: the
    saved nv_full bundle files are the same bytes from either package."""
    _, _, ja, ta = net
    ja.save(tmp_path / "j")
    ta.save(tmp_path / "t")
    for f in BUNDLE_FILES:
        assert (tmp_path / "t" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes(), f


def test_bundles_cross_load(net, tmp_path):
    _, jp, ja, ta = net
    ja.save(tmp_path / "j")
    ta.save(tmp_path / "t")
    got_t = tpipe.Artifacts.load(tmp_path / "j")
    got_j = jpipe.Artifacts.load(tmp_path / "t")
    assert got_t.cfg == tengine.NV_FULL and got_j.cfg == jengine.NV_FULL
    assert got_t.weight_image == ja.weight_image
    assert got_j.trace_text == ta.trace_text
    x = jp.sample_input
    np.testing.assert_array_equal(
        create_executor("ref", got_t).run(x).output_int8,
        jcreate("ref", got_j).run(x).output_int8)


def test_ref_backend_byte_identical(net):
    _, jp, ja, ta = net
    jref, tref = jcreate("ref", ja), create_executor("ref", ta)
    assert tref.capabilities().dtype == "bf16"
    shape = ta.loadable.graph.input_shape
    for x in [jp.sample_input, *_inputs(shape, 2, 11)]:
        want, got = jref.run(x), tref.run(x)
        assert got.output_int8.dtype == np.uint8
        np.testing.assert_array_equal(got.output_int8, want.output_int8)
        np.testing.assert_array_equal(got.output, want.output)


def test_executor_and_session_within_tolerance(net):
    """Single images and a padded batch (5 live lanes in bucket 8) within
    net_tolerance of the reference's executor and VP; batched lanes
    bit-identical to single images."""
    _, jp, ja, ta = net
    tol = _tol(ta)
    assert tol.rtol == pytest.approx(jtol.net_tolerance(ja.kernel_plan).rtol)
    shape = ta.loadable.graph.input_shape
    ses = Session(ta, device="cpu")
    jex = jcreate("baremetal", ja)
    vp = VirtualPlatform(ja.loadable)
    assert_close(ses.run(jp.sample_input).output, ja.vp_output, tol, "VP")
    X = _inputs(shape, 5, 12)
    singles = [ses.run(x) for x in X]
    for x, r in zip(X, singles):
        assert r.output_int8.shape == (2 * ta.output_elems,)
        assert_close(r.output, jex.run(x).output, tol, "reference executor")
        assert_close(r.output, vp.run(x).output, tol, "VP")
    got = ses.run_batch(X)
    assert ses.bucket_for(5) == 8 and got.output.shape == (5, ta.output_elems)
    np.testing.assert_array_equal(got.output_int8,
                                  np.stack([r.output_int8 for r in singles]))
    padded = np.concatenate([X, np.zeros((3,) + shape, np.float32)])
    want = jex.run_batch(padded, lanes=5).output
    for lane in range(5):
        assert_close(got.output[lane], want[lane], tol, f"batch lane {lane}")


def test_capabilities_and_kernel_plan(net):
    _, _, _, ta = net
    ex = create_executor("baremetal", ta, device="cpu")
    caps = ex.capabilities()
    assert caps.dtype == "bf16" and caps.native_batching
    assert caps.kernels == (perfmodel.KERNEL_TORCH_BF16,)
    gemms = {k for k, d in zip(ex.kernel_plan, ex.descs)
             if d.unit in ("CONV", "FC")}
    assert gemms == {perfmodel.KERNEL_TORCH_BF16}
    res, samples = ex.run_profiled(_inputs(ta.loadable.graph.input_shape, 1, 13)[0])
    assert len(samples) == len(ex.descs)
    assert res.output_int8.dtype == np.uint8


def test_unknown_dtype_fails_with_actionable_error(net):
    _, _, _, ta = net
    from repro_torch.core.executor import BareMetalExecutor
    bad = tengine.EngineConfig(name="nv_fp4", dtype="fp4", macs=64,
                               dbb_bytes_per_cycle=8, conv_buf_kib=128)
    with pytest.raises(NotImplementedError) as ei:
        BareMetalExecutor(ta.trace, ta.weight_image, bad, device="cpu")
    msg = str(ei.value)
    assert "nv_small" in msg and "nv_full" in msg and "fp4" in msg


# ---------------------------------------------------------------------------
# Mixed-precision serving (ports of the reference's test_nvfull.py checks,
# without the threaded submit, which the port has not yet)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def both_arts():
    _, _, small = _compile(_mini_net, cfg_name="nv_small")
    pipe_full, _, full = _compile(_mini_net)
    return small, full, pipe_full.sample_input


def test_two_configs_coexist_without_cross_dtype_mixing(both_arts):
    small, full, x = both_arts
    tol = _tol(full)
    ses = Session(small, name="small", device="cpu")
    ses.load(full, name="full")
    assert [ses.executor(n).capabilities().dtype for n in ses.networks] == \
        ["int8", "bf16"]
    want_small = create_executor("ref", small).run(x).output_int8
    want_full = create_executor("ref", full).run(x).output
    for _ in range(3):
        r = ses.run(x, net="full")
        assert r.output_int8.dtype == np.uint8
        assert_close(r.output, want_full, tol, "served nv_full")
        np.testing.assert_array_equal(ses.run(x, net="small").output_int8,
                                      want_small)
    X = np.stack([x, -x, 0.5 * x])
    bf = ses.run_batch(X, net="full")
    bs = ses.run_batch(X, net="small")
    assert bf.output_int8.dtype == np.uint8 and bs.output_int8.dtype == np.int8
    for lane in range(3):
        np.testing.assert_array_equal(bf.output_int8[lane],
                                      ses.run(X[lane], net="full").output_int8)
        np.testing.assert_array_equal(bs.output_int8[lane],
                                      ses.run(X[lane], net="small").output_int8)


def test_bf16_net_canonicalises_int8_inputs_to_float(both_arts):
    small, full, x = both_arts
    ses = Session(full, name="full", device="cpu")
    ses.load(small, name="small")
    xi8 = np.clip(x * 40, -128, 127).astype(np.int8)
    # an int8 array is float-converted for a bf16 net, never treated as
    # pre-quantised engine bytes
    got = ses.run(xi8, net="full")
    want = ses.run(xi8.astype(np.float32), net="full")
    np.testing.assert_array_equal(got.output_int8, want.output_int8)
    # ... while the int8 net still takes it as pre-quantised bytes
    ex = ses.executor("small")
    np.testing.assert_array_equal(ses.run(xi8, net="small").output_int8,
                                  ex.run(xi8).output_int8)


# ---------------------------------------------------------------------------
# ResNet-18 at full width
# ---------------------------------------------------------------------------
def test_resnet18_full_width():
    """ResNet-18 (3x32x32, widths 64..512, K up to 4608) at nv_full: the
    compile's bundle and VP bytes equal the reference's, the served output
    is within net_tolerance of the VP, and a 3-lane batch (bucket 4, one
    dead lane) is bit-identical per lane to single images."""
    jp, ja, ta = _compile(lambda m: m.resnet18())
    assert ta.weight_image == ja.weight_image and ta.trace_text == ja.trace_text
    np.testing.assert_array_equal(ta.vp_output_int8, ja.vp_output_int8)
    tol = _tol(ta)
    ses = Session(ta, device="cpu")
    assert_close(ses.run(jp.sample_input).output, ja.vp_output, tol, "VP")
    X = _inputs(ta.loadable.graph.input_shape, 3, 14)
    got = ses.run_batch(X)
    ref = create_executor("ref", ta)
    for lane, x in enumerate(X):
        np.testing.assert_array_equal(got.output_int8[lane],
                                      ses.run(x).output_int8)
        assert_close(got.output[lane], ref.run(x).output, tol, f"lane {lane}")
