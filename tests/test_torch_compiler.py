"""The port's compiler (``repro_torch.core.pipeline``) against the reference's.

Both packages compile the same graph from the same float parameters (carried
across by ``repro_torch.convert.params_from_reference``); the shipped bundle
files — trace, weight image, program binary — must be byte-identical, and a
bundle saved by either package must load in the other.
"""

import numpy as np
import pytest

from repro.core import graph as jgraph
from repro.core import pipeline as jpipe
from repro_torch.convert import params_from_reference
from repro_torch.core import engine as tengine
from repro_torch.core import graph as tgraph
from repro_torch.core import pipeline as tpipe


def _residual_net(g_mod):
    """Copy of ``tests/test_runtime.py::_residual_net`` for either package."""
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


NETS = {"lenet5": lambda m: m.lenet5(), "resid": _residual_net}


@pytest.fixture(scope="module", params=sorted(NETS))
def both(request):
    """(reference artifacts, port artifacts) compiled from the same params."""
    build = NETS[request.param]
    jg, tg = build(jgraph), build(tgraph)
    params = jg.init_params(3)
    ja = jpipe.CompilerPipeline(jg, params=params, use_cache=False).run()
    ta = tpipe.CompilerPipeline(tg, params=params_from_reference(params, tg),
                                use_cache=False).run()
    return ja, ta


def test_bundle_files_byte_identical(both):
    ja, ta = both
    assert ta.trace_text == ja.trace_text
    assert ta.weight_image == ja.weight_image
    assert ta.program_binary == ja.program_binary
    assert ta.asm_text == ja.asm_text
    assert (ta.input_scale, ta.output_scale, ta.output_elems) == \
        (ja.input_scale, ja.output_scale, ja.output_elems)
    np.testing.assert_array_equal(ta.vp_output_int8, ja.vp_output_int8)
    assert ta.storage_report() == ja.storage_report()


def test_reference_bundle_loads_in_port(both, tmp_path):
    ja, _ = both
    ja.save(tmp_path)
    got = tpipe.Artifacts.load(tmp_path)
    assert got.trace_text == ja.trace_text
    assert got.weight_image == ja.weight_image
    assert got.program_binary == ja.program_binary
    assert got.cfg == tengine.NV_SMALL
    # the reference's kernel plans ride along and save back unchanged
    assert got.kernel_plan == ja.kernel_plan
    out = tmp_path / "again"
    got.save(out)
    for f in ("trace.cfg", "weights.img", "program.bin", "manifest.json"):
        assert (out / f).read_bytes() == (tmp_path / f).read_bytes(), f


def test_port_bundle_loads_in_reference(both, tmp_path):
    _, ta = both
    ta.save(tmp_path)
    got = jpipe.Artifacts.load(tmp_path)
    assert got.trace_text == ta.trace_text
    assert got.weight_image == ta.weight_image
    assert got.program_binary == ta.program_binary
    assert got.kernel_plan is None        # the port writes no cost_model plan


def test_default_params_and_seed_match_reference():
    """With no params given, both pipelines draw the same init and samples."""
    ja = jpipe.CompilerPipeline(jgraph.lenet5(), seed=5, use_cache=False).run()
    ta = tpipe.CompilerPipeline(tgraph.lenet5(), seed=5, use_cache=False).run()
    assert ta.trace_text == ja.trace_text and ta.weight_image == ja.weight_image


def test_stages_run_individually_and_cache():
    tpipe.clear_cache()
    pipe = tpipe.CompilerPipeline(tgraph.lenet5())
    cal = pipe.run_stage("calibrate")
    assert set(pipe.results) == {"calibrate"} and "data" in cal.scales
    pipe.run_stage("parse_trace")
    assert "assemble" not in pipe.results
    misses = tpipe.cache_stats()["misses"]
    tpipe.CompilerPipeline(tgraph.lenet5()).run()
    assert tpipe.cache_stats()["misses"] == misses + 2   # extract + assemble
    with pytest.raises(ValueError, match="unknown stage"):
        pipe.run_stage("cost_model")


def test_nv_full_waits_for_its_slice(tmp_path):
    """nv_full, once left to a later slice, now compiles; the bundle's
    manifest carries the config through save and load."""
    art = tpipe.CompilerPipeline(tgraph.lenet5(), cfg=tengine.NV_FULL,
                                 use_cache=False).run()
    assert art.cfg == tengine.NV_FULL and art.vp_output_int8.dtype == np.uint8
    art.save(tmp_path)
    assert tpipe.Artifacts.load(tmp_path).cfg == tengine.NV_FULL


def test_params_from_reference_checks_names_shapes_dtypes():
    g = tgraph.lenet5()
    params = jgraph.lenet5().init_params(0)
    ok = params_from_reference(params, g)
    assert set(ok) == set(params)
    assert ok["conv1"]["w"] is not params["conv1"]["w"]          # a copy
    bad = dict(params)
    del bad["fc3"]
    with pytest.raises(ValueError, match="do not match"):
        params_from_reference(bad, g)
    bad = {k: dict(v) for k, v in params.items()}
    bad["conv2"]["w"] = bad["conv2"]["w"][:, :3]
    with pytest.raises(ValueError, match="conv2.w: shape"):
        params_from_reference(bad, g)
    bad = {k: dict(v) for k, v in params.items()}
    bad["fc1"]["b"] = bad["fc1"]["b"].astype(np.float64)
    with pytest.raises(ValueError, match="fc1.b: dtype"):
        params_from_reference(bad, g)
