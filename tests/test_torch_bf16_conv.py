"""The port's fused bf16 conv/FC entry points against the JAX reference.

On the CPU, ``repro_torch.kernels.bf16_conv`` takes its plain version
(``ref.py``: a float64 GEMM, one rounding to float32, then the float32 bias,
ReLU and bf16 rounding); these tests hold it against
``repro.kernels.bf16_conv`` with the Pallas kernel in interpret mode at small
shapes (groups, stride, pad, N not a multiple of 128), and against the
reference's jnp oracle at K = 1025 and 4608.  Both sides accumulate in
float32 or finer in different orders, so the tolerance is
``tolerances.gemm_tolerance(K)`` (one bf16 ulp plus K * 2^-22, relative to
max|expected|).  Lanes folded into a bucket must give the bits of their own
single image.  One test holds the CUDA kernel against the plain version and
runs only with a card; it needs no JAX (the ``jx`` fixture imports it for
the others).
"""

import numpy as np
import pytest
import torch

from repro_torch.core.bf16 import bf16_bits_to_f32, f32_to_bf16_bits
from repro_torch.core.tolerances import assert_close, gemm_tolerance
from repro_torch.kernels.bf16_conv import ops as T
from repro_torch.kernels.bf16_conv import ref as TR


@pytest.fixture(scope="module")
def jx():
    """(jax.numpy, repro.kernels.bf16_conv): the reference entry points."""
    import jax.numpy as jnp
    from repro.kernels import bf16_conv
    return jnp, bf16_conv


def _bf(rng, shape, scale=1.0) -> np.ndarray:
    """float32 values that are exactly bfloat16 (so both packages start
    from the same bits)."""
    x = rng.normal(0, scale, shape).astype(np.float32)
    return bf16_bits_to_f32(f32_to_bf16_bits(x))


def _t(a, dtype=torch.bfloat16):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _np(t) -> np.ndarray:
    return t.to(torch.float32).numpy()


CONV_CASES = {
    "plain":   dict(cin=3, h=6, cout=4, k=3, stride=1, pad=0, groups=1),
    "pad":     dict(cin=2, h=5, cout=4, k=3, stride=1, pad=1, groups=1),
    "stride2": dict(cin=3, h=7, cout=4, k=3, stride=2, pad=1, groups=1),
    "groups2": dict(cin=4, h=6, cout=6, k=3, stride=1, pad=0, groups=2),
    "ragged":  dict(cin=2, h=13, cout=5, k=3, stride=1, pad=2, groups=1),
    "stem":    dict(cin=3, h=12, cout=8, k=7, stride=2, pad=3, groups=1),
}


def _conv_inputs(case, lanes, seed=0):
    c = CONV_CASES[case]
    kdim = c["cin"] // c["groups"] * c["k"] * c["k"]
    rng = np.random.default_rng(seed + lanes)
    xs = _bf(rng, (lanes, c["cin"], c["h"], c["h"]))
    wq = _bf(rng, (c["cout"], kdim), 0.5)
    bias = rng.normal(0, 1, c["cout"]).astype(np.float32)
    return c, kdim, xs, wq, bias


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv2d_bf16_matches_pallas_interpret(case, relu, jx):
    jnp, J = jx
    c, kdim, xs, wq, bias = _conv_inputs(case, 1)
    args = (c["k"], c["stride"], c["pad"], c["groups"], relu)
    want = np.asarray(J.conv2d_bf16(jnp.asarray(xs[0], jnp.bfloat16),
                                    jnp.asarray(wq, jnp.bfloat16),
                                    jnp.asarray(bias), *args, interpret=True),
                      np.float32)
    got = T.conv2d_bf16(_t(xs[0]), _t(wq), _t(bias, torch.float32), *args)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    assert_close(_np(got), want, gemm_tolerance(kdim), case)


@pytest.mark.parametrize("lanes,live", [(2, 2), (4, 3), (8, 5)])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv2d_bf16_batch_lanes_equal_single_images(case, lanes, live, jx):
    """Lane-folded call: every lane bit-identical to its own single-image
    call (zero padding lanes included), and within tolerance of the
    reference's batched Pallas kernel."""
    c, kdim, xs, wq, bias = _conv_inputs(case, lanes)
    xs[live:] = 0                                 # dead lanes, as padded
    args = (c["k"], c["stride"], c["pad"], c["groups"], True)
    got = T.conv2d_bf16_batch(_t(xs), _t(wq), _t(bias, torch.float32), *args)
    for b in range(lanes):
        one = T.conv2d_bf16(_t(xs[b]), _t(wq), _t(bias, torch.float32), *args)
        assert torch.equal(got[b].view(torch.int16), one.view(torch.int16))
    jnp, J = jx
    want = np.asarray(J.conv2d_bf16_batch(
        jnp.asarray(xs, jnp.bfloat16), jnp.asarray(wq, jnp.bfloat16),
        jnp.asarray(bias), *args, interpret=True), np.float32)
    assert_close(_np(got), want, gemm_tolerance(kdim), f"{case} batch")


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("cin,cout", [(16, 10), (130, 7), (512, 10)])
def test_fc_bf16_matches_pallas_interpret(cin, cout, relu, jx):
    jnp, J = jx
    rng = np.random.default_rng(cin + cout)
    x = _bf(rng, cin)
    wq = _bf(rng, (cout, cin), 0.5)
    bias = rng.normal(0, 1, cout).astype(np.float32)
    want = np.asarray(J.fc_bf16(jnp.asarray(x, jnp.bfloat16),
                                jnp.asarray(wq, jnp.bfloat16),
                                jnp.asarray(bias), relu, interpret=True),
                      np.float32)
    got = T.fc_bf16(_t(x), _t(wq), _t(bias, torch.float32), relu)
    assert tuple(got.shape) == (cout, 1, 1)
    assert_close(_np(got), want, gemm_tolerance(cin))
    xs = np.stack([x, np.zeros_like(x), -x])
    gb = T.fc_bf16_batch(_t(xs), _t(wq), _t(bias, torch.float32), relu)
    for b in range(3):
        one = T.fc_bf16(_t(xs[b]), _t(wq), _t(bias, torch.float32), relu)
        assert torch.equal(gb[b].view(torch.int16), one.view(torch.int16))


@pytest.mark.parametrize("cin,k", [(1025, 1), (512, 3)])   # K = 1025, 4608
def test_large_k_matches_reference_oracle(cin, k, jx):
    jnp, J = jx
    rng = np.random.default_rng(cin)
    x = _bf(rng, (cin, 4, 4))
    wq = _bf(rng, (6, cin * k * k), 0.1)
    bias = rng.normal(0, 1, 6).astype(np.float32)
    args = (k, 1, k // 2, 1, True)
    got = T.conv2d_bf16(_t(x), _t(wq), _t(bias, torch.float32), *args)
    want = np.asarray(J.conv2d_bf16_ref(jnp.asarray(x, jnp.bfloat16),
                                        jnp.asarray(wq, jnp.bfloat16),
                                        jnp.asarray(bias), *args), np.float32)
    assert_close(_np(got), want, gemm_tolerance(cin * k * k))
    plain = TR.conv2d_bf16_ref(_t(x), _t(wq), _t(bias, torch.float32), *args)
    assert torch.equal(got.view(torch.int16), plain.view(torch.int16))


def test_bf16_accumulator_would_fail_the_budget():
    """The tolerance is tight enough to catch a bf16 (not f32) accumulator
    on a deep contraction: the bug class it exists for (port of the
    reference's ``test_nvfull.py`` check)."""
    rng = np.random.default_rng(0)
    kdim = 4096
    x = _t(_bf(rng, kdim))
    w = _t(_bf(rng, (4, kdim)))
    bias = torch.zeros(4, dtype=torch.float32)
    want = _np(T.fc_bf16(x, w, bias)).reshape(-1)
    acc = torch.zeros(4, dtype=torch.bfloat16)
    for i in range(kdim):                         # sequential bf16 sum: the bug
        acc = (acc + w[:, i] * x[i]).to(torch.bfloat16)
    with pytest.raises(AssertionError):
        assert_close(_np(acc), want, gemm_tolerance(kdim))


def test_wrapper_checks_arguments_and_counts_only_launches():
    w = torch.zeros((4, 8), dtype=torch.bfloat16)
    cols = torch.zeros((8, 5), dtype=torch.bfloat16)
    b = torch.zeros(4, dtype=torch.float32)
    before = T.launches
    T.gemm(w, cols, b, True)
    assert T.launches == before                   # the CPU took the plain version
    with pytest.raises(ValueError, match="cols must be"):
        T.gemm(w, cols.to(torch.float32), b, True)
    with pytest.raises(ValueError, match="bias must be"):
        T.gemm(w, cols, b.to(torch.bfloat16), True)
    with pytest.raises(ValueError, match="not contiguous"):
        T.gemm(w, torch.zeros((5, 8), dtype=torch.bfloat16).t(), b, True)
    with pytest.raises(ValueError, match="do not agree"):
        T.gemm(w, torch.zeros((7, 5), dtype=torch.bfloat16), b, True)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """The sm_90a kernel against its plain version on the card within
    gemm_tolerance(K), at ragged shapes and K up to 4608; the lanes of a
    folded launch bit-identical to their own launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (sm_90a)")
    from repro_torch.kernels.bf16_conv import kernel
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for m, k, n in ((1, 1, 1), (10, 512, 8), (64, 147, 256), (65, 4608, 33),
                    (512, 4608, 1), (130, 1025, 129)):
        w = _t(_bf(rng, (m, k))).to(dev)
        lanes = [_t(_bf(rng, (k, n))).to(dev) for _ in range(3)]
        cols = torch.cat(lanes, 1).contiguous()
        bias = _t(rng.normal(0, 1, m), torch.float32).to(dev)
        for relu in (False, True):
            got = kernel.bf16_conv_gemm(w, cols, bias, relu)
            torch.cuda.synchronize()
            want = TR.bf16_conv_gemm_ref(w, cols, bias, relu)
            assert_close(_np(got.cpu()), _np(want.cpu()), gemm_tolerance(k))
            for i, c in enumerate(lanes):
                one = kernel.bf16_conv_gemm(w, c, bias, relu)
                assert torch.equal(got[:, i * n:(i + 1) * n].view(torch.int16),
                                   one.view(torch.int16))
