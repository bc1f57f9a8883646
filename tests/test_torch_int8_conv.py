"""The port's fused int8 conv/FC entry points against the JAX reference.

On the CPU, ``repro_torch.kernels.int8_conv`` takes its plain version
(``ref.py``); these tests hold it against ``repro.kernels.int8_conv`` with the
Pallas kernel in interpret mode at small shapes, and against the port's own
``ref.py`` and the numpy oracle (``core/refops``) at large K.  One test holds
the CUDA kernel against the plain version and runs only with a card; it
needs no JAX, so ``pytest -m cuda`` runs it on a machine that has none (the
JAX package is imported by the ``jx`` fixture, for the tests that use it).
Tolerance everywhere: byte equality (int8 outputs).
"""

import numpy as np
import pytest
import torch

from repro.core import quant, refops
from repro_torch.kernels.int8_conv import ops as T
from repro_torch.kernels.int8_conv import ref as TR


@pytest.fixture(scope="module")
def jx():
    """(jax.numpy, repro.kernels.int8_conv): the reference entry points."""
    import jax.numpy as jnp
    from repro.kernels import int8_conv
    return jnp, int8_conv


def _words(rng, n, max_acc):
    return np.array([quant.pack_scale(*quant.fixed_point(s, max_acc))
                     for s in rng.uniform(1e-5, 1e-3, n)],
                    dtype=np.uint32).view(np.int32)


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
    xs = rng.integers(-128, 128, (lanes, c["cin"], c["h"], c["h"])).astype(np.int8)
    wq = rng.integers(-128, 128, (c["cout"], kdim)).astype(np.int8)
    bias = rng.integers(-2000, 2000, c["cout"]).astype(np.int32)
    words = _words(rng, c["cout"], kdim * 128 * 127)
    return c, xs, wq, bias, words


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv2d_int8_matches_pallas_interpret(case, relu, jx):
    jnp, J = jx
    c, xs, wq, bias, words = _conv_inputs(case, 1)
    args = (c["k"], c["stride"], c["pad"], c["groups"], relu)
    want = np.asarray(J.conv2d_int8(jnp.asarray(xs[0]), jnp.asarray(wq),
                                    jnp.asarray(bias), jnp.asarray(words),
                                    *args, interpret=True))
    got = T.conv2d_int8(_t(xs[0]), _t(wq), _t(bias), _t(words), *args).numpy()
    assert got.dtype == np.int8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lanes,live", [(2, 2), (4, 3), (8, 5)])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv2d_int8_batch_with_dead_lanes(case, lanes, live, jx):
    """Lane-folded launch == per-lane reference, with zero padding lanes."""
    c, xs, wq, bias, words = _conv_inputs(case, lanes)
    xs[live:] = 0                                 # dead lanes, as padded
    args = (c["k"], c["stride"], c["pad"], c["groups"], True)
    got = T.conv2d_int8_batch(_t(xs), _t(wq), _t(bias), _t(words), *args).numpy()
    for b in range(lanes):
        want = refops.conv_int8(xs[b], wq, bias, words.view(np.uint32), *args)
        np.testing.assert_array_equal(got[b], want)
    jnp, J = jx
    want0 = np.asarray(J.conv2d_int8_batch(
        jnp.asarray(xs), jnp.asarray(wq), jnp.asarray(bias),
        jnp.asarray(words), *args, interpret=True))
    np.testing.assert_array_equal(got, want0)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("cin,cout", [(16, 10), (130, 7), (512, 10)])
def test_fc_int8_matches_pallas_interpret(cin, cout, relu, jx):
    jnp, J = jx
    rng = np.random.default_rng(cin + cout)
    x = rng.integers(-128, 128, cin).astype(np.int8)
    wq = rng.integers(-128, 128, (cout, cin)).astype(np.int8)
    bias = rng.integers(-5000, 5000, cout).astype(np.int32)
    words = _words(rng, cout, cin * 128 * 127)
    want = np.asarray(J.fc_int8(jnp.asarray(x), jnp.asarray(wq),
                                jnp.asarray(bias), jnp.asarray(words), relu,
                                interpret=True))
    got = T.fc_int8(_t(x), _t(wq), _t(bias), _t(words), relu).numpy()
    np.testing.assert_array_equal(got, want)
    xs = np.stack([x, np.zeros_like(x), -x])
    gb = T.fc_int8_batch(_t(xs), _t(wq), _t(bias), _t(words), relu).numpy()
    for b in range(3):
        np.testing.assert_array_equal(
            gb[b], refops.fc_int8(xs[b], wq, bias, words.view(np.uint32), relu))


@pytest.mark.parametrize("cin,k", [(1025, 1), (512, 3)])   # K = 1025, 4608
def test_large_k_conv_matches_ref_and_refops(cin, k, jx):
    jnp, J = jx
    rng = np.random.default_rng(cin)
    x = rng.integers(-128, 128, (cin, 4, 4)).astype(np.int8)
    wq = rng.integers(-128, 128, (6, cin * k * k)).astype(np.int8)
    bias = rng.integers(-2**20, 2**20, 6).astype(np.int32)
    words = _words(rng, 6, cin * k * k * 128 * 127 + 2**20)
    args = (k, 1, k // 2, 1, True)
    got = T.conv2d_int8(_t(x), _t(wq), _t(bias), _t(words), *args).numpy()
    np.testing.assert_array_equal(
        got, TR.conv2d_int8_ref(_t(x), _t(wq), _t(bias), _t(words), *args).numpy())
    np.testing.assert_array_equal(
        got, refops.conv_int8(x, wq, bias, words.view(np.uint32), *args))
    np.testing.assert_array_equal(
        got, np.asarray(J.conv2d_int8_ref(jnp.asarray(x), jnp.asarray(wq),
                                          jnp.asarray(bias), jnp.asarray(words),
                                          *args)))


@pytest.mark.parametrize("k_dim", [1024, 1025, 1031, 4608])
def test_gemm_exact_past_f32_bound(k_dim):
    """All -128 operands: K * 2^14 leaves f32's exact range past K = 1024;
    the plain version's float64 GEMM must still be integer-exact (mirrors the
    reference's ``test_dot_i8_exactness_bound``)."""
    a = np.full((2, k_dim), -128, np.int8)
    b = np.full((k_dim, 3), -128, np.int8)
    b[0, 0] = -127                                 # true sum = K*16384 - 128
    got = TR._dot_i8(_t(a), _t(b)).numpy()
    want = (a.astype(np.int64) @ b.astype(np.int64)).astype(np.int32)
    np.testing.assert_array_equal(got, want)
    ones = np.full(2, quant.pack_scale(1, 0, 0), np.uint32).view(np.int32)
    out = T.gemm(_t(a), _t(b), _t(np.zeros(2, np.int32)), _t(ones), False).numpy()
    np.testing.assert_array_equal(out, np.clip(want, -128, 127))


def test_wrapper_checks_arguments_and_counts_only_launches():
    w = torch.zeros((4, 8), dtype=torch.int8)
    cols = torch.zeros((8, 5), dtype=torch.int8)
    b = torch.zeros(4, dtype=torch.int32)
    before = T.launches
    T.gemm(w, cols, b, b, True)
    assert T.launches == before                   # the CPU took the plain version
    with pytest.raises(ValueError, match="cols must be"):
        T.gemm(w, cols.to(torch.int32), b, b, True)
    with pytest.raises(ValueError, match="not contiguous"):
        T.gemm(w, torch.zeros((5, 8), dtype=torch.int8).t(), b, b, True)
    with pytest.raises(ValueError, match="do not agree"):
        T.gemm(w, torch.zeros((7, 5), dtype=torch.int8), b, b, True)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """The sm_90a kernel against its plain version on the card, byte for
    byte, at ragged shapes, K past 1024, all -128 operands and wrapping
    accumulators."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (sm_90a)")
    from repro_torch.kernels.int8_conv import kernel
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for m, k, n in ((1, 1, 1), (10, 512, 8), (64, 147, 2048), (65, 4608, 33),
                    (512, 4608, 1), (130, 1025, 129)):
        w = _t(rng.integers(-128, 128, (m, k)).astype(np.int8)).to(dev)
        cols = _t(rng.integers(-128, 128, (k, n)).astype(np.int8)).to(dev)
        bias = _t(rng.integers(-2**31, 2**31, m).astype(np.int32)).to(dev)
        words = _t(_words(rng, m, k * 128 * 127)).to(dev)
        for relu in (False, True):
            got = kernel.int8_conv_gemm(w, cols, bias, words, relu)
            torch.cuda.synchronize()
            assert torch.equal(got, TR.int8_conv_gemm_ref(w, cols, bias, words,
                                                          relu))
    w = torch.full((16, 4608), -128, dtype=torch.int8, device=dev)
    cols = torch.full((4608, 40), -128, dtype=torch.int8, device=dev)
    bias = torch.full((16,), 2**31 - 1, dtype=torch.int32, device=dev)
    words = _t(np.full(16, quant.pack_scale(-32768, 0, 0), np.uint32)
               .view(np.int32)).to(dev)
    got = kernel.int8_conv_gemm(w, cols, bias, words, False)
    torch.cuda.synchronize()
    assert torch.equal(got, TR.int8_conv_gemm_ref(w, cols, bias, words, False))
