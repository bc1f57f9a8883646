"""The port's W8A8 ``quantized_matmul`` against the JAX reference.

On the CPU, ``repro_torch.kernels.int8_gemm`` takes its plain version
(``ref.py``: an int64 GEMM, then the per-column SDP epilogue of
``core/intmath.py``); these tests hold it against
``repro.kernels.int8_gemm.ops.quantized_matmul`` with the Pallas kernel in
interpret mode and against the reference's jnp oracle ``int8_gemm_ref``, at
the shapes of the reference's own kernel tests, and against the numpy FC
oracle (``core/refops.fc_int8``).  One test holds the CUDA kernel against the
plain version and runs only with a card; it needs no JAX (the ``jx`` fixture
imports it for the others).  Tolerance everywhere: byte equality.
"""

import numpy as np
import pytest
import torch

from repro.core import quant
from repro.core import refops as jrefops
from repro_torch.core import refops as trefops
from repro_torch.kernels.int8_conv import ops as conv_ops
from repro_torch.kernels.int8_gemm import ops as T
from repro_torch.kernels.int8_gemm import ref as TR


@pytest.fixture(scope="module")
def jx():
    """(jax.numpy, quantized_matmul, int8_gemm_ref) of the reference."""
    import jax.numpy as jnp
    from repro.kernels.int8_gemm.ops import quantized_matmul
    from repro.kernels.int8_gemm.ref import int8_gemm_ref
    return jnp, quantized_matmul, int8_gemm_ref


def _t(a):
    return torch.from_numpy(np.array(a))


def _words(rng, n, max_acc):
    return np.array([quant.pack_scale(*quant.fixed_point(float(s), max_acc))
                     for s in rng.uniform(1e-5, 1e-3, n)],
                    dtype=np.uint32).view(np.int32)


def _inputs(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (m, k), dtype=np.int8)
    w = rng.integers(-128, 128, (k, n), dtype=np.int8)
    bias = rng.integers(-1000, 1000, n, dtype=np.int32)
    return x, w, bias, _words(rng, n, k * 128 * 128)


@pytest.mark.parametrize("m,k,n", [
    (128, 128, 128),      # single tile
    (256, 384, 128),      # multi-tile M,K
    (128, 128, 384),      # multi-tile N
    (100, 200, 60),       # ragged
    (1, 576, 10),         # FC-like (LeNet fc3 shape)
])
@pytest.mark.parametrize("relu", [False, True])
def test_matches_reference_kernel_and_oracle(m, k, n, relu, jx):
    jnp, J, JR = jx
    x, w, bias, words = _inputs(m, k, n, m * 7 + n)
    got = T.quantized_matmul(_t(x), _t(w), _t(bias), _t(words), relu).numpy()
    assert got.dtype == np.int8 and got.shape == (m, n)
    ja = (jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), jnp.asarray(words))
    np.testing.assert_array_equal(
        got, np.asarray(J(*ja, relu=relu, use_kernel=True, interpret=True)))
    np.testing.assert_array_equal(got, np.asarray(JR(*ja, relu=relu)))


def test_ragged_edges_need_no_padding(jx):
    """No padding in the port: ragged M, K and N against the reference's
    padded kernel at small blocks."""
    jnp, J, _ = jx
    x, w, bias, words = _inputs(64, 100, 64, 0)
    got = T.quantized_matmul(_t(x), _t(w), _t(bias), _t(words)).numpy()
    want = J(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
             jnp.asarray(words), block_m=32, block_n=32, block_k=32)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("oracle", [trefops, jrefops], ids=["port", "repro"])
def test_matches_fc_refops(oracle):
    """The epilogue is bit-compatible with the VP's numpy FC semantics."""
    rng = np.random.default_rng(5)
    x = rng.integers(-128, 128, (1, 256), dtype=np.int8)
    w = rng.integers(-128, 128, (256, 32), dtype=np.int8)
    bias = rng.integers(-500, 500, 32, dtype=np.int32)
    words = np.full(32, quant.pack_scale(*quant.fixed_point(1e-4, 256 * 128 * 128)),
                    np.uint32)
    got = T.quantized_matmul(_t(x), _t(w), _t(bias), _t(words.view(np.int32)),
                             relu=True).numpy()
    want = oracle.fc_int8(x.reshape(-1, 1, 1), w.T.copy(), bias, words, relu=True)
    np.testing.assert_array_equal(got.reshape(-1), want.reshape(-1))


def test_is_the_transposed_conv_gemm():
    """Channels on columns: quantized_matmul(cols^T, W^T) equals the conv
    GEMM (channels on rows) transposed, wrapping accumulators included."""
    rng = np.random.default_rng(9)
    wq = rng.integers(-128, 128, (12, 4608), dtype=np.int8)
    cols = rng.integers(-128, 128, (4608, 17), dtype=np.int8)
    bias = rng.integers(-2**31, 2**31, 12, dtype=np.int64).astype(np.int32)
    words = _words(rng, 12, 4608 * 128 * 127)
    got = T.quantized_matmul(_t(cols.T.copy()), _t(wq.T.copy()), _t(bias),
                             _t(words), relu=False)
    want = conv_ops.gemm(_t(wq), _t(cols), _t(bias), _t(words), False)
    assert torch.equal(got, want.t())


def test_wrapper_checks_arguments_and_counts_only_launches():
    x = torch.zeros((5, 8), dtype=torch.int8)
    w = torch.zeros((8, 4), dtype=torch.int8)
    b = torch.zeros(4, dtype=torch.int32)
    before = T.launches
    T.quantized_matmul(x, w, b, b, True)
    assert T.launches == before                   # the CPU took the plain version
    with pytest.raises(ValueError, match="w must be"):
        T.quantized_matmul(x, w.to(torch.int32), b, b)
    with pytest.raises(ValueError, match="not contiguous"):
        T.quantized_matmul(x, torch.zeros((4, 8), dtype=torch.int8).t(), b, b)
    with pytest.raises(ValueError, match="do not agree"):
        T.quantized_matmul(x, w, torch.zeros(5, dtype=torch.int32), b)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """The sm_90a kernel against its plain version on the card, byte for
    byte, at ragged shapes, K past 1024, all -128 operands and wrapping
    accumulators."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (sm_90a)")
    from repro_torch.kernels.int8_gemm import kernel
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for m, k, n in ((1, 1, 1), (8, 512, 10), (2048, 147, 64), (33, 4608, 65),
                    (1, 4608, 512), (129, 1025, 130)):
        x = _t(rng.integers(-128, 128, (m, k)).astype(np.int8)).to(dev)
        w = _t(rng.integers(-128, 128, (k, n)).astype(np.int8)).to(dev)
        bias = _t(rng.integers(-2**31, 2**31, n).astype(np.int32)).to(dev)
        words = _t(_words(rng, n, k * 128 * 127)).to(dev)
        for relu in (False, True):
            got = kernel.int8_gemm(x, w, bias, words, relu)
            torch.cuda.synchronize()
            assert torch.equal(got, TR.int8_gemm_ref(x, w, bias, words, relu))
    x = torch.full((40, 4608), -128, dtype=torch.int8, device=dev)
    w = torch.full((4608, 16), -128, dtype=torch.int8, device=dev)
    bias = torch.full((16,), 2**31 - 1, dtype=torch.int32, device=dev)
    words = _t(np.full(16, quant.pack_scale(-32768, 0, 0), np.uint32)
               .view(np.int32)).to(dev)
    got = kernel.int8_gemm(x, w, bias, words, False)
    torch.cuda.synchronize()
    assert torch.equal(got, TR.int8_gemm_ref(x, w, bias, words, False))
