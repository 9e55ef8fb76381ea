"""The port's flash attention against the JAX package's.

Inputs are drawn with numpy from a seed and handed to both frameworks.
Tolerances are those of ``tests/test_kernels.py``: 2e-5 in fp32 (the two
sides sum the same fp32 products in another order) and 2e-2 in bf16 (both
round the same fp32 result to bf16, so they can differ by one bf16 ulp
where the fp32 values straddle a rounding boundary).

The parity tests need JAX and skip without it; the kernel tests need a
CUDA card and ``nvcc`` and skip without them. On a machine with a card:
``python -m pytest tests/test_torch_flash_attention.py -m cuda``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_kernel,
)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref,
)

# B, H, Kh, Sq, Sk, D, kwargs: the shapes of tests/test_kernels.py
# (block_q/block_k there are Pallas tiling choices and have no port)
FLASH_CASES = [
    (2, 4, 4, 256, 256, 64, {}),                      # MHA causal
    (1, 8, 2, 256, 256, 128, dict(window=96)),        # GQA + SWA
    (2, 4, 1, 384, 384, 64, dict(chunk=128)),         # MQA + chunked
    (1, 2, 2, 128, 512, 64, dict(causal=False)),      # cross-shaped
    (1, 4, 4, 512, 512, 96, dict(window=128)),
]
# the serving shapes: qwen3-4b (hi) and stablelm-1.6b (lo) at seq 48
SERVING_CASES = [
    (2, 32, 8, 48, 48, 128, {}),
    (4, 32, 32, 48, 48, 64, {}),
]
# Sq and Sk not a multiple of the 64-row tile, with a window
RAGGED_CASE = (2, 4, 2, 48, 48, 64, dict(window=16))
# window 0 masks every key of every row: the oracle returns mean(v)
MASKED_CASE = (1, 4, 2, 40, 72, 64, dict(window=0))

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]


def _case_id(case):
    return str(case[:6]) + "".join(f"-{k}{v}" for k, v in case[6].items())


def _numpy_inputs(case, seed=0):
    B, H, Kh, Sq, Sk, D, _ = case
    rng = np.random.default_rng(seed + Sq * D)
    return (rng.standard_normal((B, H, Sq, D), dtype=np.float32),
            rng.standard_normal((B, Kh, Sk, D), dtype=np.float32),
            rng.standard_normal((B, Kh, Sk, D), dtype=np.float32))


def _torch(arrays, dtype, device="cpu"):
    return [torch.from_numpy(a).to(device=device, dtype=dtype)
            for a in arrays]


def _jax(arrays, dtype):
    import jax.numpy as jnp
    return [jnp.asarray(a).astype(jnp.dtype(str(dtype).split(".")[1]))
            for a in arrays]


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().cpu().numpy()
    return np.asarray(x.astype("float32"))


@pytest.fixture
def jax_flash():
    """The JAX package's kernel wrapper and oracle (JAX on the CPU)."""
    pytest.importorskip("jax")
    from repro.kernels.flash_attention import ops as jops
    from repro.kernels.flash_attention import ref as jref
    return jops.flash_attention, jref.flash_attention_ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernel)")
    torch.backends.cuda.matmul.allow_tf32 = False   # the oracle in fp32
    return torch.device("cuda")


# ----------------------------------------------------------- parity (CPU)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", FLASH_CASES, ids=_case_id)
def test_ref_matches_jax_ref(case, dtype, jax_flash):
    _, jref = jax_flash
    arrays = _numpy_inputs(case)
    kw = case[6]
    out = flash_attention_ref(*_torch(arrays, dtype), **kw)
    want = jref(*_jax(arrays, dtype), **kw)
    assert out.dtype == dtype and tuple(out.shape) == want.shape
    assert np.max(np.abs(_f32(out) - _f32(want))) < TOL[dtype]


@pytest.mark.parametrize("case", FLASH_CASES[:2], ids=_case_id)
def test_ref_matches_pallas_interpret(case, jax_flash):
    """Against the Pallas kernel body itself, run by the interpreter as
    tests/test_kernels.py runs it (fp32 only: interpreting is slow)."""
    jkernel, _ = jax_flash
    arrays = _numpy_inputs(case)
    out = flash_attention_ref(*_torch(arrays, torch.float32), **case[6])
    want = jkernel(*_jax(arrays, torch.float32), interpret=True, **case[6])
    assert np.max(np.abs(_f32(out) - _f32(want))) < TOL[torch.float32]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_ragged_seq_matches_jax_ref(dtype, jax_flash):
    """Sq = Sk = 48, which the Pallas kernel asserts away and serving runs."""
    _, jref = jax_flash
    arrays = _numpy_inputs(RAGGED_CASE)
    out = ops.flash_attention(*_torch(arrays, dtype), **RAGGED_CASE[6])
    want = jref(*_jax(arrays, dtype), **RAGGED_CASE[6])
    assert np.max(np.abs(_f32(out) - _f32(want))) < TOL[dtype]


def test_fully_masked_row_is_mean_of_v(jax_flash):
    """A row with every key masked returns mean(v) over all keys in both
    oracles (the JAX model path's attention returns zeros there; the
    kernel follows the oracle)."""
    _, jref = jax_flash
    arrays = _numpy_inputs(MASKED_CASE)
    q, k, v = _torch(arrays, torch.float32)
    G = q.shape[1] // k.shape[1]
    mean_v = v.mean(dim=2, keepdim=True).repeat_interleave(G, dim=1)
    out = flash_attention_ref(q, k, v, **MASKED_CASE[6])
    want = jref(*_jax(arrays, torch.float32), **MASKED_CASE[6])
    np.testing.assert_allclose(_f32(out), _f32(mean_v.expand_as(out)),
                               atol=2e-6)
    assert np.max(np.abs(_f32(out) - _f32(want))) < TOL[torch.float32]


def test_cpu_tensors_go_to_the_plain_version():
    arrays = _numpy_inputs(RAGGED_CASE)
    q, k, v = _torch(arrays, torch.float32)
    before = ops.flash_attention.launches
    out = ops.flash_attention(q, k, v, window=16)
    assert ops.flash_attention.launches == before
    torch.testing.assert_close(out, flash_attention_ref(q, k, v, window=16),
                               rtol=0, atol=0)


def test_kernel_refuses_cpu_tensors():
    """The kernel's binding never runs the plain version: off a CUDA
    device it raises before anything is built."""
    q, k, v = _torch(_numpy_inputs(RAGGED_CASE), torch.float32)
    with pytest.raises(ValueError, match="not a CUDA device"):
        flash_attention_kernel(q, k, v)


# ------------------------------------------------------- kernel (CUDA card)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize(
    "case", FLASH_CASES + SERVING_CASES + [RAGGED_CASE, MASKED_CASE],
    ids=_case_id)
def test_kernel_matches_ref_on_card(case, dtype, cuda):
    q, k, v = _torch(_numpy_inputs(case), dtype, cuda)
    before = ops.flash_attention.launches
    out = ops.flash_attention(q, k, v, **case[6])
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    want = flash_attention_ref(q, k, v, **case[6])
    assert out.dtype == dtype and out.shape == want.shape
    assert float((out.float() - want.float()).abs().max()) < TOL[dtype]


@pytest.mark.cuda
def test_kernel_takes_transposed_projections(cuda):
    """attend passes [B,S,H,D] projections as transposed views."""
    B, H, Kh, S, D = 2, 32, 8, 48, 128
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(B, S, H, D, generator=g, device=cuda,
                    dtype=torch.bfloat16)
    k = torch.randn(B, S, Kh, D, generator=g, device=cuda,
                    dtype=torch.bfloat16)
    v = torch.randn(B, S, Kh, D, generator=g, device=cuda,
                    dtype=torch.bfloat16)
    views = [t.transpose(1, 2) for t in (q, k, v)]
    out = ops.flash_attention(*views)
    dense = ops.flash_attention(*[t.contiguous() for t in views])
    torch.testing.assert_close(out, dense, rtol=0, atol=0)


@pytest.mark.cuda
def test_kernel_rejects_unsupported_head_dim(cuda):
    q = torch.zeros(1, 2, 16, 80, device=cuda)
    with pytest.raises(ValueError, match="head dim 80"):
        ops.flash_attention(q, q, q)
