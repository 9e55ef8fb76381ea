"""The port's RG-LRU scan against the JAX package's.

Inputs are drawn with numpy from a seed and handed to both frameworks.
The tolerance is that of ``tests/test_kernels.py``, 1e-4 in fp32: the JAX
oracle is an associative scan, which multiplies the a's in another order
than the sequential walk of the port's plain version and kernel, so the
two differ by fp32 rounding that grows with S (about 1e-6 at S = 512).

The parity tests need JAX and skip without it; the kernel tests need a
CUDA card and ``nvcc`` and skip without them. On a machine with a card:
``python -m pytest tests/test_torch_rglru_scan.py -m cuda``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.rglru_scan import ops  # noqa: E402
from repro_torch.kernels.rglru_scan.kernel import (  # noqa: E402
    rglru_scan_kernel,
)
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref  # noqa: E402

# B, S, W: the shapes of tests/test_kernels.py
RGLRU_CASES = [(8, 256, 256), (4, 128, 512), (16, 512, 128), (8, 384, 384)]
# recurrentgemma-9b's rec blocks: serving (batch 4, seq 48) and a prompt
# of 2100 at batch 2, both fp32 as the model runs the recurrence
SERVING_CASE = (4, 48, 4096)
PREFILL_CASE = (2, 2100, 4096)
# S and W that are no multiple of the kernel's unroll depth or CTA width
RAGGED_CASE = (3, 37, 200)
TOL = 1e-4


def _numpy_inputs(case, seed=0):
    B, S, W = case
    rng = np.random.default_rng(seed + S + W)
    a = rng.uniform(0.3, 0.999, (B, S, W)).astype(np.float32)
    b = rng.standard_normal((B, S, W), dtype=np.float32) * 0.1
    h0 = rng.standard_normal((B, W), dtype=np.float32)
    return a, b, h0


@pytest.fixture
def jax_rglru():
    """The JAX package's kernel wrapper and oracle (JAX on the CPU; the
    oracle jitted, since its scan runs slowly op by op)."""
    jax = pytest.importorskip("jax")
    from repro.kernels.rglru_scan import ops as jops
    from repro.kernels.rglru_scan import ref as jref
    return jops.rglru_scan, jax.jit(jref.rglru_scan_ref)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernel)")
    return torch.device("cuda")


def _max_err(out, want) -> float:
    return float(np.max(np.abs(out.float().cpu().numpy()
                               - np.asarray(want, dtype=np.float32))))


# ----------------------------------------------------------- parity (CPU)
@pytest.mark.parametrize("case", RGLRU_CASES, ids=str)
def test_ref_matches_jax_ref(case, jax_rglru):
    import jax.numpy as jnp
    _, jref = jax_rglru
    a, b, h0 = _numpy_inputs(case)
    out = rglru_scan_ref(*map(torch.from_numpy, (a, b, h0)))
    want = jref(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
    assert out.dtype == torch.float32 and tuple(out.shape) == want.shape
    assert _max_err(out, want) < TOL


@pytest.mark.parametrize("case", RGLRU_CASES[:2], ids=str)
def test_ref_matches_pallas_interpret(case, jax_rglru):
    """Against the Pallas kernel body itself, run by the interpreter as
    tests/test_kernels.py runs it."""
    import jax.numpy as jnp
    jkernel, _ = jax_rglru
    a, b, h0 = _numpy_inputs(case)
    out = rglru_scan_ref(*map(torch.from_numpy, (a, b, h0)))
    want = jkernel(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0),
                   interpret=True, block_s=128)
    assert _max_err(out, want) < TOL


def test_no_h0_is_zero_state(jax_rglru):
    import jax.numpy as jnp
    _, jref = jax_rglru
    a, b, _ = _numpy_inputs(RAGGED_CASE)
    out = ops.rglru_scan(torch.from_numpy(a), torch.from_numpy(b))
    want = jref(jnp.asarray(a), jnp.asarray(b),
                jnp.zeros((a.shape[0], a.shape[2]), jnp.float32))
    assert _max_err(out, want) < TOL


def test_matches_step_recurrence():
    """Every prefix equals the step-by-step recurrence decode runs
    (tests/test_kernels.py's check)."""
    a, b, _ = _numpy_inputs((2, 64, 128))
    out = rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(b),
                         torch.zeros(2, 128)).numpy()
    h = np.zeros((2, 128), np.float32)
    for t in range(64):
        h = a[:, t] * h + b[:, t]
        assert np.max(np.abs(out[:, t] - h)) < TOL


def test_bf16_inputs_give_bf16_prefixes():
    a, b, h0 = _numpy_inputs(RAGGED_CASE)
    ab, bb = (torch.from_numpy(x).bfloat16() for x in (a, b))
    out = rglru_scan_ref(ab, bb, torch.from_numpy(h0))
    want = rglru_scan_ref(ab.float(), bb.float(), torch.from_numpy(h0))
    assert out.dtype == torch.bfloat16
    # one bf16 rounding of each fp32 prefix (|h| < 4: ulp 2**-6)
    assert float((out.float() - want).abs().max()) < 2e-2


def test_cpu_tensors_go_to_the_plain_version():
    a, b, h0 = map(torch.from_numpy, _numpy_inputs(RAGGED_CASE))
    before = ops.rglru_scan.launches
    out = ops.rglru_scan(a, b, h0)
    assert ops.rglru_scan.launches == before
    torch.testing.assert_close(out, rglru_scan_ref(a, b, h0), rtol=0, atol=0)


def test_kernel_refuses_cpu_tensors():
    """The kernel's binding never runs the plain version: off a CUDA
    device it raises before anything is built."""
    a, b, h0 = map(torch.from_numpy, _numpy_inputs(RAGGED_CASE))
    with pytest.raises(ValueError, match="not a CUDA device"):
        rglru_scan_kernel(a, b, h0)


# ------------------------------------------------------- kernel (CUDA card)
@pytest.mark.cuda
@pytest.mark.parametrize(
    "case", RGLRU_CASES + [SERVING_CASE, PREFILL_CASE, RAGGED_CASE], ids=str)
@pytest.mark.parametrize("with_h0", [True, False], ids=["h0", "zeros"])
def test_kernel_matches_ref_on_card(case, with_h0, cuda):
    a, b, h0 = (torch.from_numpy(x).to(cuda) for x in _numpy_inputs(case))
    h0 = h0 if with_h0 else None
    before = ops.rglru_scan.launches
    out = ops.rglru_scan(a, b, h0)
    torch.cuda.synchronize()
    assert ops.rglru_scan.launches == before + 1
    want = rglru_scan_ref(a, b, h0)
    assert out.dtype == torch.float32 and out.shape == want.shape
    assert float((out - want).abs().max()) < TOL


@pytest.mark.cuda
def test_kernel_bf16_on_card(cuda):
    a, b, h0 = (torch.from_numpy(x).to(cuda) for x in
                _numpy_inputs(SERVING_CASE))
    out = ops.rglru_scan(a.bfloat16(), b.bfloat16(), h0)
    want = rglru_scan_ref(a.bfloat16(), b.bfloat16(), h0)
    assert out.dtype == torch.bfloat16
    assert float((out.float() - want.float()).abs().max()) < 2e-2


@pytest.mark.cuda
def test_kernel_rejects_non_contiguous_input(cuda):
    a = torch.zeros(2, 8, 16, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ops.rglru_scan(a, a)
