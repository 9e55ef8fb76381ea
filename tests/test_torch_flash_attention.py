"""The port's flash attention against the JAX package's.

Inputs are drawn with numpy from a seed and handed to both frameworks.
Tolerances are those of ``tests/test_kernels.py``: 2e-5 in fp32 (the two
sides sum the same fp32 products in another order) and 2e-2 in bf16 (both
round the same fp32 result to bf16, so they can differ by one bf16 ulp
where the fp32 values straddle a rounding boundary).

On the card the bf16 kernel is also held to the reference's size: an
absolute 2e-2 is about the size of an output itself at long rows (a row
over n keys has outputs of about n ** -0.5), and one ulp past 4. So each
element's error, over |want| plus the rms of want's row (over D), must
stay under 2 ** -6: two bf16 ulps of the reference's size. The kernel
rounds P to bf16 (relative error under 2 ** -8 per weight, averaging out
over a row) and its output to bf16 (one ulp, under 2 ** -7 relative);
a dropped kv tile, a wrong scale or a mask off by a few keys moves a row
by several per cent of its size.

The parity tests need JAX and skip without it; the kernel tests need a
CUDA card and ``nvcc`` and skip without them. On a machine with a card:
``python -m pytest tests/test_torch_flash_attention.py -m cuda``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    SMS,
    check_tma_layout,
    flash_attention_kernel,
    warpgroups,
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
# the serving shapes: qwen3-4b (hi) and stablelm-1.6b (lo) at seq 48, and
# granite-20b (lo of pair B): MQA, 48 query heads on one kv head
SERVING_CASES = [
    (2, 32, 8, 48, 48, 128, {}),
    (4, 32, 32, 48, 48, 64, {}),
    (4, 48, 1, 48, 48, 128, {}),
]
# head dim 256: recurrentgemma-9b's MQA attention blocks (H 16, Kh 1,
# window 2048) at serving (batch 4, seq 48) and a shorter window that
# cuts the causal band; the 2100-token prompt is for the card only
D256_CASES = [
    (4, 16, 1, 48, 48, 256, dict(window=2048)),
    (1, 16, 1, 200, 200, 256, dict(window=64)),
]
D256_PROMPT = (2, 16, 1, 2100, 2100, 256, dict(window=2048))
# Sq and Sk not a multiple of the 64-row tile, with a window
RAGGED_CASE = (2, 4, 2, 48, 48, 64, dict(window=16))
# window 0 masks every key of every row: the oracle returns mean(v)
MASKED_CASE = (1, 4, 2, 40, 72, 64, dict(window=0))
# what the bf16 kernel's 64 x 64 tiling must get right: Sq and Sk off the
# tile grid with Sk != Sq; window and chunk borders inside a kv tile; D 96
# (two 64-column boxes, the second half zero-filled) past 128 rows; two
# warpgroups per CTA (``warpgroups``), one of them past Sq in the last CTA
EDGE_CASES = [
    (1, 4, 2, 100, 150, 64, dict(causal=False)),
    (2, 8, 2, 130, 77, 128, dict(causal=False)),
    (1, 4, 4, 256, 256, 64, dict(window=40)),
    (1, 4, 2, 320, 320, 128, dict(chunk=96)),
    (1, 4, 2, 200, 200, 96, {}),
    (1, 32, 8, 640, 640, 128, {}),
    (1, 32, 8, 530, 530, 64, dict(window=100)),
]
# h2o-danube-3-4b: head dim 120 (two 64-column boxes, columns 120-127
# zero-filled) at its serving shape (B4 H32 Kh8 S48), a window border
# inside a kv tile, and S off the tile grid; its 4160-token prompt past
# the 4096 window is for the card only
D120_CASES = [
    (4, 32, 8, 48, 48, 120, {}),
    (1, 8, 2, 256, 256, 120, dict(window=96)),
    (1, 4, 1, 200, 200, 120, {}),
]
D120_PROMPT = (2, 32, 8, 4160, 4160, 120, dict(window=4096))
# seamless-m4t-medium's cross-attention: non-causal, Sq != Sk, decoder
# rows (48 when serving, 1 at each decode step) over its 1024 frames; its
# encoder's non-causal self-attention and llava-next's 2881-token causal
# sequence (off every tile grid) are for the card only
CROSS_CASES = [
    (2, 16, 16, 48, 1024, 64, dict(causal=False)),
    (2, 16, 16, 1, 1024, 64, dict(causal=False)),
]
ENCODER_CASE = (2, 16, 16, 1024, 1024, 64, dict(causal=False))
LLAVA_CASE = (4, 32, 8, 2881, 2881, 128, dict(window=4096))
# small enough for the Pallas interpreter: D 120 and cross-shaped rows
INTERPRET_CASES = [
    (1, 8, 2, 256, 256, 120, dict(window=96)),
    (1, 4, 4, 48, 256, 64, dict(causal=False)),
    (1, 4, 4, 1, 256, 64, dict(causal=False)),
]

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SCALED_TOL = 2 ** -6        # bf16, per element, relative to want's size
DTYPES = [torch.float32, torch.bfloat16]


def _scaled_err(out, want):
    """max |out - want| / (|want| + rms of want's row over D)."""
    out, want = out.float(), want.float()
    rms = want.square().mean(-1, keepdim=True).sqrt()
    return float(((out - want).abs() / (want.abs() + rms)).max())


def _hold(out, want, dtype):
    """The kernel's output against the plain version's, at the tolerances
    of the module docstring."""
    assert float((out.float() - want.float()).abs().max()) < TOL[dtype]
    if dtype == torch.bfloat16:
        assert _scaled_err(out, want) < SCALED_TOL


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


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", D256_CASES, ids=_case_id)
def test_head_dim_256_matches_jax_ref(case, dtype, jax_flash):
    _, jref = jax_flash
    arrays = _numpy_inputs(case)
    out = ops.flash_attention(*_torch(arrays, dtype), **case[6])
    want = jref(*_jax(arrays, dtype), **case[6])
    assert out.dtype == dtype and tuple(out.shape) == want.shape
    assert np.max(np.abs(_f32(out) - _f32(want))) < TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", D120_CASES + CROSS_CASES, ids=_case_id)
def test_d120_and_cross_match_jax_ref(case, dtype, jax_flash):
    """h2o's head dim 120 and seamless's cross-attention (Sq != Sk, no
    mask) through the port's wrapper on the CPU, against the JAX
    oracle."""
    _, jref = jax_flash
    arrays = _numpy_inputs(case)
    out = ops.flash_attention(*_torch(arrays, dtype), **case[6])
    want = jref(*_jax(arrays, dtype), **case[6])
    assert out.dtype == dtype and tuple(out.shape) == want.shape
    assert np.max(np.abs(_f32(out) - _f32(want))) < TOL[dtype]


@pytest.mark.parametrize("case", FLASH_CASES[:2] + INTERPRET_CASES,
                         ids=_case_id)
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
    shapes = dict(ops.flash_attention.launches_by_shape)
    out = ops.flash_attention(q, k, v, window=16)
    assert ops.flash_attention.launches == before
    assert ops.flash_attention.launches_by_shape == shapes
    torch.testing.assert_close(out, flash_attention_ref(q, k, v, window=16),
                               rtol=0, atol=0)


# (B, H, Sq) of every path's bf16 launch, and two tiling-edge cases ->
# 64-row warpgroups per CTA (CTAs of 64 * warpgroups q rows)
PATH_WARPGROUPS = [
    ((2, 32, 48), 1),             # qwen3-4b serving: 64 CTAs
    ((4, 32, 48), 1),             # stablelm-1.6b serving: 128 CTAs
    ((4, 16, 48), 1),             # recurrentgemma-9b serving
    ((4, 48, 48), 2),             # granite-20b serving: 192, rows 64+ idle
    ((2, 32, 1024), 2),           # qwen3-4b prefill: 512 CTAs of 128 rows
    ((2, 16, 2100), 2),           # recurrentgemma-9b prompt: 544
    ((1, 32, 4096), 2),           # long: 1024
    ((1, 32, 640), 2),            # EDGE_CASES: 160 CTAs of 128 rows
    ((1, 4, 320), 1),             # EDGE_CASES: 12 would leave SMs idle
    ((4, 32, 48), 1),             # h2o-danube-3-4b serving (D 120)
    ((2, 32, 4160), 2),           # h2o-danube-3-4b prompt: 2112
    ((2, 16, 48), 1),             # seamless decoder and cross, serving
    ((2, 16, 1), 1),              # seamless cross at a decode step
    ((2, 16, 1024), 2),           # seamless encoder: 256
    ((4, 32, 2881), 2),           # llava-next serving: 2944
]


@pytest.mark.parametrize("args,wg", PATH_WARPGROUPS,
                         ids=[str(a) for a, _ in PATH_WARPGROUPS])
def test_launch_plan_at_path_shapes(args, wg):
    """Serving (S 48) keeps one warpgroup per CTA; prefill and long
    prompts put two (128 rows) on a CTA, as long as those CTAs still
    number one per SM."""
    assert warpgroups(*args) == wg
    B, H, Sq = args
    assert (B * H * -(-Sq // 128) >= SMS) == (wg == 2)


# [B, S, heads, D] buffers of the paths, seen as [B, heads, S, D]
PATH_LAYOUTS = [(2, 48, 32, 128), (2, 48, 8, 128), (4, 48, 32, 64),
                (4, 48, 16, 256), (4, 48, 1, 256), (4, 48, 48, 128),
                (4, 48, 1, 128), (2, 2100, 16, 256), (1, 4096, 32, 128),
                (1, 200, 4, 96), (4, 48, 32, 120), (4, 48, 8, 120),
                (2, 1024, 16, 64), (4, 2881, 8, 128)]


@pytest.mark.parametrize("shape", PATH_LAYOUTS, ids=str)
def test_tma_layout_accepts_path_layouts(shape):
    buf = torch.empty(shape, dtype=torch.bfloat16)
    check_tma_layout("q", buf.transpose(1, 2))
    check_tma_layout("q", buf.transpose(1, 2).contiguous())


def test_tma_layout_rejects_misaligned_views():
    """A base address or a stride off the 16-byte grid raises ValueError,
    before anything is built or launched."""
    buf = torch.empty(2 * 48 * 8 * 128 + 8, dtype=torch.bfloat16)
    check_tma_layout("k", buf[8:].view(2, 48, 8, 128).transpose(1, 2))
    shifted = buf[1:1 + 2 * 48 * 8 * 128].view(2, 48, 8, 128)
    with pytest.raises(ValueError, match="data_ptr"):
        check_tma_layout("k", shifted.transpose(1, 2))
    narrow = torch.empty(2, 48, 8, 100, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="dim 1 stride 100"):
        check_tma_layout("k", narrow.transpose(1, 2))
    with pytest.raises(ValueError, match="last-dim stride"):
        check_tma_layout("k", torch.empty(1, 2, 64, 64).transpose(2, 3))


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
    "case", FLASH_CASES + SERVING_CASES + D256_CASES + EDGE_CASES
    + [D256_PROMPT, RAGGED_CASE, MASKED_CASE], ids=_case_id)
def test_kernel_matches_ref_on_card(case, dtype, cuda):
    q, k, v = _torch(_numpy_inputs(case), dtype, cuda)
    before = ops.flash_attention.launches
    at_shape = ops.flash_attention.launches_by_shape[case[:6]]
    out = ops.flash_attention(q, k, v, **case[6])
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    assert ops.flash_attention.launches_by_shape[case[:6]] == at_shape + 1
    want = flash_attention_ref(q, k, v, **case[6])
    assert out.dtype == dtype and out.shape == want.shape
    _hold(out, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", SERVING_CASES + [D256_CASES[0], D256_PROMPT],
                         ids=_case_id)
def test_kernel_takes_transposed_projections(case, dtype, cuda):
    """attend passes [B,S,H,D] projections as transposed views: the same
    result as on contiguous copies, and the plain version's."""
    B, H, Kh, S, _, D, kw = case
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(B, S, n, D, generator=g, device=cuda).to(dtype)
               for n in (H, Kh, Kh))
    views = [t.transpose(1, 2) for t in (q, k, v)]
    out = ops.flash_attention(*views, **kw)
    dense = ops.flash_attention(*[t.contiguous() for t in views], **kw)
    torch.testing.assert_close(out, dense, rtol=0, atol=0)
    want = flash_attention_ref(*views, **kw)
    _hold(out, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize(
    "case", D120_CASES + CROSS_CASES + [D120_PROMPT, ENCODER_CASE,
                                        LLAVA_CASE], ids=_case_id)
def test_d120_and_cross_on_card(case, dtype, cuda):
    """The D 120 instances (h2o-danube-3-4b) and the cross-attention,
    encoder and llava shapes of this slice's paths, on attend's
    transposed [B, S, heads, D] views."""
    B, H, Kh, Sq, Sk, D, kw = case
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn(B, S, n, D, generator=g, device=cuda)
               .to(dtype).transpose(1, 2)
               for S, n in ((Sq, H), (Sk, Kh), (Sk, Kh)))
    before = ops.flash_attention.launches
    out = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    _hold(out, flash_attention_ref(q, k, v, **kw), dtype)


@pytest.mark.cuda
def test_kernel_rejects_unsupported_head_dim(cuda):
    """Head dims the kernel has no instance of raise (64, 96, 120, 128
    and 256 have one)."""
    q = torch.zeros(1, 2, 16, 80, device=cuda)
    with pytest.raises(ValueError, match="head dim 80"):
        ops.flash_attention(q, q, q)
