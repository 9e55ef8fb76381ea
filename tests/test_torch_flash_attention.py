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
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    BWD_PASSES,
    SMS,
    aligned_dout,
    bwd_plan,
    check_tma_layout,
    flash_attention_bwd_kernel,
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


# ------------------------------------------------------------- backward
# The plain backward (autograd of ref.py) against jax.grad of the JAX
# package's ref.py, and the backward kernel against the plain backward.
# Cases: every mask, GQA and MQA, Sq != Sk with and without causality, the
# all-masked rows, head dims 64 to 256
BWD_CASES = FLASH_CASES + [
    RAGGED_CASE, MASKED_CASE,
    (1, 4, 2, 100, 150, 64, dict(causal=False)),
    (2, 8, 2, 130, 77, 128, {}),
    (1, 4, 2, 320, 320, 128, dict(chunk=96)),
    (1, 8, 2, 256, 256, 120, dict(window=96)),
    (1, 16, 1, 200, 200, 256, dict(window=64)),
    (2, 16, 16, 48, 1024, 64, dict(causal=False)),
]
# the card's train shapes: qwen3-4b's layer (B2 S2048 D128 GQA) and the
# hybrid's attention block (MQA, D 256, its 2048 window crossed at 2100)
BWD_TRAIN_CASES = [
    (2, 32, 8, 2048, 2048, 128, {}),
    (2, 16, 1, 2100, 2100, 256, dict(window=2048)),
]
# the backward's tolerances, on a scaled error: each element against
# |want| plus the rms of the whole gradient (not of its row, as the
# forward's: a gradient row can be exactly zero, e.g. dq of the first
# causal row, whose one weight is 1, and the kernel's rounding there is
# then all the row has); fp32 1e-4 (the sums run in another order over up
# to Sq * G terms), bf16 2e-2 (both sides compute in fp32 from the same
# bf16 inputs and round once). In bf16 the plain backward runs on the
# inputs upcast to fp32 and its gradients are rounded once: autograd of
# the bf16 call rounds each query head's dk and dv to bf16 before it sums
# a kv head's group, a rounding of each addend that the kernel does not
# make (it sums the group in fp32)
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _grad_err(got, want) -> float:
    """max |got - want| / (|want| + rms of want); a gradient that is zero
    everywhere (dq and dk where every key is masked) must be zero."""
    got, want = got.float(), want.float()
    rms = want.square().mean().sqrt().clamp_min(torch.finfo().tiny)
    return float(((got - want).abs() / (want.abs() + rms)).max())


def _cotangent(case, seed=1):
    B, H, Kh, Sq, Sk, D, _ = case
    return np.random.default_rng(seed + Sq).standard_normal(
        (B, H, Sq, D), dtype=np.float32)


def _torch_grads(fn, arrays, dout, dtype, device="cpu", views=False):
    """(out, dq, dk, dv) of ``fn`` through autograd; ``views``: q, k, v
    as attend passes them, transposed views of [B, S, heads, D]."""
    if views:
        ts = [torch.from_numpy(a).to(device=device, dtype=dtype)
              .transpose(1, 2).contiguous().transpose(1, 2)
              for a in arrays]
    else:
        ts = _torch(arrays, dtype, device)
    for t in ts:
        t.requires_grad_(True)
    out = fn(*ts)
    out.backward(torch.from_numpy(dout).to(device=device, dtype=dtype))
    return (out,) + tuple(t.grad for t in ts)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", BWD_CASES, ids=_case_id)
def test_ref_backward_matches_jax_grad(case, dtype, jax_flash):
    """dq, dk, dv of the plain version (autograd) against jax.vjp of the
    JAX oracle, on the same inputs and cotangent."""
    import jax
    _, jref = jax_flash
    arrays, dout, kw = _numpy_inputs(case), _cotangent(case), case[6]
    _, *grads = _torch_grads(lambda q, k, v: flash_attention_ref(
        q, k, v, **kw), arrays, dout, dtype)
    _, vjp = jax.vjp(lambda q, k, v: jref(q, k, v, **kw),
                     *_jax(arrays, dtype))
    want = vjp(*_jax([dout], dtype))
    for g, w in zip(grads, want):
        assert g.dtype == dtype and tuple(g.shape) == w.shape
        scale = max(1.0, float(np.max(np.abs(_f32(w)))))
        assert np.max(np.abs(_f32(g) - _f32(w))) < TOL[dtype] * scale


def test_ref_backward_of_an_all_masked_row():
    """A row with every key masked got mean(v): its cotangent reaches dv
    as dO / Sk at every key (summed over the kv head's group), and dq and
    dk get nothing from it."""
    arrays, dout = _numpy_inputs(MASKED_CASE), _cotangent(MASKED_CASE)
    _, dq, dk, dv = _torch_grads(lambda q, k, v: flash_attention_ref(
        q, k, v, **MASKED_CASE[6]), arrays, dout, torch.float32)
    B, H, Kh, Sq, Sk, D, _ = MASKED_CASE
    want_dv = dout.reshape(B, Kh, H // Kh, Sq, D).sum((2, 3)) / Sk
    np.testing.assert_allclose(
        _f32(dv), np.broadcast_to(want_dv[:, :, None], (B, Kh, Sk, D)),
        atol=1e-5)
    assert float(dq.abs().max()) == 0.0 and float(dk.abs().max()) == 0.0


def test_cpu_backward_launches_no_kernel():
    arrays = _numpy_inputs(RAGGED_CASE)
    before = (ops.flash_attention.launches, ops.flash_attention.bwd_launches)
    _torch_grads(lambda q, k, v: ops.flash_attention(q, k, v, window=16),
                 arrays, _cotangent(RAGGED_CASE), torch.float32)
    assert (ops.flash_attention.launches,
            ops.flash_attention.bwd_launches) == before


def _hold_grad(got, want, dtype):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert _grad_err(got, want) < BWD_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", BWD_CASES + BWD_TRAIN_CASES, ids=_case_id)
def test_backward_kernel_matches_ref_on_card(case, dtype, cuda):
    """The backward kernel, reached through autograd on attend's
    transposed views, against autograd of the plain version; the forward
    counts one launch and the backward its passes."""
    _hold_backward_on_card(case, dtype, cuda)


def _hold_backward_on_card(case, dtype, cuda):
    arrays, dout, kw = _numpy_inputs(case), _cotangent(case), case[6]
    before = (ops.flash_attention.launches, ops.flash_attention.bwd_launches)
    out, *grads = _torch_grads(lambda q, k, v: ops.flash_attention(
        q, k, v, **kw), arrays, dout, dtype, cuda, views=True)
    torch.cuda.synchronize()
    assert (ops.flash_attention.launches,
            ops.flash_attention.bwd_launches) == (
                before[0] + 1, before[1] + BWD_PASSES[dtype])
    _, *want = _torch_grads(lambda q, k, v: flash_attention_ref(
        q, k, v, **kw), [_f32(t) for t in _torch(arrays, dtype)],
        _f32(torch.from_numpy(dout).to(dtype)), torch.float32, cuda,
        views=True)
    for g, w in zip(grads, want):
        _hold_grad(g, w.to(dtype), dtype)
    assert grads[0].stride() == want[0].stride()    # [B, S, H, D] layout


@pytest.mark.cuda
def test_backward_kernel_all_masked_rows_on_card(cuda):
    """dv = dO / Sk at every key where every key of a row is masked, and
    no dq or dk, as the plain backward gives."""
    arrays, dout = _numpy_inputs(MASKED_CASE), _cotangent(MASKED_CASE)
    _, dq, dk, dv = _torch_grads(lambda q, k, v: ops.flash_attention(
        q, k, v, **MASKED_CASE[6]), arrays, dout, torch.float32, cuda)
    B, H, Kh, Sq, Sk, D, _ = MASKED_CASE
    want_dv = dout.reshape(B, Kh, H // Kh, Sq, D).sum((2, 3)) / Sk
    np.testing.assert_allclose(
        _f32(dv), np.broadcast_to(want_dv[:, :, None], (B, Kh, Sk, D)),
        atol=1e-5)
    assert float(dq.abs().max()) == 0.0 and float(dk.abs().max()) == 0.0


# --------------------------------------------- backward launch plan (CPU)
# a small MQA case whose dK/dV CTAs split the 16 query heads, with S off
# the 64-row tile grid and a window inside the band
MQA_SPLIT_CASE = (1, 16, 1, 200, 200, 256, dict(window=96))
# the train shapes' bf16 plans, reckoned by hand: qwen3-4b's dQ CTAs hold
# two 64-row warpgroups (B2 H32 x 16 tiles of 128 rows = 1024 CTAs), its
# dK/dV CTAs 128 keys (B2 Kh8 x 16 = 256, no split); the hybrid's dQ CTAs
# one warpgroup (D 256; B2 H16 x 33 tiles = 1056), its dK/dV CTAs 64 keys
# (B2 Kh1 x 33 = 66 < 132 SMs, so the 16 heads split by 4: 264 CTAs, two
# waves), 4 x 66 fp32 partials of 64 keys x 256 x (dk, dv), 66 counters;
# the stats are B * H * (lse, Di) * Sq padded to 64 floats
TRAIN_PLANS = [
    ((2, 32, 8, 2048, 2048, 128),
     dict(passes=2, dq_rows=128, dq_warpgroups=2, dq_ctas=1024,
          kv_keys=128, head_split=1, kv_ctas=256,
          stats_bytes=2 * 32 * 2 * 2048 * 4, partial_bytes=0,
          counter_bytes=0)),
    ((2, 16, 1, 2100, 2100, 256),
     dict(passes=2, dq_rows=64, dq_warpgroups=1, dq_ctas=1056, kv_keys=64,
          head_split=4, kv_ctas=264, stats_bytes=2 * 16 * 2 * 2112 * 4,
          partial_bytes=4 * 66 * 64 * 256 * 2 * 4, counter_bytes=66 * 4)),
]


@pytest.mark.parametrize("shape,want", TRAIN_PLANS,
                         ids=[str(s) for s, _ in TRAIN_PLANS])
def test_backward_plan_at_train_shapes(shape, want):
    """Both bf16 kernels fill the card at the train shapes (at least one
    CTA per SM), with the head split and scratch reckoned by hand."""
    plan = bwd_plan(*shape, torch.bfloat16)
    assert plan._asdict() == want
    assert plan.dq_ctas >= SMS and plan.kv_ctas >= SMS


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize(
    "case", BWD_CASES + BWD_TRAIN_CASES + [MQA_SPLIT_CASE], ids=_case_id)
def test_backward_plan_at_test_shapes(case, dtype):
    """The plan's parts against their rules: the kernel count per dtype;
    dQ CTAs cover Sq; a head split only where the unsplit dK/dV grid
    leaves SMs idle, by the smallest divisor of the group that gives two
    waves (or the whole group); partials and counters only with a split,
    sized per key tile."""
    B, H, Kh, Sq, Sk, D, _ = case
    plan = bwd_plan(B, H, Kh, Sq, Sk, D, dtype)
    G = H // Kh
    assert plan.passes == BWD_PASSES[dtype]
    assert plan.stats_bytes == B * H * 2 * (-(-Sq // 64) * 64) * 4
    assert plan.dq_ctas == B * H * -(-Sq // plan.dq_rows)
    assert G % plan.head_split == 0
    groups = plan.kv_ctas // plan.head_split
    assert groups == B * Kh * -(-Sk // plan.kv_keys)
    if dtype == torch.float32:
        assert (plan.dq_rows, plan.kv_keys, plan.head_split) == (32, 32, 1)
        return
    assert plan.dq_rows == 64 * plan.dq_warpgroups
    assert plan.dq_warpgroups == (1 if D > 128 else warpgroups(B, H, Sq))
    assert plan.kv_keys == (64 if D > 128 else 128)
    enough = [d for d in range(1, G + 1)
              if G % d == 0 and groups * d >= 2 * SMS]
    assert plan.head_split == (1 if groups >= SMS else
                               (enough[0] if enough else G))
    d_pad = -(-D // 64) * 64
    split = plan.head_split > 1
    assert plan.partial_bytes == (plan.kv_ctas * plan.kv_keys * d_pad * 8
                                  if split else 0)
    assert plan.counter_bytes == (groups * 4 if split else 0)


def test_backward_plan_splits_the_mqa_case():
    """The card test below reaches the split path: 4 key tiles of one kv
    head split 16 ways."""
    plan = bwd_plan(*MQA_SPLIT_CASE[:6], torch.bfloat16)
    assert (plan.head_split, plan.kv_ctas) == (16, 64)


# [B, S, heads, D] projections of the backward's paths and cases, seen as
# [B, heads, S, D]; the gradients are empty_like of them
GRAD_LAYOUTS = [(2, 2048, 32, 128), (2, 2048, 8, 128), (2, 2100, 16, 256),
                (2, 2100, 1, 256), (1, 200, 16, 256), (1, 256, 8, 120),
                (2, 130, 8, 128), (2, 77, 2, 128), (2, 48, 4, 64),
                (1, 512, 4, 96), (2, 1024, 16, 64)]


@pytest.mark.parametrize("shape", GRAD_LAYOUTS, ids=str)
def test_tma_layout_accepts_gradient_views(shape):
    """dq, dk and dv are written straight into attend's [B, S, H, D]
    layout (empty_like keeps the transposed strides), and that layout, as
    dout's contiguous [B, H, S, D], passes the TMA check."""
    view = torch.empty(shape, dtype=torch.bfloat16).transpose(1, 2)
    grad = torch.empty_like(view)
    assert grad.stride() == view.stride()
    check_tma_layout("dq", grad)
    dout = torch.empty(view.shape, dtype=torch.bfloat16)
    check_tma_layout("dout", dout)
    assert aligned_dout(dout) is dout
    assert aligned_dout(view) is view


def test_aligned_dout_copies_a_misaligned_cotangent():
    """A dout off the 16-byte grid (here shifted by one element) is
    copied into a contiguous tensor that the TMA check accepts, with the
    same values; a dout whose last dim is not contiguous is copied too."""
    B, H, S, D = 2, 8, 48, 128
    buf = torch.randn(B * H * S * D + 1).bfloat16()
    shifted = buf[1:].view(B, S, H, D).transpose(1, 2)
    with pytest.raises(ValueError, match="data_ptr"):
        check_tma_layout("dout", shifted)
    fixed = aligned_dout(shifted)
    check_tma_layout("dout", fixed)
    assert fixed.is_contiguous() and torch.equal(fixed, shifted)
    strided = torch.randn(B, H, D, S).bfloat16().transpose(2, 3)
    fixed = aligned_dout(strided)
    assert fixed.stride(-1) == 1 and torch.equal(fixed, strided)


def test_backward_kernel_refuses_cpu_tensors():
    """The backward's binding never runs the plain version: off a CUDA
    device it raises before anything is built."""
    q, k, v = _torch(_numpy_inputs(RAGGED_CASE), torch.bfloat16)
    with pytest.raises(ValueError, match="not a CUDA device"):
        flash_attention_bwd_kernel(q, k, v, q, window=16)


# -------------------------------------------- backward (CUDA card), more
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_backward_kernel_head_split_on_card(dtype, cuda):
    """The MQA case whose dK/dV partials are summed across 16 CTAs, S off
    the tile grid and a window in the band, against the plain version."""
    _hold_backward_on_card(MQA_SPLIT_CASE, dtype, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("case", BWD_TRAIN_CASES + [MQA_SPLIT_CASE],
                         ids=_case_id)
def test_backward_kernel_is_bit_identical_on_card(case, cuda):
    """Two bf16 backward calls on the same inputs give the same bits: no
    sum depends on the order in which CTAs finish."""
    B, H, Kh, Sq, Sk, D, kw = case
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(B, S, n, D, generator=g, device=cuda)
               .bfloat16().transpose(1, 2)
               for S, n in ((Sq, H), (Sk, Kh), (Sk, Kh)))
    dout = torch.randn(B, H, Sq, D, generator=g, device=cuda).bfloat16()
    first = flash_attention_bwd_kernel(q, k, v, dout, **kw)
    second = flash_attention_bwd_kernel(q, k, v, dout, **kw)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("bwd", [False, True], ids=["forward", "backward"])
def test_bf16_kernels_launch_from_a_thread_without_a_context(bwd, cuda):
    """The bf16 instances encode their TMA maps with a driver call, which
    needs a context current on the calling thread. A thread that has made
    no CUDA runtime call has none: autograd's device thread, when
    PyTorch's allocator serves every tensor from its cache (llama4's
    first backward in a process met this). Such a thread's call must give
    the main thread's bits."""
    B, H, Kh, S, D = 2, 40, 8, 256, 128
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn(B, S, n, D, generator=g, device=cuda)
               .bfloat16().transpose(1, 2) for n in (H, Kh, Kh))
    dout = torch.randn(B, H, S, D, generator=g, device=cuda).bfloat16()

    def call():
        if bwd:
            return flash_attention_bwd_kernel(q, k, v, dout, chunk=128)
        return (flash_attention_kernel(q, k, v, chunk=128),)
    call()                 # libraries built, outputs back in the cache
    torch.cuda.synchronize()
    out = []

    def run():
        try:
            out.append(call())
        except RuntimeError as e:
            out.append(e)
    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and len(out) == 1
    assert not isinstance(out[0], RuntimeError), out[0]
    want = call()
    torch.cuda.synchronize()
    for a, b in zip(out[0], want):
        assert torch.equal(a, b)
