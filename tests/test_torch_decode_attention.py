"""The port's decode attention against the JAX package's.

Inputs are drawn with numpy from a seed and handed to both frameworks.
Tolerances are those of ``tests/test_kernels.py``: 2e-5 in fp32 (the two
sides sum the same fp32 products in another order) and 2e-2 in bf16 (both
round the same fp32 result to bf16, so they can differ by one bf16 ulp).

The parity tests need JAX and skip without it; the kernel tests need a
CUDA card and ``nvcc`` and skip without them. On a machine with a card:
``python -m pytest tests/test_torch_decode_attention.py -m cuda``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention import ops  # noqa: E402
from repro_torch.kernels.decode_attention.kernel import (  # noqa: E402
    HEAD_TILE, SMEM_LIMIT, TILE, check_async_layout, decode_attention_kernel,
    padded, smem_bytes, split_plan,
)
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref,
)

# B, H, Kh, C, D, kwargs, pos: the shapes of tests/test_kernels.py
DECODE_CASES = [
    (2, 8, 2, 512, 64, {}, 300),
    (1, 4, 1, 1024, 128, dict(window=256), 900),
    (2, 4, 4, 512, 64, dict(chunk=256), 400),
    (3, 8, 8, 256, 128, {}, 100),
]
# qwen3-4b after a 1024-token prompt (C not a multiple of any tile) and
# recurrentgemma-9b's attention blocks past their 2048 window, where the
# ring has wrapped; the long case is for the card only
RAGGED_CASE = (2, 32, 8, 1040, 128, {}, 1030)
HYBRID_CASE = (2, 16, 1, 2048, 256, dict(window=2048), 2110)
LONG_CASE = (1, 32, 8, 32768, 128, {}, 32767)
# window 0 masks every slot: the oracle returns mean(v)
MASKED_CASE = (1, 4, 2, 96, 64, dict(window=0), 50)
# the bf16 kernel's edges: G 1, 16, 32 and 64 query heads per kv head (one
# to four m16 head tiles); C 1000, off the 16-slot tile; window and chunk
# borders inside a tile; a window that leaves most splits all masked next
# to a valid one; every slot masked over many splits (mean(v))
EDGE_CASES = [
    (1, 32, 32, 1000, 64, {}, 990),
    (2, 16, 1, 1000, 128, dict(window=300), 999),
    (1, 32, 1, 1040, 128, {}, 1030),
    (1, 64, 1, 2048, 256, dict(window=2048), 2115),
    (1, 8, 2, 512, 128, dict(window=37), 300),
    (1, 8, 2, 512, 64, dict(chunk=40), 300),
    (2, 32, 8, 1040, 128, dict(window=20), 1030),
    (1, 16, 1, 1000, 256, dict(window=0), 500),
]
# h2o-danube-3-4b: head dim 120, its rows padded to 128 in shared memory,
# on its wrapped 4096-slot ring past the window, and C off the tile
D120_CASES = [
    (2, 32, 8, 4096, 120, dict(window=4096), 4175),
    (1, 8, 2, 1000, 120, {}, 990),
]
D120_INTERPRET = (1, 8, 2, 256, 120, {}, 200)
# the decode paths' shapes: (B * Kh, G, C, D)
PATH_PLANS = [(16, 4, 1040, 128), (2, 16, 2048, 256), (8, 4, 32768, 128)]
# this slice's: h2o's ring (B2 Kh8, C 4096, D 120), seamless's
# self-attention (B2 Kh16 G1, a 64-token prompt + 16 steps, D 64) and
# llava's (B2 Kh8, 2880 patches + 64 tokens + 16 steps, D 128)
NEW_PATH_PLANS = [(16, 4, 4096, 120), (32, 1, 80, 64), (16, 4, 2960, 128)]

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# bf16, per element, over the plain output's size (P is rounded to bf16
# before P V): |kernel - plain| / (|plain| + rms of the plain row over D)
SCALED_TOL = 2 ** -6
DTYPES = [torch.float32, torch.bfloat16]


def _case_id(case):
    return (str(case[:5]) + "".join(f"-{k}{v}" for k, v in case[5].items())
            + f"-pos{case[6]}")


def _kpos(case):
    """Slot positions: 0..C-1 below, or a wrapped ring past C."""
    C, pos = case[3], case[6]
    if pos < C:
        return np.arange(C, dtype=np.int32)
    p = np.arange(pos + 1 - C, pos + 1, dtype=np.int32)
    return p[np.argsort(p % C)]


def _numpy_inputs(case, seed=0):
    B, H, Kh, C, D, _, _ = case
    rng = np.random.default_rng(seed + C + D)
    return (rng.standard_normal((B, H, D), dtype=np.float32),
            rng.standard_normal((B, Kh, C, D), dtype=np.float32),
            rng.standard_normal((B, Kh, C, D), dtype=np.float32))


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
def jax_decode():
    """The JAX package's kernel wrapper and oracle (JAX on the CPU)."""
    pytest.importorskip("jax")
    from repro.kernels.decode_attention import ops as jops
    from repro.kernels.decode_attention import ref as jref
    return jops.decode_attention, jref.decode_attention_ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernel)")
    return torch.device("cuda")


# ----------------------------------------------------------- parity (CPU)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", DECODE_CASES + [RAGGED_CASE],
                         ids=_case_id)
def test_ref_matches_jax_ref(case, dtype, jax_decode):
    import jax.numpy as jnp
    _, jref = jax_decode
    arrays = _numpy_inputs(case)
    kpos = _kpos(case)
    kw, pos = case[5], case[6]
    out = decode_attention_ref(*_torch(arrays, dtype),
                               torch.from_numpy(kpos), pos, **kw)
    want = jref(*_jax(arrays, dtype), jnp.asarray(kpos), pos, **kw)
    assert out.dtype == dtype and tuple(out.shape) == want.shape
    assert np.max(np.abs(_f32(out) - _f32(want))) < TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", D120_CASES, ids=_case_id)
def test_d120_matches_jax_ref(case, dtype, jax_decode):
    """Head dim 120 through the port's wrapper on the CPU, against the
    JAX oracle, on the wrapped ring and a ragged C."""
    import jax.numpy as jnp
    _, jref = jax_decode
    arrays = _numpy_inputs(case)
    kpos = _kpos(case)
    kw, pos = case[5], case[6]
    out = ops.decode_attention(*_torch(arrays, dtype),
                               torch.from_numpy(kpos), pos, **kw)
    want = jref(*_jax(arrays, dtype), jnp.asarray(kpos), pos, **kw)
    assert out.dtype == dtype and tuple(out.shape) == want.shape
    assert np.max(np.abs(_f32(out) - _f32(want))) < TOL[dtype]


@pytest.mark.parametrize("case", DECODE_CASES[:2] + [D120_INTERPRET],
                         ids=_case_id)
def test_ref_matches_pallas_interpret(case, jax_decode):
    """Against the Pallas kernel body itself, run by the interpreter as
    tests/test_kernels.py runs it (fp32 only: interpreting is slow)."""
    import jax.numpy as jnp
    jkernel, _ = jax_decode
    arrays = _numpy_inputs(case)
    kpos = _kpos(case)
    out = decode_attention_ref(*_torch(arrays, torch.float32),
                               torch.from_numpy(kpos), case[6], **case[5])
    want = jkernel(*_jax(arrays, torch.float32), jnp.asarray(kpos), case[6],
                   interpret=True, **case[5])
    assert np.max(np.abs(_f32(out) - _f32(want))) < TOL[torch.float32]


def test_ring_cache_semantics_match_jax(jax_decode):
    """tests/test_kernels.py's ring case: empty slots (-1) and slots out
    of the window are masked alike by the port's oracle and the Pallas
    kernel."""
    import jax.numpy as jnp
    jkernel, jref = jax_decode
    case = (1, 4, 2, 256, 64, dict(window=64), 99)
    arrays = _numpy_inputs(case)
    kpos = np.where(np.arange(256) < 100, np.arange(256), -1).astype(np.int32)
    out = decode_attention_ref(*_torch(arrays, torch.float32),
                               torch.from_numpy(kpos), 99, window=64)
    for fn, kw in ((jref, {}), (jkernel, dict(interpret=True))):
        want = fn(*_jax(arrays, torch.float32), jnp.asarray(kpos), 99,
                  window=64, **kw)
        assert np.max(np.abs(_f32(out) - _f32(want))) < 2e-5


def test_wrapped_ring_matches_jax(jax_decode):
    """recurrentgemma's attention blocks past the window: the ring holds
    positions pos-C+1..pos in slot order p % C."""
    import jax.numpy as jnp
    _, jref = jax_decode
    case = (1, 16, 1, 128, 256, dict(window=128), 140)
    arrays = _numpy_inputs(case)
    kpos = _kpos(case)
    assert kpos[0] == 128 and kpos[-1] == 127
    out = decode_attention_ref(*_torch(arrays, torch.float32),
                               torch.from_numpy(kpos), 140, window=128)
    want = jref(*_jax(arrays, torch.float32), jnp.asarray(kpos), 140,
                window=128)
    assert np.max(np.abs(_f32(out) - _f32(want))) < 2e-5


def test_all_masked_row_is_mean_of_v(jax_decode):
    """Every slot masked: the finite -1e30 gives a uniform softmax, mean(v)
    over all C slots, in both oracles."""
    import jax.numpy as jnp
    _, jref = jax_decode
    arrays = _numpy_inputs(MASKED_CASE)
    q, k, v = _torch(arrays, torch.float32)
    kpos = _kpos(MASKED_CASE)
    out = decode_attention_ref(q, k, v, torch.from_numpy(kpos), 50, window=0)
    G = q.shape[1] // k.shape[1]
    mean_v = v.mean(dim=2).repeat_interleave(G, dim=1)
    np.testing.assert_allclose(_f32(out), _f32(mean_v), atol=2e-6)
    want = jref(*_jax(arrays, torch.float32), jnp.asarray(kpos), 50,
                window=0)
    assert np.max(np.abs(_f32(out) - _f32(want))) < 2e-5


@pytest.mark.parametrize("groups,G,C,D,sms", [
    (16, 4, 1040, 128, 132), (2, 16, 2048, 256, 132), (8, 4, 32768, 128, 132),
    (1, 1, 5, 64, 132), (264, 1, 64, 64, 132), (96, 2, 512, 128, 132)])
def test_split_plan_covers_the_cache(groups, G, C, D, sms):
    """Splits are whole tiles, cover every slot, none starts past C, and
    no more CTAs are asked for than one wave holds, unless one split per
    group is already too many."""
    plan = split_plan(groups, G, C, D, sms)
    assert plan.split_len % TILE == 0 and plan.split_len > 0
    assert (plan.splits - 1) * plan.split_len < C <= plan.splits * plan.split_len
    assert plan.ctas <= sms * plan.ctas_per_sm or plan.splits == 1


@pytest.mark.parametrize("G", [1, 4, 16, 32, 64])
@pytest.mark.parametrize("shape", PATH_PLANS, ids=str)
def test_split_plan_at_path_shapes(shape, G):
    """At the paths' cache lengths and head dims, for every group size:
    the slots are covered by whole 16-slot tiles, the head tiles are
    ceil(G / 16), every warp has a tile, the partials stay under the
    plan's bound, and a CTA's shared memory fits the card's 227 KB."""
    groups, _, C, D = shape
    plan = split_plan(groups, G, C, D, 132)
    assert plan.split_len % TILE == 0
    assert (plan.splits - 1) * plan.split_len < C <= plan.splits * plan.split_len
    assert plan.head_tiles == -(-G // HEAD_TILE)
    assert plan.ctas == plan.splits * groups * plan.head_tiles
    assert plan.split_len >= 4 * TILE or plan.splits == 1
    assert plan.partial_bytes == plan.splits * G * D * 4 * groups
    assert plan.partial_bytes <= plan.partial_limit
    assert plan.partial_limit <= max(C * D * groups, G * D * 4 * groups)
    assert plan.smem_bytes <= SMEM_LIMIT and plan.stages >= 3
    assert 1 <= plan.ctas_per_sm and plan.ctas <= 132 * plan.ctas_per_sm


@pytest.mark.parametrize("shape", NEW_PATH_PLANS, ids=str)
def test_split_plan_at_this_slices_paths(shape):
    """h2o's, seamless's and llava's caches: covered by whole tiles,
    every warp with a tile or one split, the partials within bound and a
    CTA's shared memory within the card's."""
    plan = split_plan(*shape, 132)
    groups, G, C, D = shape
    assert (plan.splits - 1) * plan.split_len < C <= plan.splits * plan.split_len
    assert plan.split_len >= 4 * TILE or plan.splits == 1
    assert plan.partial_bytes <= plan.partial_limit
    assert plan.smem_bytes <= SMEM_LIMIT


def test_d120_rows_are_padded_to_128():
    """The bf16 kernel pads a D 120 row to 128 columns (8 k-steps of 16)
    plus 16 bytes: 272 bytes, 16 modulo 128, so an ldmatrix's 8 rows hit
    8 bank groups; its shared memory is D 128's."""
    assert padded(120) == 128 and padded(64) == 64
    assert (2 * padded(120) + 16) % 128 == 16
    assert smem_bytes(120) == smem_bytes(128)


def test_split_plan_at_the_decode_paths():
    """The plans chip_smoke.py prints: qwen3-4b's cache in 13 splits of 80
    slots at two CTAs an SM; recurrentgemma-9b's in 32 of 64 (the
    partials' bound); the long cache in one wave of 264 CTAs."""
    got = [split_plan(*shape, 132)[:5] for shape in PATH_PLANS]
    assert got == [(13, 80, 1, 208, 2), (32, 64, 1, 64, 1),
                   (33, 1008, 1, 264, 2)]


@pytest.mark.parametrize("layout", ["BKhCD", "model BCKhD view", "kpos"])
def test_async_layout_accepts_the_paths(layout):
    """The model's [B, C, Kh, D] cache handed over as a transposed view,
    a contiguous cache and kpos all pass the cp.async check."""
    if layout == "kpos":
        t = torch.arange(1040, dtype=torch.int32)
    elif layout == "BKhCD":
        t = torch.zeros(2, 8, 1040, 128, dtype=torch.bfloat16)
    else:
        t = torch.zeros(2, 1040, 8, 128, dtype=torch.bfloat16).transpose(1, 2)
    check_async_layout(layout, t)


@pytest.mark.parametrize("bad", ["offset base", "odd row stride"])
def test_async_layout_rejects_misaligned(bad):
    """A view whose base or row stride is off 16 bytes would break the
    16-byte copies: it raises ValueError, not a wrong read."""
    if bad == "offset base":      # 3 elements (6 bytes) into the storage
        flat = torch.zeros(3 + 2 * 8 * 1040 * 128, dtype=torch.bfloat16)
        t = flat[3:].view(2, 8, 1040, 128)
    else:                         # rows 130 elements (260 bytes) apart
        t = torch.zeros(2, 8, 1040, 130, dtype=torch.bfloat16)[..., :128]
    with pytest.raises(ValueError, match="cp.async"):
        check_async_layout("k", t)


def test_cpu_tensors_go_to_the_plain_version():
    arrays = _numpy_inputs(DECODE_CASES[0])
    q, k, v = _torch(arrays, torch.float32)
    kpos = torch.from_numpy(_kpos(DECODE_CASES[0]))
    before = ops.decode_attention.launches
    out = ops.decode_attention(q, k, v, kpos, 300)
    assert ops.decode_attention.launches == before
    torch.testing.assert_close(
        out, decode_attention_ref(q, k, v, kpos, 300), rtol=0, atol=0)


def test_kernel_refuses_cpu_tensors():
    """The kernel's binding never runs the plain version: off a CUDA
    device it raises before anything is built."""
    q, k, v = _torch(_numpy_inputs(DECODE_CASES[0]), torch.float32)
    kpos = torch.from_numpy(_kpos(DECODE_CASES[0]))
    with pytest.raises(ValueError, match="not a CUDA device"):
        decode_attention_kernel(q, k, v, kpos, 300)


# ------------------------------------------------------- kernel (CUDA card)
def _scaled_err(out, want) -> float:
    out, want = out.float(), want.float()
    rms = want.square().mean(-1, keepdim=True).sqrt()
    return float(((out - want).abs() / (want.abs() + rms)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize(
    "case", DECODE_CASES + [RAGGED_CASE, HYBRID_CASE, MASKED_CASE]
    + EDGE_CASES, ids=_case_id)
def test_kernel_matches_ref_on_card(case, dtype, cuda):
    q, k, v = _torch(_numpy_inputs(case), dtype, cuda)
    kpos = torch.from_numpy(_kpos(case)).to(cuda)
    kw, pos = case[5], case[6]
    before = ops.decode_attention.launches
    out = ops.decode_attention(q, k, v, kpos, pos, **kw)
    torch.cuda.synchronize()
    assert ops.decode_attention.launches == before + 1
    want = decode_attention_ref(q, k, v, kpos, pos, **kw)
    assert out.dtype == dtype and out.shape == want.shape
    assert float((out.float() - want.float()).abs().max()) < TOL[dtype]
    if dtype == torch.bfloat16:
        assert _scaled_err(out, want) < SCALED_TOL
    if kw.get("window") == 0:                  # every slot masked: mean(v)
        G = q.shape[1] // k.shape[1]
        mean_v = v.float().mean(dim=2).repeat_interleave(G, dim=1)
        assert float((out.float() - mean_v).abs().max()) < TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", D120_CASES, ids=_case_id)
def test_d120_on_card(case, dtype, cuda):
    """The D 120 instances on the model's [B, C, Kh, D] cache layout
    (h2o-danube-3-4b), held to the plain version as the other cases."""
    B, H, Kh, C, D, kw, pos = case
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn(B, H, D, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(B, C, Kh, D, generator=g, device=cuda).to(dtype)
            .transpose(1, 2) for _ in range(2))
    kpos = torch.from_numpy(_kpos(case)).to(cuda)
    before = ops.decode_attention.launches
    out = ops.decode_attention(q, k, v, kpos, pos, **kw)
    torch.cuda.synchronize()
    assert ops.decode_attention.launches == before + 1
    want = decode_attention_ref(q, k, v, kpos, pos, **kw)
    assert float((out.float() - want.float()).abs().max()) < TOL[dtype]
    if dtype == torch.bfloat16:
        assert _scaled_err(out, want) < SCALED_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_kernel_empty_slots_on_card(dtype, cuda):
    """Empty ring slots (kpos -1) inside and after the valid ones."""
    case = (1, 4, 2, 256, 64, dict(window=64), 99)
    q, k, v = _torch(_numpy_inputs(case), dtype, cuda)
    kpos = torch.from_numpy(np.where(np.arange(256) < 100, np.arange(256),
                                     -1).astype(np.int32)).to(cuda)
    out = ops.decode_attention(q, k, v, kpos, 99, window=64)
    want = decode_attention_ref(q, k, v, kpos, 99, window=64)
    assert float((out.float() - want.float()).abs().max()) < TOL[dtype]


@pytest.mark.cuda
def test_kernel_long_cache_on_card(cuda):
    q, k, v = _torch(_numpy_inputs(LONG_CASE), torch.bfloat16, cuda)
    kpos = torch.from_numpy(_kpos(LONG_CASE)).to(cuda)
    out = ops.decode_attention(q, k, v, kpos, LONG_CASE[6])
    want = decode_attention_ref(q, k, v, kpos, LONG_CASE[6])
    assert float((out.float() - want.float()).abs().max()) < 2e-2
    assert _scaled_err(out, want) < SCALED_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_kernel_reads_the_model_cache_layout(dtype, cuda):
    """The model's cache is [B, C, Kh, D]; decode_attend hands the kernel
    a [B, Kh, C, D] transposed view, which must give what a contiguous
    copy gives."""
    B, H, Kh, C, D = 2, 32, 8, 1040, 128
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(B, H, D, generator=g, device=cuda).to(dtype)
    k = torch.randn(B, C, Kh, D, generator=g, device=cuda).to(dtype)
    v = torch.randn(B, C, Kh, D, generator=g, device=cuda).to(dtype)
    kpos = torch.arange(C, dtype=torch.int32, device=cuda)
    views = [t.transpose(1, 2) for t in (k, v)]
    out = ops.decode_attention(q, *views, kpos, 1030)
    dense = ops.decode_attention(q, *[t.contiguous() for t in views], kpos,
                                 1030)
    torch.testing.assert_close(out, dense, rtol=0, atol=0)
    want = decode_attention_ref(q, *views, kpos, 1030)
    assert float((out.float() - want.float()).abs().max()) < TOL[dtype]


@pytest.mark.cuda
def test_kernel_rejects_a_device_position(cuda):
    q, k, v = _torch(_numpy_inputs(DECODE_CASES[0]), torch.float32, cuda)
    kpos = torch.from_numpy(_kpos(DECODE_CASES[0])).to(cuda)
    with pytest.raises(ValueError, match="host int"):
        ops.decode_attention(q, k, v, kpos, torch.tensor(300, device=cuda))
