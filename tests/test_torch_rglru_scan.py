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

from repro_torch.kernels.rglru_scan import kernel, ops  # noqa: E402
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
# B 1 at a long prompt: the shape a grid of 32-column tiles underfills
LONG_CASE = (1, 8192, 4096)
# the kernel's edges: S = 1; S one short of and one past a block (the
# prompt's plan, 96-row blocks) and of two; W no multiple of the tile
# (32 columns at 4100, 16 at 1001)
EDGE_CASES = [(4, 1, 4096), (2, 95, 4096), (2, 97, 4096), (2, 191, 4096),
              (2, 193, 4096), (2, 300, 4100), (3, 129, 1001)]
H100_SMS = 132
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


# ------------------------------------------------- the kernel's plan (CPU)
PLAN_SHAPES = ([SERVING_CASE, PREFILL_CASE, LONG_CASE, RAGGED_CASE]
               + EDGE_CASES + RGLRU_CASES + [(1, 1, 1), (5, 3, 33)])
PLAN_DTYPES = [torch.float32, torch.bfloat16]


def _covered(plan, B, W):
    """How often the launch's CTAs touch each (b, w) column: CTA i takes
    batch row i // tiles and columns of tile i % tiles below W."""
    seen = np.zeros((B, W), np.int64)
    for cta in range(plan.ctas):
        bi, tile = divmod(cta, plan.tiles)
        seen[bi, tile * plan.tw:min(W, (tile + 1) * plan.tw)] += 1
    return seen


@pytest.mark.parametrize("dtype", PLAN_DTYPES, ids=str)
@pytest.mark.parametrize("case", PLAN_SHAPES, ids=str)
def test_scan_plan_covers_every_column_once(case, dtype):
    B, S, W = case
    plan = kernel.scan_plan(B, S, W, dtype, H100_SMS)
    assert plan.ctas == B * plan.tiles and plan.tiles * plan.tw >= W
    assert (plan.tiles - 1) * plan.tw < W
    assert (_covered(plan, B, W) == 1).all()
    # every row in exactly one block: the last block holds row S - 1
    assert (plan.blocks - 1) * plan.block_rows < S <= (
        plan.blocks * plan.block_rows)


@pytest.mark.parametrize("dtype", PLAN_DTYPES, ids=str)
@pytest.mark.parametrize("case", PLAN_SHAPES, ids=str)
def test_scan_plan_within_the_instance_limits(case, dtype):
    B, S, W = case
    plan = kernel.scan_plan(B, S, W, dtype, H100_SMS)
    esz = torch.empty((), dtype=dtype).element_size()
    assert plan.tw in kernel.TILE_WIDTHS and plan.tw * esz >= kernel.SECTOR
    assert 1 <= plan.nseg <= -(-S // kernel.ROWS)
    assert plan.threads == plan.tw * plan.nseg <= kernel.MAX_THREADS
    assert plan.block_rows == plan.nseg * kernel.ROWS
    assert plan == kernel.plan_for(B, S, W, plan.tw, plan.nseg)


@pytest.mark.parametrize("dtype", PLAN_DTYPES, ids=str)
@pytest.mark.parametrize("case", [PREFILL_CASE, LONG_CASE, SERVING_CASE],
                         ids=str)
def test_scan_plan_fills_a_wave(case, dtype):
    """Every SM of an H100 gets a CTA, B = 1 included; where S is long
    enough, a CTA takes as many segments as the plan's caps allow."""
    plan = kernel.scan_plan(*case, dtype, H100_SMS)
    assert plan.ctas >= H100_SMS
    if case[1] >= kernel.PLAN_THREADS // plan.tw * kernel.ROWS:
        assert plan.threads == kernel.PLAN_THREADS


def test_scan_plan_at_the_path_shapes():
    """The plans chip_smoke.py prints: serving one block of 3 segments,
    the prompt 22 blocks of 96 rows, B 1 on 16-column tiles."""
    f32 = torch.float32
    got = {case: kernel.scan_plan(*case, f32, H100_SMS)[:2] for case in
           (SERVING_CASE, PREFILL_CASE, LONG_CASE)}
    assert got == {SERVING_CASE: (32, 3), PREFILL_CASE: (32, 6),
                   LONG_CASE: (16, 12)}
    assert kernel.scan_plan(*PREFILL_CASE, f32, H100_SMS).blocks == 22
    assert kernel.scan_plan(*PREFILL_CASE, torch.bfloat16,
                            H100_SMS)[:2] == (32, 6)
    # the edge cases sit one row around a block and two of the prompt's
    for S, edge in ((95, -1), (97, 1), (191, -1), (193, 1)):
        plan = kernel.scan_plan(2, S, 4096, f32, H100_SMS)
        assert plan.block_rows == 96 and (S - edge) % 96 == 0


def _fma(x, y, z):
    """fmaf: the exact product (float64 holds it) plus z, one rounding
    to float32 (double rounding of the sum aside)."""
    return (x.astype(np.float64) * y + z).astype(np.float32)


def _emulate_kernel(a, b, h0, plan):
    """The kernel's order of operations in numpy float32, CTA by CTA:
    rows past S padded with a = 1, b = 0; per segment of ROWS rows a
    local scan from zero giving (A = prod a, H = h_end); the (A, H) chain
    over the segments of each block and across blocks, from h0, giving
    each segment's carry-in; the re-walk from it. Columns past W are not
    touched, and every column is written by exactly one CTA."""
    B, S, W = a.shape
    R, L = kernel.ROWS, plan.block_rows
    out = np.full(a.shape, np.nan, np.float32)
    pad = plan.blocks * L - S
    for cta in range(plan.ctas):
        bi, tile = divmod(cta, plan.tiles)
        cols = np.arange(tile * plan.tw, min(W, (tile + 1) * plan.tw))
        if cols.size == 0:
            continue
        n = cols.size
        ac = np.concatenate([a[bi][:, cols], np.ones((pad, n), np.float32)])
        bc = np.concatenate([b[bi][:, cols], np.zeros((pad, n), np.float32)])
        ac = ac.reshape(plan.blocks, plan.nseg, R, n)
        bc = bc.reshape(plan.blocks, plan.nseg, R, n)
        A = np.ones((plan.blocks, plan.nseg, n), np.float32)
        H = np.zeros_like(A)
        for r in range(R):
            A = A * ac[:, :, r]
            H = _fma(ac[:, :, r], H, bc[:, :, r])
        carry = (np.zeros(n, np.float32) if h0 is None
                 else h0[bi, cols].astype(np.float32))
        c_in = np.empty_like(A)
        for k in range(plan.blocks):
            for j in range(plan.nseg):
                c_in[k, j] = carry
                carry = _fma(A[k, j], carry, H[k, j])
        h, hs = c_in, np.empty_like(ac)
        for r in range(R):
            h = _fma(ac[:, :, r], h, bc[:, :, r])
            hs[:, :, r] = h
        out[bi][:, cols] = hs.reshape(plan.blocks * L, n)[:S]
    return out


def _emulation_cases():
    """(case, plan): S 2100 at narrow W under its own plan and under the
    prompt's; the ragged case; S one around one and two blocks of several
    plans (W 40: the 32-column tile is ragged)."""
    cases = [((2, 2100, 40), None), ((2, 2100, 40), (32, 8)),
             (RAGGED_CASE, None)]
    for tw, nseg in ((32, 6), (16, 12), (8, 24), (32, 8), (16, 16),
                     (32, 3)):
        L = nseg * kernel.ROWS
        cases += [((2, S, 40), (tw, nseg))
                  for S in (L - 1, L + 1, 2 * L - 1, 2 * L + 1)]
    return cases


@pytest.mark.parametrize("case,forced", _emulation_cases(), ids=str)
def test_kernel_order_matches_jax_oracle(case, forced, jax_rglru):
    import jax.numpy as jnp
    _, jref = jax_rglru
    B, S, W = case
    plan = (kernel.scan_plan(B, S, W, torch.float32, H100_SMS)
            if forced is None else kernel.plan_for(B, S, W, *forced))
    a, b, h0 = _numpy_inputs(case)
    out = _emulate_kernel(a, b, h0, plan)
    want = jref(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
    assert not np.isnan(out).any()
    assert _max_err(torch.from_numpy(out), want) < TOL


# ------------------------------------------------------- kernel (CUDA card)
@pytest.mark.cuda
@pytest.mark.parametrize(
    "case", RGLRU_CASES + [SERVING_CASE, PREFILL_CASE, RAGGED_CASE]
    + EDGE_CASES + [LONG_CASE], ids=str)
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
@pytest.mark.parametrize("case", [PREFILL_CASE, (2, 129, 4100)], ids=str)
@pytest.mark.parametrize("with_h0", [True, False], ids=["h0", "zeros"])
def test_kernel_bf16_prompt_on_card(case, with_h0, cuda):
    """bf16 over many blocks: the carry into the next segment and block
    is the fp32 state, so the prefixes stay one bf16 rounding of the
    plain version's."""
    a, b, h0 = (torch.from_numpy(x).to(cuda) for x in _numpy_inputs(case))
    h0 = h0 if with_h0 else None
    out = ops.rglru_scan(a.bfloat16(), b.bfloat16(), h0)
    want = rglru_scan_ref(a.bfloat16(), b.bfloat16(), h0)
    assert out.dtype == torch.bfloat16
    assert float((out.float() - want.float()).abs().max()) < 2e-2


@pytest.mark.cuda
def test_kernel_rejects_non_contiguous_input(cuda):
    a = torch.zeros(2, 8, 16, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ops.rglru_scan(a, a)


# ------------------------------------------------------------- backward
# The plain backward (autograd of ref.py) against jax.grad of the JAX
# package's oracle, and the backward kernel against the plain backward:
# with and without h0, S = 1, ragged shapes, the hybrid's train shape,
# fp32 (the hybrid's gates) and bf16.
BWD_CASES = RGLRU_CASES[:2] + [RAGGED_CASE, (4, 1, 4096), (2, 97, 4096)]
BWD_TRAIN_CASE = (2, 2100, 4096)
# the backward kernel's edges on the card: S one short of and one past one
# and two of its fp32 train plan's 64-row blocks; W off the 32-column tile
BWD_EDGE_CASES = [(2, 63, 4096), (2, 65, 4096), (2, 127, 4096),
                  (2, 129, 4096), (2, 300, 4100)]
# fp32: the oracle's associative scan multiplies in another order (see the
# module docstring); bf16: one bf16 ulp of the gradients' size
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _grads(fn, arrays, dy, dtype, device="cpu", with_h0=True):
    a, b, h0 = (torch.from_numpy(x).to(device) for x in arrays)
    a, b = a.to(dtype).requires_grad_(True), b.to(dtype).requires_grad_(True)
    h0 = h0.requires_grad_(True) if with_h0 else None
    out = fn(a, b, h0)
    out.backward(torch.from_numpy(dy).to(device=device, dtype=dtype))
    return out, a.grad, b.grad, (h0.grad if with_h0 else None)


def _dy(case, seed=3):
    return np.random.default_rng(seed + sum(case)).standard_normal(
        case, dtype=np.float32)


@pytest.mark.parametrize("with_h0", [True, False], ids=["h0", "no_h0"])
@pytest.mark.parametrize("case", BWD_CASES, ids=str)
def test_ref_backward_matches_jax_grad(case, with_h0, jax_rglru):
    """da, db (and dh0) of the plain version against jax.vjp of the JAX
    oracle; without h0 the oracle gets zeros."""
    import jax
    import jax.numpy as jnp
    arrays, dy = _numpy_inputs(case), _dy(case)
    _, da, db, dh0 = _grads(rglru_scan_ref, arrays, dy, torch.float32,
                            with_h0=with_h0)
    a, b, h0 = (jnp.asarray(x) for x in arrays)
    if not with_h0:
        h0 = jnp.zeros_like(h0)
    _, vjp = jax.vjp(jax_rglru[1], a, b, h0)
    wa, wb, wh0 = vjp(jnp.asarray(dy))
    for g, w in ((da, wa), (db, wb)) + (((dh0, wh0),) if with_h0 else ()):
        assert _max_err(g, w) < TOL * max(1.0, float(np.abs(w).max()))


def test_ref_backward_recurrence_by_hand():
    """g_t = dy_t + a_{t+1} g_{t+1}; db = g; da_t = g_t h_{t-1} (h_{-1} =
    h0); dh0 = a_0 g_0, in float64 against the plain backward."""
    case = RAGGED_CASE
    arrays, dy = _numpy_inputs(case), _dy(case)
    out, da, db, dh0 = _grads(rglru_scan_ref, arrays, dy, torch.float32)
    a, _, h0 = (x.astype(np.float64) for x in arrays)
    h = out.detach().double().numpy()
    g = np.zeros_like(h0)
    want_da, want_db = np.zeros_like(a), np.zeros_like(a)
    for t in range(case[1] - 1, -1, -1):
        g = dy[:, t] + (a[:, t + 1] * g if t + 1 < case[1] else 0.0)
        want_db[:, t] = g
        want_da[:, t] = g * (h[:, t - 1] if t else h0)
    np.testing.assert_allclose(db.numpy(), want_db, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(da.numpy(), want_da, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(dh0.numpy(), a[:, 0] * g, atol=1e-4,
                               rtol=1e-4)


def test_cpu_backward_launches_no_kernel():
    before = (ops.rglru_scan.launches, ops.rglru_scan.bwd_launches)
    _grads(ops.rglru_scan, _numpy_inputs(RAGGED_CASE), _dy(RAGGED_CASE),
           torch.float32)
    assert (ops.rglru_scan.launches, ops.rglru_scan.bwd_launches) == before


# ------------------------------------------ the backward's plan (CPU)
@pytest.mark.parametrize("dtype", PLAN_DTYPES, ids=str)
@pytest.mark.parametrize("case", PLAN_SHAPES, ids=str)
def test_bwd_plan_covers_every_column_and_row_once(case, dtype):
    B, S, W = case
    plan = kernel.bwd_plan(B, S, W, dtype, H100_SMS)
    assert plan.ctas == B * plan.tiles and plan.tiles * plan.tw >= W
    assert (plan.tiles - 1) * plan.tw < W
    assert (_covered(plan, B, W) == 1).all()
    # the walk from the last block to block 0 meets every row once: the
    # first block it runs holds row S - 1, and no block is empty
    assert (plan.blocks - 1) * plan.block_rows < S <= (
        plan.blocks * plan.block_rows)


@pytest.mark.parametrize("dtype", PLAN_DTYPES, ids=str)
@pytest.mark.parametrize("case", PLAN_SHAPES, ids=str)
def test_bwd_plan_within_the_instance_limits(case, dtype):
    B, S, W = case
    plan = kernel.bwd_plan(B, S, W, dtype, H100_SMS)
    esz = torch.empty((), dtype=dtype).element_size()
    assert plan.tw in kernel.TILE_WIDTHS and plan.tw * esz >= kernel.SECTOR
    assert 1 <= plan.nseg <= -(-S // kernel.BWD_ROWS)
    assert plan.threads == plan.tw * plan.nseg <= kernel.BWD_MAX_THREADS
    assert plan.block_rows == plan.nseg * kernel.BWD_ROWS
    assert plan == kernel.plan_for(B, S, W, plan.tw, plan.nseg,
                                   kernel.BWD_ROWS)


@pytest.mark.parametrize("dtype", PLAN_DTYPES, ids=str)
@pytest.mark.parametrize("case", [BWD_TRAIN_CASE, LONG_CASE, (1, 2100, 4096)],
                         ids=str)
def test_bwd_plan_fills_a_wave(case, dtype):
    """Every SM of an H100 gets a CTA, B = 1 included, and two CTAs an SM
    (the kernel's launch bounds) hold the whole grid at the train shape;
    where S is long enough a CTA keeps BWD_PLAN_BYTES of loads in flight
    (fp32: 128 threads) or takes BWD_MAX_THREADS (bf16: 192)."""
    plan = kernel.bwd_plan(*case, dtype, H100_SMS)
    assert plan.ctas >= H100_SMS
    esz = torch.empty((), dtype=dtype).element_size()
    threads = {torch.float32: 128, torch.bfloat16: 192}[dtype]
    assert threads == min(kernel.BWD_MAX_THREADS, kernel.BWD_PLAN_BYTES
                          // (3 * kernel.BWD_ROWS * esz))
    if case[1] >= threads // plan.tw * kernel.BWD_ROWS:
        assert plan.threads == threads
    if case == BWD_TRAIN_CASE:
        assert plan.ctas <= 2 * H100_SMS


def test_bwd_plan_at_the_train_shape():
    """The plans chip_smoke.py prints at the hybrid's train shape: fp32
    32 columns by 4 segments, 33 blocks of 64 rows; bf16 32 by 6, 22
    blocks of 96; B 1 at S 8192 fp32 on 16-column tiles by 8. The card's
    edge cases sit one row around one and two of the fp32 plan's
    blocks."""
    want = {torch.float32: (32, 4, 64, 33, 256),
            torch.bfloat16: (32, 6, 96, 22, 256)}
    for dtype in PLAN_DTYPES:
        plan = kernel.bwd_plan(*BWD_TRAIN_CASE, dtype, H100_SMS)
        assert (plan.tw, plan.nseg, plan.block_rows, plan.blocks,
                plan.ctas) == want[dtype]
    assert kernel.bwd_plan(*LONG_CASE, torch.float32,
                           H100_SMS)[:2] == (16, 8)
    for S in (63, 65, 127, 129):
        plan = kernel.bwd_plan(2, S, 4096, torch.float32, H100_SMS)
        assert plan.block_rows == 64 and min(S % 64, 64 - S % 64) == 1
    assert [(2, S, 4096) for S in (63, 65, 127, 129)] == BWD_EDGE_CASES[:4]


def _emulate_bwd_kernel(a, h, dy, h0, plan):
    """The backward kernel's order of operations in numpy float32, CTA by
    CTA. Each thread's row t holds a' = a_{t+1} (1 at t = S - 1, not
    loaded), dy_t and h_{t-1} (h0, or 0, at t = 0); rows past S are the
    identity (a' = 1, dy = 0). Per segment of BWD_ROWS rows a local
    reverse scan from zero gives (P = prod a', G = g at its first row);
    the (P, G) chain runs from the last segment of the last block to the
    first of block 0, from g_S = 0, giving each segment's carry-in; the
    re-walk from it gives db = g and da = g * h_{t-1}; dh0 = a_0 * g_0.
    Returns (da, db, dh0 or None); columns past W are not touched, every
    element is written by exactly one CTA, and no index of a, h or dy
    outside [0, S) is formed (numpy would raise at S)."""
    B, S, W = a.shape
    R, L = kernel.BWD_ROWS, plan.block_rows
    da = np.full(a.shape, np.nan, np.float32)
    db = np.full(a.shape, np.nan, np.float32)
    dh0 = None if h0 is None else np.full((B, W), np.nan, np.float32)
    rows = plan.blocks * L
    for cta in range(plan.ctas):
        bi, tile = divmod(cta, plan.tiles)
        cols = np.arange(tile * plan.tw, min(W, (tile + 1) * plan.tw))
        if cols.size == 0:
            continue
        n = cols.size
        ac = np.ones((rows, n), np.float32)
        ac[:S - 1] = a[bi, 1:S][:, cols]
        dc = np.zeros((rows, n), np.float32)
        dc[:S] = dy[bi, :S][:, cols]
        hc = np.zeros((rows, n), np.float32)
        hc[1:S] = h[bi, :S - 1][:, cols]
        if h0 is not None:
            hc[0] = h0[bi, cols]
        ac, dc, hc = (x.reshape(plan.blocks, plan.nseg, R, n)
                      for x in (ac, dc, hc))
        P = np.ones((plan.blocks, plan.nseg, n), np.float32)
        G = np.zeros_like(P)
        for r in range(R - 1, -1, -1):
            P = P * ac[:, :, r]
            G = _fma(ac[:, :, r], G, dc[:, :, r])
        carry = np.zeros(n, np.float32)
        c_in = np.empty_like(P)
        for k in range(plan.blocks - 1, -1, -1):
            for j in range(plan.nseg - 1, -1, -1):
                c_in[k, j] = carry
                carry = _fma(P[k, j], carry, G[k, j])
        g, gs = c_in, np.empty_like(ac)
        for r in range(R - 1, -1, -1):
            g = _fma(ac[:, :, r], g, dc[:, :, r])
            gs[:, :, r] = g
        db[bi][:, cols] = gs.reshape(rows, n)[:S]
        da[bi][:, cols] = (gs * hc).reshape(rows, n)[:S]
        if h0 is not None:
            dh0[bi, cols] = a[bi, 0, cols] * carry
    return da, db, dh0


def _bwd_emulation_cases():
    """(case, plan): S = 1; the train shape's S at narrow W under its own
    plan and under forced ones; the ragged case; S one around one and two
    blocks of several plans (W 40: the 32-column tile is ragged)."""
    cases = [((3, 1, 40), None), ((2, 2100, 40), None),
             ((2, 2100, 40), (32, 4)), (RAGGED_CASE, None)]
    for tw, nseg in ((32, 6), (16, 12), (8, 24), (32, 1), (32, 4)):
        L = nseg * kernel.BWD_ROWS
        cases += [((2, S, 40), (tw, nseg))
                  for S in (L - 1, L + 1, 2 * L - 1, 2 * L + 1)]
    return cases


@pytest.mark.parametrize("with_h0", [True, False], ids=["h0", "no_h0"])
@pytest.mark.parametrize("case,forced", _bwd_emulation_cases(), ids=str)
def test_bwd_kernel_order_matches_jax_vjp(case, forced, with_h0, jax_rglru):
    """The backward kernel's order against jax.vjp of the JAX oracle, h
    being the oracle's forward output (the kernel's saved h); each
    gradient within TOL of max(1, its largest value), as the card's
    check holds the kernel to the plain version."""
    import jax
    import jax.numpy as jnp
    B, S, W = case
    plan = (kernel.bwd_plan(B, S, W, torch.float32, H100_SMS)
            if forced is None else
            kernel.plan_for(B, S, W, *forced, kernel.BWD_ROWS))
    a, b, h0 = _numpy_inputs(case)
    dy = _dy(case)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    jh0 = jnp.asarray(h0) if with_h0 else jnp.zeros((B, W), jnp.float32)
    h, vjp = jax.vjp(jax_rglru[1], ja, jb, jh0)
    wa, wb, wh0 = vjp(jnp.asarray(dy))
    da, db, dh0 = _emulate_bwd_kernel(a, np.asarray(h), dy,
                                      h0 if with_h0 else None, plan)
    got = [(da, wa), (db, wb)] + ([(dh0, wh0)] if with_h0 else [])
    for g, w in got:
        assert not np.isnan(g).any()
        assert _max_err(torch.from_numpy(g), w) < TOL * max(
            1.0, float(np.abs(w).max()))
    if not with_h0:
        assert dh0 is None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("with_h0", [True, False], ids=["h0", "no_h0"])
@pytest.mark.parametrize("case", BWD_CASES + BWD_EDGE_CASES
                         + [BWD_TRAIN_CASE], ids=str)
def test_backward_kernel_matches_ref_on_card(case, with_h0, dtype, cuda):
    """The backward kernel through autograd against autograd of the plain
    version, each gradient within BWD_TOL of max(1, its largest value);
    one forward and one backward launch."""
    arrays, dy = _numpy_inputs(case), _dy(case)
    before = (ops.rglru_scan.launches, ops.rglru_scan.bwd_launches)
    got = _grads(ops.rglru_scan, arrays, dy, dtype, cuda, with_h0)
    torch.cuda.synchronize()
    assert (ops.rglru_scan.launches,
            ops.rglru_scan.bwd_launches) == (before[0] + 1, before[1] + 1)
    want = _grads(rglru_scan_ref, arrays, dy, dtype, cuda, with_h0)
    for g, w in zip(got[1:], want[1:]):
        if w is None:
            assert g is None
            continue
        assert g.dtype == w.dtype and g.shape == w.shape
        scale = max(1.0, float(w.float().abs().max()))
        assert float((g.float() - w.float()).abs().max()) < \
            BWD_TOL[dtype] * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_backward_kernel_is_deterministic_on_card(dtype, cuda):
    """No atomics, one writer an element: two calls at the train shape
    give the same bits."""
    arrays, dy = _numpy_inputs(BWD_TRAIN_CASE), _dy(BWD_TRAIN_CASE)
    first = _grads(ops.rglru_scan, arrays, dy, dtype, cuda)
    again = _grads(ops.rglru_scan, arrays, dy, dtype, cuda)
    for g, h in zip(first[1:], again[1:]):
        assert torch.equal(g, h)
