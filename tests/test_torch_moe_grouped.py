"""The served MoE block's grouped expert product (``models.moe``'s
``_grouped_experts``, ``kernels/moe_gemm``) and its routing counters
(``spans.count_moe``).

On the CPU, in fp32: the plain version (``ref.py``) against a loop over
single rows, with empty experts and every entry on one expert; the
grouped path against the padded one (the path autograd records through)
entry by entry, at capacities that drop and that do not: the same entries
are zero (dropped), the rest within 2e-5 (the two differ only in the order
of fp32 sums); the dropless block (capacity_factor = E / k) against the
JAX package's block; the counters; the build check's reading of ptxas.
On the card (``-m cuda``, no JAX): the CUDA kernels against ``ref.py`` at
Qwen3-30B-A3B's widths, a captured full-width MoE layer against its eager
run, bit for bit, the kernels' launch counts through a capture and its
replays, and a full-width block against float32 experts at its own
routing, well inside the float8 control's error.
"""
import json
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import spans  # noqa: E402
from repro_torch.config import ModelConfig, get_config  # noqa: E402
from repro_torch.kernels.moe_gemm import ops as gemm_ops  # noqa: E402
from repro_torch.kernels.moe_gemm.ref import moe_grouped_ffn_ref  # noqa: E402
from repro_torch.models import api, layers, moe  # noqa: E402
from repro_torch.models.segmentation import SegmentedService  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LLAMA4 = "llama4-scout-17b-a16e"
#: the grouped and padded paths differ only in the order of fp32 sums
PATH_TOL = dict(atol=2e-5, rtol=2e-5)


def _qwen3_moe() -> ModelConfig:
    """Qwen3-30B-A3B's port fields, as the benchmark's configuration runs
    them."""
    path = ROOT / "servebench" / "configs" / "qwen3-4b.qwen3-30b-a3b.json"
    return ModelConfig(**json.loads(path.read_text())["low"]["port"])


def _weights(E, D, Fe, seed, device="cpu", dtype=torch.float32):
    g = torch.Generator(device="cpu").manual_seed(seed)

    def w(*shape, fan):
        return (torch.randn(*shape, generator=g) / fan ** 0.5).to(device,
                                                                  dtype)
    return w(E, D, Fe, fan=D), w(E, D, Fe, fan=D), w(E, Fe, D, fan=Fe)


def _packed(idx, E):
    """(src, offsets) of a dropless routing idx [T, k]: every entry in
    expert order (token order within an expert)."""
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    sizes = torch.bincount(flat, minlength=E)
    offsets = torch.cat([sizes.new_zeros(1), sizes.cumsum(0)])
    return order // idx.shape[1], offsets.to(torch.int32)


def _loop(x, src, offsets, w1, w3, w2):
    """One row at a time, from the equation."""
    out = torch.zeros(src.shape[0], x.shape[1], dtype=x.dtype)
    for e in range(w1.shape[0]):
        for r in range(int(offsets[e]), int(offsets[e + 1])):
            v = x[src[r]]
            out[r] = (torch.nn.functional.silu(v @ w1[e]) * (v @ w3[e])
                      ) @ w2[e]
    return out


@pytest.mark.parametrize("sizes", [
    [3, 0, 5, 0, 1, 7],            # empty experts between full ones
    [0, 0, 16, 0, 0, 0],           # every entry on one expert
    [0, 0, 0, 0, 0, 0],            # nothing routed
    [2, 2, 2, 2, 2, 2],
])
def test_ref_matches_a_loop_over_rows(sizes):
    E, D, Fe, T = 6, 16, 24, 9
    w1, w3, w2 = _weights(E, D, Fe, seed=sum(sizes) + len(sizes))
    g = torch.Generator().manual_seed(1)
    x = torch.randn(T, D, generator=g)
    N = sum(sizes) + 3                  # rows past the groups stay zero
    src = torch.randint(0, T, (N,), generator=g)
    offsets = torch.tensor([0] + list(np.cumsum(sizes)), dtype=torch.int32)
    got = moe_grouped_ffn_ref(x, src, offsets, w1, w3, w2)
    torch.testing.assert_close(got, _loop(x, src, offsets, w1, w3, w2),
                               atol=1e-6, rtol=1e-5)
    assert not got[sum(sizes):].any()


def _block_inputs(E, k, factor, router, seed=5, T=40):
    cfg = get_config(LLAMA4).reduced().replace(
        num_experts=E, top_k=k, capacity_factor=factor, num_shared_experts=0)
    p = moe.MoEFFN(layers.Maker(seed, torch.float32, "cpu"), cfg)
    g = torch.Generator().manual_seed(seed)
    x2 = torch.randn(T, cfg.d_model, generator=g)
    if router == "skewed":
        # feature 0 is 1 on every token and points at expert 0
        x2[:, 0] = 1.0
        with torch.no_grad():
            p.router[0] = 0.0
            p.router[0, 0] = 12.0
    return cfg, p, x2


def _entries(cfg, p, x2, path):
    """Each entry's expert output [T * k, D] through ``path`` ("padded" or
    "grouped"), with the dispatch both paths share."""
    T, k, E = x2.shape[0], cfg.top_k, cfg.num_experts
    _, _, idx = moe._route(x2, p, cfg)
    C = moe._capacity(T, cfg)
    order, dest, keep = moe._dispatch(idx, C, E)
    if path == "padded":
        return moe._padded_experts(x2, order, dest, keep, C, E, k, p.w1,
                                   p.w3, p.w2), keep, order
    return moe._grouped_experts(x2, p, idx, order, keep, C, E, k, p.w1,
                                p.w3, p.w2), keep, order


@pytest.mark.parametrize("router", ["random", "skewed"])
@pytest.mark.parametrize("E, k, factor", [
    (8, 2, 1.0),          # capacity below the load: entries drop
    (8, 2, 4.0),          # dropless: capacity_factor = E / k
    (16, 4, 1.25),
    (4, 1, 4.0),
])
def test_grouped_path_equals_the_padded_path(E, k, factor, router):
    cfg, p, x2 = _block_inputs(E, k, factor, router)
    with torch.no_grad():
        padded, keep, order = _entries(cfg, p, x2, "padded")
        grouped, _, _ = _entries(cfg, p, x2, "grouped")
    dropped = torch.empty_like(keep)
    dropped[order] = ~keep                  # token-major
    assert not grouped[dropped].any() and not padded[dropped].any()
    assert (grouped[~dropped].abs().sum(1) > 0).all()
    torch.testing.assert_close(grouped, padded, **PATH_TOL)
    if factor * k < E and router == "skewed":
        assert dropped.any()
    # the whole block: autograd recording takes the padded path
    y_grouped, aux_g = moe._moe_ffn_block(x2, p, cfg)
    y_padded, aux_p = moe._moe_ffn_block(x2.clone().requires_grad_(), p,
                                         cfg)
    assert y_padded.requires_grad and not y_grouped.requires_grad
    torch.testing.assert_close(y_grouped, y_padded.detach(), **PATH_TOL)
    assert torch.equal(aux_g, aux_p.detach())


def test_the_served_block_counts_routed_and_dropped_entries():
    """The counters add each forward's entries routed to each expert and
    those dropped past capacity: zero at dropless capacity."""
    for factor, want_drops in ((4.0, False), (1.0, True)):
        cfg, p, x2 = _block_inputs(8, 2, factor, "skewed")
        with torch.no_grad():
            for _ in range(2):
                moe._moe_ffn_block(x2, p, cfg)
            _, _, idx = moe._route(x2, p, cfg)
            _, _, keep = moe._dispatch(idx, moe._capacity(40, cfg), 8)
        acc = p._moe_counts.tolist()
        assert [c for c in spans.moe_counts()
                if c.routed + [c.dropped] == acc and c.model == cfg.name]
        routed, dropped = acc[:-1], acc[-1]
        assert routed == (2 * torch.bincount(idx.reshape(-1),
                                             minlength=8)).tolist()
        assert dropped == 2 * int((~keep).sum())
        assert (dropped > 0) == want_drops


@pytest.fixture(scope="module")
def J():
    """The JAX package's modules (JAX on the CPU)."""
    jax = pytest.importorskip("jax")
    from repro import config
    from repro.models import moe as jmoe
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, config=config,
                                 moe=jmoe)


@pytest.mark.parametrize("E, k", [(8, 2), (16, 4)])
def test_dropless_block_matches_jax(J, E, k):
    """capacity_factor = E / k keeps every entry (C = T); the port's
    grouped path against the JAX package's padded block."""
    cfg, p, x2 = _block_inputs(E, k, E / k, "skewed", T=48)
    jcfg = J.config.get_config(LLAMA4).reduced().replace(
        num_experts=E, top_k=k, capacity_factor=E / k, num_shared_experts=0)
    assert moe._capacity(48, cfg) == J.moe._capacity(48, jcfg) == 48
    jp = {n: J.jnp.asarray(t.detach().numpy())
          for n, t in p.state_dict().items()}
    y, aux = moe._moe_ffn_block(x2, p, cfg)
    want, jaux = J.moe._moe_ffn_block(J.jnp.asarray(x2.numpy()), jp, jcfg,
                                      0, E, jp["w1"], jp["w3"], jp["w2"])
    np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    assert abs(float(aux) - float(jaux)) <= 1e-6 * max(1.0, float(jaux))


def test_the_build_check_reads_registers_and_spills_per_instance():
    """ptxas's ``-v`` report of the library: each of the four instances
    (bf16 ``tc``, fp32 ``simt``; gate and up, down) with its registers
    and spill bytes; other functions are not read."""
    from repro_torch.kernels.moe_gemm.kernel import parse_ptxas
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_12tc19moe_grouped_gate_upE14CUtensorMap_stS1_"
        "NS_6ParamsE' for 'sm_90a'",
        "ptxas info    : Used 168 registers, used 1 barriers",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_12tc16moe_grouped_downE14CUtensorMap_stNS_6Params"
        "E' for 'sm_90a'",
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 255 registers",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_14simt19moe_grouped_gate_upEPKfS2_NS_6ParamsE'",
        "ptxas info    : Used 96 registers",
        "ptxas info    : Compiling entry function '_Z5otherv'",
        "ptxas info    : Used 8 registers"])
    assert parse_ptxas(log) == {
        "moe_grouped_gate_up tc": {"registers": 168, "spill_bytes": 0},
        "moe_grouped_down tc": {"registers": 255, "spill_bytes": 8},
        "moe_grouped_gate_up simt": {"registers": 96, "spill_bytes": 0}}


def test_meta_gives_the_grouped_product_s_shape():
    x = torch.empty(6, 16, device="meta")
    w1, w3, w2 = (torch.empty(s, device="meta")
                  for s in ((4, 16, 8), (4, 16, 8), (4, 8, 16)))
    src = torch.empty(12, dtype=torch.int64, device="meta")
    out = gemm_ops.moe_grouped_ffn(x, src, torch.empty(
        5, dtype=torch.int32, device="meta"), w1, w3, w2)
    assert out.shape == (12, 16) and out.device.type == "meta"


# ------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    return torch.device("cuda")


def _routing(T, E, k, skew, device, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    logits = torch.randn(T, E, generator=g)
    if skew:
        # Zipf-like: expert e's logit raised by 3 / (1 + e / 4)
        logits += 3.0 / (1.0 + torch.arange(E) / 4.0)
    idx = torch.sort(logits, dim=-1, descending=True, stable=True)[1][:, :k]
    src, offsets = _packed(idx, E)
    return src.to(device), offsets.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("T, skew, dtype", [
    (512, False, torch.bfloat16), (512, True, torch.bfloat16),
    (4096, False, torch.bfloat16), (4096, True, torch.bfloat16),
    (512, False, torch.float32), (512, True, torch.float32),
])
def test_kernel_matches_ref_at_qwen3_moe_widths(T, skew, dtype, cuda):
    """D 2048, F 768, E 128, k 8, even or skewed routing: bf16 within 1e-2
    of the output's size (the two round H to bf16 alike; sums in fp32 in
    another order), fp32 (exact products, held at T 512) within 1e-4."""
    from repro_torch.kernels.moe_gemm import kernel
    E, k, D, Fe = 128, 8, 2048, 768
    w1, w3, w2 = _weights(E, D, Fe, seed=T + skew, device=cuda,
                          dtype=dtype)
    x = torch.randn(T, D, generator=torch.Generator().manual_seed(T)).to(
        cuda, dtype)
    src, offsets = _routing(T, E, k, skew, cuda, seed=T)
    n = gemm_ops.moe_grouped_ffn.launches
    got = gemm_ops.moe_grouped_ffn(x, src, offsets, w1, w3, w2)
    torch.cuda.synchronize()
    assert gemm_ops.moe_grouped_ffn.launches == n + 2
    want = moe_grouped_ffn_ref(x, src, offsets, w1, w3, w2)
    err = float((got.float() - want.float()).abs().max())
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    assert err <= tol * max(1.0, float(want.float().abs().max())), err
    built = kernel.instances()
    assert len(built) == 4 and all(
        not c["spill_bytes"] for c in built.values()), built


@pytest.mark.cuda
def test_a_captured_moe_layer_replays_its_eager_run(cuda):
    """Qwen3-30B-A3B at full width, two layers, at the cell's B2 S2048:
    a layer runs with no host sync (``sync_debug_mode`` "error"), and each
    segment's capturing call and replay equal its eager run bit for bit;
    the kernels' launches through capture and replays count as eagerly."""
    cfg = _qwen3_moe().replace(num_layers=2)
    model = api.build_params(cfg, seed=4, device=cuda)
    svc = SegmentedService(cfg, model, batch=2, seq=2048)
    x = svc.make_input()
    state = svc.segments[0].fn.eager(x)
    window, chunk = moe.layer_kinds(cfg)[0]
    pos = torch.arange(2048, dtype=torch.int32, device=cuda)
    with torch.inference_mode():          # builds the kernels first
        moe.layer_apply(model.layers[0], state, pos, cfg, window=window,
                        chunk=chunk)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            moe.layer_apply(model.layers[0], state, pos, cfg, window=window,
                            chunk=chunk)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ops = gemm_ops.moe_grouped_ffn
    for round_ in range(2):               # capture, then replays
        n = ops.launches
        state = x
        for seg in svc.segments:
            want, got = seg.fn.eager(state), seg.fn(state)
            assert torch.equal(want, got), seg.name
            state = got
        assert ops.launches == n + 2 * 2 * cfg.num_layers, round_
    assert all(len(seg.fn.graphed.captured) == 1 for seg in svc.segments)


def _fp8(t):
    """``t`` rounded to float8 e4m3 under one scale (its largest magnitude
    at 448), as the benchmark's control rounds a product's operands."""
    scale = t.abs().amax().clamp_min(1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def _experts_at(x2, gates, idx, w1, w3, w2, rnd=lambda t: t, skip=None):
    """sum over each token's experts idx [T, k] of gate * expert(x) in
    float32, every product's operands through ``rnd``; expert ``skip``
    left out."""
    x = x2.float()
    out = torch.zeros_like(x)
    for e in range(w1.shape[0]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if e == skip or tok.numel() == 0:
            continue
        rows = rnd(x[tok])
        h = (torch.nn.functional.silu(rows @ rnd(w1[e].float()))
             * (rows @ rnd(w3[e].float())))
        out.index_add_(0, tok, (rnd(h) @ rnd(w2[e].float()))
                       * gates[tok, slot][:, None])
    return out


@pytest.mark.cuda
def test_the_served_block_at_full_width_against_fp32_at_its_routing(cuda):
    """One Qwen3-30B-A3B MoE block at full width over the M.moe_fill
    cell's 4096 tokens a layer, in bf16, against float32 experts at the
    block's own routing and gates (so no routing flip enters): within 1e-2
    of the output's norm, and at least 3 times below the error of the same
    experts with every product's operands in float8 (the benchmark's
    control). Leaving out one expert, or the gates unrenormalised, errs by
    more than the limit."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _qwen3_moe().replace(num_layers=1)
    p = moe.MoEFFN(layers.Maker(7, torch.bfloat16, "cuda"), cfg)
    g = torch.Generator().manual_seed(7)
    x2 = torch.randn(4096, cfg.d_model, generator=g).to(cuda, torch.bfloat16)
    with torch.inference_mode():
        y, _ = moe._moe_ffn_block(x2, p, cfg)
        probs, gates, idx = moe._route(x2, p, cfg)
        want = _experts_at(x2, gates, idx, p.w1, p.w3, p.w2)

        def err(got):
            return float((got.float() - want).norm() / want.norm())
        served = err(y)
        control = err(_experts_at(x2, gates, idx, p.w1, p.w3, p.w2,
                                  rnd=_fp8))
        dropped = err(_experts_at(x2, gates, idx, p.w1, p.w3, p.w2,
                                  skip=int(idx[0, 0])))
        unnormed = err(_experts_at(x2, probs.gather(1, idx), idx, p.w1,
                                   p.w3, p.w2))
    assert served <= 1e-2, served
    assert control >= 3 * served, (served, control)
    assert min(dropped, unnormed) > 1e-2, (dropped, unnormed)
