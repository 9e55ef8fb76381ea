"""The port's MoE family (llama4-scout-17b-a16e, deepseek-v2-236b) and MLA
attention against the JAX package's, on the CPU at ``.reduced()`` size.

The JAX side runs un-meshed, so ``moe_apply`` takes its single-device
branch. Inputs come from numpy seeds, weights from the JAX package's
``build_params`` through ``repro_torch.bridge``. Everything is fp32.
Logits and outputs are held to atol 5e-4 (rtol 1e-4), as the other
families' are (``tests/test_torch_models.py``); gradients to 5e-4 of
each tensor's norm (``tests/test_torch_train.py``). The routing is held
exactly: which (token, expert) entries are kept and which are dropped
past an expert's capacity, with a router skewed onto one expert and one
with two equal columns (a tie that ``jax.lax.top_k`` breaks towards the
lower expert).

Reduced llama4 has 2 layers in one chunk-pattern group (chunked at 64,
then full), 4 experts, top-1 and a shared expert; reduced deepseek has
MLA at r 64 with no q projection (``q_lora_rank`` 0), 4 experts, top-2;
the full-width q projection (rank 1536) is held here at rank 64.

The tests marked ``cuda`` run on the card (bf16, the kernels against
their plain versions and against themselves) and import no jax.
"""
import collections
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import bridge  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.launch.serve import main, serve_pair  # noqa: E402
from repro_torch.models import api, attention, layers, moe  # noqa: E402
from repro_torch.models.segmentation import SegmentedService  # noqa: E402

LLAMA4, DEEPSEEK = "llama4-scout-17b-a16e", "deepseek-v2-236b"
LOGIT_TOL = dict(atol=5e-4, rtol=1e-4)
GRAD_RTOL = 5e-4
# name: (arch, config fields set on both sides, prompt length): llama4's
# prompt crosses its reduced 64-token chunk, so prefill keeps a wrapped
# ring in both layers (the full layer's too) and decode wraps further
MODELS = {
    "llama4": (LLAMA4, {}, 72),
    "deepseek": (DEEPSEEK, {}, 64),
    "deepseek-qlora": (DEEPSEEK, dict(q_lora_rank=64), 64),
}
DECODE_STEPS = 8


@pytest.fixture(scope="module")
def J():
    """The JAX package's modules (JAX on the CPU)."""
    jax = pytest.importorskip("jax")
    from repro import config
    from repro.models import api as japi
    from repro.models import attention as jattn
    from repro.models import moe as jmoe
    from repro.models import segmentation as jseg
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, config=config,
                                 api=japi, attn=jattn, moe=jmoe, seg=jseg)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(out, want, **tol):
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(want, dtype=np.float32),
                               **(tol or LOGIT_TOL))


def _bridged(J, name, seed=0, **kw):
    arch, fields, prompt = MODELS[name]
    jcfg = J.config.get_config(arch).reduced().replace(**fields, **kw)
    jparams = J.api.build_params(jcfg, J.jax.random.key(seed))
    cfg = get_config(arch).reduced().replace(**fields, **kw)
    model = api.build_params(cfg, seed=seed, device="cpu")
    state = bridge.params_from_numpy(J.jax.tree.map(np.asarray, jparams))
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    return jcfg, jparams, cfg, model


# --------------------------------------------------------------- capacity
@pytest.mark.parametrize("T", [1, 7, 96, 4096])
def test_capacity_matches_jax(J, T):
    for E in (4, 16, 160):
        for k in (1, 2, 6):
            for factor in (1.0, 1.25, 2.0):
                fields = dict(num_experts=E, top_k=k, capacity_factor=factor)
                got = moe._capacity(T, get_config(LLAMA4).replace(**fields))
                want = J.moe._capacity(
                    T, J.config.get_config(LLAMA4).replace(**fields))
                assert got == want, (T, E, k, factor)


# ---------------------------------------------------------- the MoE block
def _ffn_inputs(arch, router, seed):
    """Tokens x2 [48, D], the block's weights (numpy), and the port's
    config: reduced llama4 (top-1) or deepseek (top-2), 4 experts."""
    cfg = get_config(arch).reduced()
    r = _rng(seed)
    D, E, Fe = cfg.d_model, cfg.num_experts, cfg.resolved_moe_d_ff
    x2 = r.standard_normal((48, D), dtype=np.float32)
    w = {"router": r.standard_normal((D, E), dtype=np.float32) * 0.1}
    for n, shape in (("w1", (E, D, Fe)), ("w3", (E, D, Fe)),
                     ("w2", (E, Fe, D)), ("sh_gate", (D, Fe)),
                     ("sh_up", (D, Fe)), ("sh_down", (Fe, D))):
        w[n] = r.standard_normal(shape, dtype=np.float32) / shape[-2] ** 0.5
    if router == "skewed":
        # feature 0 is 1 on every token and points at expert 0: every
        # token ranks it first, far past its capacity
        x2[:, 0] = 1.0
        w["router"][0] = [12.0] + [0.0] * (E - 1)
    elif router == "tied":
        # experts 1 and 2 get the same logits, ranked first or second
        x2[:, 0] = 1.0
        w["router"][:, 2] = w["router"][:, 1]
        w["router"][0, 1:3] = 12.0
    return cfg, x2, w


def _jax_kept(J, x2, router, jcfg):
    """The (token, expert) entries the JAX package's dispatch keeps, from
    the ops of ``repro.models.moe._moe_ffn_block`` (top_k, the stable
    argsort, searchsorted, the capacity test)."""
    jnp = J.jnp
    probs = J.jax.nn.softmax(jnp.einsum("td,de->te", x2, router), axis=-1)
    _, idx = J.jax.lax.top_k(probs, jcfg.top_k)
    flat_e = idx.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    pos = (jnp.arange(flat_e.shape[0])
           - jnp.searchsorted(sorted_e, sorted_e, side="left"))
    keep = pos < J.moe._capacity(x2.shape[0], jcfg)
    tok = np.asarray(order) // jcfg.top_k
    return {(int(t), int(e)) for t, e, k in
            zip(tok, np.asarray(sorted_e), np.asarray(keep)) if k}


def _port_kept(x2, p, cfg):
    _, _, idx = moe._route(x2, p, cfg)
    order, _, keep = moe._dispatch(idx, moe._capacity(x2.shape[0], cfg),
                                   cfg.num_experts)
    experts = idx.reshape(-1)[order]
    tokens = order // cfg.top_k
    return {(int(t), int(e)) for t, e, k in zip(tokens, experts, keep) if k}


@pytest.mark.parametrize("router", ["random", "skewed", "tied"])
@pytest.mark.parametrize("arch", [LLAMA4, DEEPSEEK])
def test_moe_block_matches_jax(J, arch, router):
    """The routed experts' output, the aux loss and the kept set; the
    skewed router overflows expert 0 (its drops follow the stable sort:
    the first C tokens are kept), the tied one breaks each tie towards
    the lower expert."""
    cfg, x2, w = _ffn_inputs(arch, router, seed=11)
    jcfg = J.config.get_config(arch).reduced()
    p = moe.MoEFFN(layers.Maker(0, torch.float32, "cpu"), cfg)
    p.load_state_dict({n: torch.from_numpy(a) for n, a in w.items()})
    jp = {n: J.jnp.asarray(a) for n, a in w.items()}
    xt = torch.from_numpy(x2)
    y, aux = moe._moe_ffn_block(xt, p, cfg)
    want, jaux = J.moe._moe_ffn_block(J.jnp.asarray(x2), jp, jcfg, 0,
                                      jcfg.num_experts, jp["w1"], jp["w3"],
                                      jp["w2"])
    _close(y, want, atol=1e-5, rtol=1e-5)
    assert abs(float(aux) - float(jaux)) <= 1e-6 * max(1.0, float(jaux))
    kept = _port_kept(xt, p, cfg)
    assert kept == _jax_kept(J, J.jnp.asarray(x2), jp["router"], jcfg)
    C = moe._capacity(x2.shape[0], cfg)
    if router == "skewed":
        to_0 = sorted(t for t, e in kept if e == 0)
        assert to_0 == list(range(C)) and C < x2.shape[0]
    if router == "tied":
        _, _, idx = moe._route(xt, p, cfg)
        assert (idx[:, 0] == 1).all() and int((idx == 2).sum()) == (
            x2.shape[0] if cfg.top_k > 1 else 0)
    # the shared expert too, through moe_apply
    y3, _ = moe.moe_apply(p, xt.reshape(2, 24, -1), cfg)
    want3, _ = J.moe.moe_apply(jp, J.jnp.asarray(x2).reshape(2, 24, -1),
                               jcfg)
    _close(y3, want3, atol=1e-5, rtol=1e-5)


def test_route_breaks_ties_towards_the_lower_expert():
    """The gates come from a stable descending sort: equal probabilities
    keep the lower expert first, whatever order ``torch.topk`` gives."""
    cfg = get_config(DEEPSEEK).reduced()
    p = moe.MoEFFN(layers.Maker(0, torch.float32, "cpu"), cfg)
    with torch.no_grad():
        p.router.zero_()                    # every expert tied
    _, gates, idx = moe._route(torch.randn(5, cfg.d_model), p, cfg)
    assert idx.tolist() == [[0, 1]] * 5
    torch.testing.assert_close(gates, torch.full((5, 2), 0.5))


def test_moe_block_is_bitwise_repeatable():
    cfg, x2, w = _ffn_inputs(DEEPSEEK, "skewed", seed=3)
    p = moe.MoEFFN(layers.Maker(0, torch.float32, "cpu"), cfg)
    p.load_state_dict({n: torch.from_numpy(a) for n, a in w.items()})
    a = moe._moe_ffn_block(torch.from_numpy(x2), p, cfg)
    b = moe._moe_ffn_block(torch.from_numpy(x2), p, cfg)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# -------------------------------------------------------------------- MLA
def _mla_inputs(Sq, Sk, seed, B=2, H=4, dh=64, Dr=32, r=64, dv=64):
    g = _rng(seed)

    def n(*shape, scale=1.0):
        return (g.standard_normal(shape) * scale).astype(np.float32)
    return (n(B, Sq, H, dh), n(B, Sq, H, Dr), n(B, Sk, r), n(B, Sk, Dr),
            n(H, dh, r, scale=dh ** -0.5), n(H, r, dv, scale=r ** -0.5))


@pytest.mark.parametrize("S", [48, 512, 1024], ids=lambda s: f"S{s}")
def test_mla_attend_full_matches_jax(J, S):
    """The absorbed form over one q block (48, 512) and two (1024)."""
    ins = _mla_inputs(S, S, seed=S)
    pos = np.arange(S, dtype=np.int32)
    got = attention.mla_attend_full(*map(torch.from_numpy, ins),
                                    torch.from_numpy(pos),
                                    torch.from_numpy(pos))
    want = J.attn.mla_attend_full(*map(J.jnp.asarray, ins),
                                  J.jnp.asarray(pos), J.jnp.asarray(pos))
    assert tuple(got.shape) == want.shape
    _close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("S", [512, 1024], ids=lambda s: f"S{s}")
def test_mla_checkpoints_each_q_block_with_jax_gradients(J, S):
    """Where autograd records, each 512-row q block is checkpointed once,
    as the JAX package's ``jax.checkpoint`` of its scan body (one block's
    fp32 logits live at a time); a single block, or no recording, takes
    none. The gradients match ``jax.grad`` of the same function."""
    ins = _mla_inputs(S, S, seed=S + 1, B=1)
    pos = torch.arange(S, dtype=torch.int32)
    g_out = _rng(S + 2).standard_normal((1, S, 4, 64)).astype(np.float32)
    calls = collections.Counter()
    real = layers.checkpoint

    def counted(fn, *a, **k):
        calls[fn.__name__] += 1
        return real(fn, *a, **k)
    xs = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers, "checkpoint", counted)
        with torch.no_grad():
            attention.mla_attend_full(*xs, pos, pos)
        assert not calls
        out = attention.mla_attend_full(*xs, pos, pos)
    assert calls == ({"_mla_block": S // 512} if S > 512 else {})
    got = torch.autograd.grad(out, xs, torch.from_numpy(g_out))

    def f(*a):
        o = J.attn.mla_attend_full(*a, J.jnp.asarray(pos.numpy()),
                                   J.jnp.asarray(pos.numpy()))
        return (o * g_out).sum()
    want = J.jax.grad(f, argnums=tuple(range(6)))(*map(J.jnp.asarray, ins))
    for a, b in zip(got, want):
        b = np.asarray(b)
        err = float(np.abs(a.numpy() - b).max())
        assert err <= GRAD_RTOL * float(np.linalg.norm(b)), err


def test_mla_decode_attend_matches_jax_over_a_partly_filled_cache(J):
    """A 40-slot cache with 25 positions written (the rest -1), then one
    token written at 25 and attended."""
    qn, qr, c, kr, w_uk, w_uv = _mla_inputs(1, 40, seed=4)
    cache = attention.init_mla_cache(2, 40, 64, 32, torch.float32, "cpu")
    jcache = J.attn.init_mla_cache(2, 40, 64, 32, J.jnp.float32)
    for p in range(26):
        cache = attention.mla_cache_write(
            cache, torch.from_numpy(c[:, p:p + 1]),
            torch.from_numpy(kr[:, p:p + 1]), p)
        jcache = J.attn.mla_cache_write(jcache, J.jnp.asarray(c[:, p:p + 1]),
                                        J.jnp.asarray(kr[:, p:p + 1]), p)
    assert int((cache.pos >= 0).sum()) == 26
    got = attention.mla_decode_attend(
        torch.from_numpy(qn), torch.from_numpy(qr), cache,
        torch.from_numpy(w_uk), torch.from_numpy(w_uv), 25)
    want = J.attn.mla_decode_attend(J.jnp.asarray(qn), J.jnp.asarray(qr),
                                    jcache, J.jnp.asarray(w_uk),
                                    J.jnp.asarray(w_uv), 25)
    _close(got, want, atol=1e-5, rtol=1e-5)
    for t, a in zip(cache, jcache):
        _close(t, a, atol=0, rtol=0)


# ------------------------------------------------------------ whole model
@pytest.mark.parametrize("name", sorted(MODELS))
def test_logits_and_aux_match_jax_forward(J, name):
    jcfg, jparams, cfg, model = _bridged(J, name)
    prompt = MODELS[name][2]
    tokens = _rng(5).integers(0, cfg.vocab_size, (2, prompt), dtype=np.int32)
    want, jaux = J.api.forward(jparams, J.jnp.asarray(tokens), jcfg)
    logits, aux = api.forward(model, torch.from_numpy(tokens), cfg)
    assert tuple(logits.shape) == want.shape
    _close(logits, want)
    assert aux.dtype == torch.float32 and float(aux) > 0
    assert abs(float(aux) - float(jaux)) <= 1e-5 * float(jaux)


def _flat_caches(caches, jcaches):
    """(port tensors, JAX arrays) field by field: the JAX caches are
    stacked over layers, the port's a list."""
    return [torch.stack(f) for f in zip(*caches)], list(jcaches)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_prefill_then_decode_matches_jax(J, name):
    """Prefill, then 8 decode steps: llama4's prompt of 72 over its
    reduced 64-token chunk leaves every layer a wrapped 64-slot ring (the
    full layer's too: the JAX package sizes every ring by the chunk), and
    decode wraps it further; MLA's (c, kr) caches hold every position."""
    jcfg, jparams, cfg, model = _bridged(J, name)
    prompt = MODELS[name][2]
    r = _rng(7)
    tokens = r.integers(0, cfg.vocab_size, (2, prompt), dtype=np.int32)
    steps = r.integers(0, cfg.vocab_size, (DECODE_STEPS, 2, 1),
                       dtype=np.int32)
    want, jcaches = J.api.prefill(jparams, J.jnp.asarray(tokens), jcfg,
                                  extra_capacity=DECODE_STEPS)
    logits, caches = api.prefill(model, torch.from_numpy(tokens), cfg,
                                 extra_capacity=DECODE_STEPS)
    assert tuple(logits.shape) == want.shape == (2, 1, cfg.vocab_size)
    _close(logits, want)
    if cfg.attention_chunk:
        assert all(c.capacity == cfg.attention_chunk < prompt
                   for c in caches)
    for i in range(DECODE_STEPS):
        want, jcaches = J.api.decode_step(jparams, J.jnp.asarray(steps[i]),
                                          prompt + i, jcaches, jcfg)
        logits, caches = api.decode_step(model, torch.from_numpy(steps[i]),
                                         prompt + i, caches, cfg)
        _close(logits, want)
    got, ref = _flat_caches(caches, jcaches)
    assert [tuple(t.shape) for t in got] == [a.shape for a in ref]
    for t, a in zip(got, ref):
        _close(t, a)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_init_decode_caches_match_jax(J, name):
    """Empty caches: shapes, dtypes and empty-slot marks, the MLA (c, kr,
    pos) cache and llama4's chunk-sized rings."""
    jcfg, _, cfg, _ = _bridged(J, name)
    got, ref = _flat_caches(api.init_decode_caches(cfg, 2, 100, "cpu"),
                            J.api.init_decode_caches(jcfg, 2, 100))
    assert [tuple(t.shape) for t in got] == [a.shape for a in ref]
    for t, a in zip(got, ref):
        assert str(t.dtype).split(".")[1] == str(a.dtype)
        _close(t, a, atol=0, rtol=0)


def test_no_attention_row_is_all_masked_at_the_chunk_border():
    """Causal plus chunk leaves every query its own position, in the
    prompt across the chunk border and in decode over a wrapped ring of
    the chunk's capacity (chunked and full layers): the kernels' mean(v)
    for an all-masked row, where the JAX model path gives zeros, is
    never reached."""
    cfg = get_config(LLAMA4).reduced()
    chunk = cfg.attention_chunk
    S = 2 * chunk + 8
    q = torch.arange(S)[:, None]
    k = torch.arange(S)[None, :]
    for window, ch in moe.layer_kinds(cfg):
        assert window is None
        m = k <= q
        if ch is not None:
            m &= (q // ch) == (k // ch)
        assert bool(m.any(dim=1).all())
        for pos in range(chunk, S):          # ring: the last `chunk` slots
            kpos = torch.arange(pos - chunk + 1, pos + 1)
            m = kpos <= pos
            if ch is not None:
                m &= (kpos // ch) == pos // ch
            assert bool(m.any())


def test_attend_at_the_chunk_border_with_five_heads_a_group_matches_jax(J):
    """llama4's head group (40 query heads over 8 kv heads: G 5) at a
    reduced head count, 10 over 2, across the 64-token chunk: the port's
    attention (the kernel's plain version on the CPU) against the JAX
    package's ``attend``."""
    r = _rng(9)
    q = r.standard_normal((2, 72, 10, 64), dtype=np.float32)
    kv = [r.standard_normal((2, 72, 2, 64), dtype=np.float32)
          for _ in range(2)]
    pos = np.arange(72, dtype=np.int32)
    for chunk in (64, None):
        got = attention.attend(torch.from_numpy(q),
                               *map(torch.from_numpy, kv),
                               torch.from_numpy(pos), torch.from_numpy(pos),
                               chunk=chunk)
        want = J.attn.attend(J.jnp.asarray(q), *map(J.jnp.asarray, kv),
                             J.jnp.asarray(pos), J.jnp.asarray(pos),
                             chunk=chunk)
        _close(got, want, atol=1e-5, rtol=1e-5)


def test_bridge_maps_the_stacked_moe_and_mla_leaves(J):
    """``layers.moe.*`` and ``layers.attn.*`` ([L, ...]) land on each
    layer's module: layer 1's w2 and w_uk are the JAX stack's row 1."""
    jcfg, jparams, cfg, model = _bridged(J, "deepseek-qlora")
    for key in ("moe", "attn"):
        leaf = "w2" if key == "moe" else "w_uk"
        want = np.asarray(jparams["layers"][key][leaf])
        assert want.shape[0] == cfg.num_layers
        got = getattr(getattr(model.layers[1], key), leaf)
        np.testing.assert_array_equal(got.numpy(), want[1])
    assert model.layers[0].attn.w_dq.shape == (cfg.d_model, 64)


# -------------------------------------------------------------- gradients
def _loss(J, jcfg):
    def loss(p, tokens, labels):
        logits, aux = J.api.forward(p, tokens, jcfg)
        return J.api.loss_fn(logits, labels, aux)
    return loss


@pytest.mark.parametrize("name", sorted(MODELS))
def test_loss_and_gradients_match_jax(J, name):
    """``loss_fn(logits, labels, aux)`` (the 0.01 aux term included) and
    every parameter's gradient, each on its own norm."""
    jcfg, jparams, cfg, model = _bridged(J, name)
    prompt = MODELS[name][2]
    tokens = _rng(5).integers(0, cfg.vocab_size, (2, prompt), dtype=np.int32)
    labels = api.batch_labels(cfg, torch.from_numpy(tokens))
    v, g = J.jax.jit(J.jax.value_and_grad(_loss(J, jcfg)))(
        jparams, J.jnp.asarray(tokens), J.jnp.asarray(labels.numpy()))
    want = bridge.params_from_numpy(J.jax.tree.map(np.asarray, g))
    model.requires_grad_(True)
    names, params = zip(*model.named_parameters())
    logits, aux = api.forward(model, torch.from_numpy(tokens), cfg)
    loss = api.loss_fn(logits, labels, aux)
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    assert abs(float(loss.detach()) - float(v)) <= 5e-4
    assert set(grads) == set(want)
    for n, gr in grads.items():
        w = want[n].double()
        assert float(w.norm()) > 0, n
        err = float((gr.double() - w).norm() / w.norm())
        assert err <= GRAD_RTOL, (n, err)


def test_remat_checkpoints_each_group_once_with_the_same_gradients():
    """Under ``cfg.remat`` (the full-width default) each chunk-pattern
    group is checkpointed once, only where autograd records, and the
    loss and gradients are those without it."""
    cfg = get_config(LLAMA4).reduced().replace(num_layers=4)
    tokens = torch.from_numpy(_rng(2).integers(0, cfg.vocab_size, (2, 40),
                                               dtype=np.int32))
    labels = api.batch_labels(cfg, tokens)
    calls = collections.Counter()
    real = layers.checkpoint

    def counted(fn, *a, **k):
        calls[fn.__name__] += 1
        return real(fn, *a, **k)
    out = []
    for remat in (False, True):
        c = cfg.replace(remat=remat)
        model = api.build_params(c, seed=1, device="cpu")
        with torch.no_grad():
            api.forward(model, tokens, c)
        model.requires_grad_(True)
        names, params = zip(*model.named_parameters())
        calls.clear()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(layers, "checkpoint", counted)
            logits, aux = api.forward(model, tokens, c)
            loss = api.loss_fn(logits, labels, aux)
            out.append((float(loss.detach()),
                        torch.autograd.grad(loss, params)))
        assert sum(calls.values()) == (2 if remat else 0)
    assert abs(out[0][0] - out[1][0]) <= 1e-6 * abs(out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert float((a - b).abs().max()) <= 1e-6 * max(
            1.0, float(b.abs().max()))


# --------------------------------------------------------------- segments
@pytest.mark.parametrize("name", sorted(MODELS))
def test_segment_kernel_ids_match_jax(J, name):
    """embed, one ``layer`` KernelID for every layer (chunked and full
    alike), head: the JAX package's segment names and KernelIDs."""
    arch, fields, _ = MODELS[name]
    jcfg = J.config.get_config(arch).reduced().replace(**fields)
    jsvc = J.seg.SegmentedService(
        jcfg, J.api.build_params(jcfg, J.jax.random.key(0)), batch=1, seq=24)
    cfg = get_config(arch).reduced().replace(**fields)
    svc = SegmentedService(cfg, api.build_params(cfg, device="cpu"),
                           batch=1, seq=24)

    def chain(svc):
        ids, state = [], svc.make_input()
        for seg in svc.segments:
            ids.append(seg.kernel_id(state).encode())
            state = seg.fn(state)
        return ids, state
    ids, toks = chain(svc)
    jids, _ = chain(jsvc)
    assert ids == jids and len(set(ids)) == 3
    assert [seg.name for seg in svc.segments] == \
        [seg.name for seg in jsvc.segments] == \
        [f"{cfg.name}/embed"] + [f"{cfg.name}/layer"] * 2 + \
        [f"{cfg.name}/head"]
    assert isinstance(svc.segments[-1].host_work(toks), np.ndarray)


@pytest.mark.parametrize("name", ["llama4", "deepseek"])
def test_segment_chain_equals_forward(name):
    """embed -> layer x L -> head gives ``forward``'s logits bit for bit,
    each layer with its own window and chunk (llama4: chunked, then
    full), at a length past the reduced chunk."""
    arch, _, prompt = MODELS[name]
    cfg = get_config(arch).reduced()
    model = api.build_params(cfg, seed=3, device="cpu")
    svc = SegmentedService(cfg, model, batch=2, seq=prompt)
    tokens = svc.make_input()
    state = tokens
    for seg in svc.segments:
        state = seg.fn(state)
    logits, _ = api.forward(model, tokens, cfg)
    torch.testing.assert_close(state, logits, rtol=0, atol=0)


# ---------------------------------------------------------------- serving
@pytest.mark.parametrize("mode", ["fikit", "sharing"])
@pytest.mark.parametrize("high,low,seq", [
    (LLAMA4, "qwen3-4b", 48),
    # mamba2's reduced SSD chunk (32) must divide the sequence
    (DEEPSEEK, "mamba2-2.7b", 64)], ids=["pair-H", "pair-D"])
def test_serve_pair_on_cpu(high, low, seq, mode):
    """Pairs H and D of the paper's Fig 16, an MoE model as the high
    service, at reduced scale."""
    out = serve_pair(high, low, mode=mode, requests=2, measure_runs=2,
                     seq=seq, device="cpu", verbose=False)
    assert out["high_jct_ms"] > 0 and out["low_jct_ms"] > 0
    assert out["measure_high_ms"] > 0 and out["measure_low_ms"] > 0
    if mode == "sharing":
        assert out["fills"] == 0


def test_cli_serves_pair_h_on_cpu(capsys):
    main(["--mode", "fikit", "--requests", "1", "--device", "cpu",
          "--high", LLAMA4, "--low", "qwen3-4b"])
    printed = capsys.readouterr().out
    assert "mode: fikit" in printed and "high_jct_ms" in printed


# ------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    return torch.device("cuda")


def _bf16_llama4(device, chunk=16):
    """Reduced llama4 in bf16 with llama4's head group (40 over 8 heads,
    G 5) and head dim 128, its chunk cut to ``chunk``."""
    cfg = get_config(LLAMA4).reduced().replace(
        dtype="bfloat16", num_heads=10, num_kv_heads=2, head_dim=128,
        attention_chunk=chunk)
    return cfg, api.build_params(cfg, seed=0, device=device)


@pytest.mark.cuda
def test_moe_layers_on_the_card_match_the_plain_versions(cuda):
    """Both layer kinds (chunked, full): the attention sublayer through
    the flash kernel against the same sublayer on the CPU (the kernel's
    plain version), bf16 within 2e-2 of the output's size; the whole
    layer gives the same bits on two calls. (The whole layer is not held
    to the CPU's: a token whose two best experts nearly tie may be routed
    otherwise under another rounding.)"""
    import copy
    from repro_torch.models import transformer as tfm
    cfg, host = _bf16_llama4("cpu")
    model = copy.deepcopy(host).to(cuda)
    x = torch.randn(2, 40, cfg.d_model, generator=torch.Generator(
        device="cpu").manual_seed(0)).to(torch.bfloat16)
    pos = torch.arange(40, dtype=torch.int32)
    with torch.inference_mode():
        for i, (window, chunk) in enumerate(moe.layer_kinds(cfg)):
            n = flash_ops.flash_attention.launches
            y = tfm.attn_apply_full(model.layers[i].attn, x.to(cuda),
                                    pos.to(cuda), cfg, window=window,
                                    chunk=chunk)
            want = tfm.attn_apply_full(host.layers[i].attn, x, pos, cfg,
                                       window=window, chunk=chunk)
            err = float((y.cpu().float() - want.float()).abs().max())
            assert err <= 2e-2 * max(1.0, float(want.float().abs().max()))
            a, _ = moe.layer_apply(model.layers[i], x.to(cuda), pos.to(cuda),
                                   cfg, window=window, chunk=chunk)
            b, _ = moe.layer_apply(model.layers[i], x.to(cuda), pos.to(cuda),
                                   cfg, window=window, chunk=chunk)
            assert torch.equal(a, b)
            assert flash_ops.flash_attention.launches == n + 3


@pytest.mark.cuda
def test_moe_prefill_and_decode_on_the_card(cuda):
    """Prefill past the chunk, then decode steps through the decode
    kernel over the wrapped rings: finite logits, one decode launch a
    layer a step."""
    from repro_torch.kernels.decode_attention import ops as decode_ops
    cfg, model = _bf16_llama4(cuda)
    tokens = torch.randint(0, cfg.vocab_size, (1, 40), dtype=torch.int32,
                           device=cuda)
    with torch.inference_mode():
        logits, caches = api.prefill(model, tokens, cfg, extra_capacity=4)
        n = decode_ops.decode_attention.launches
        for i in range(4):
            tok = logits.argmax(-1).to(torch.int32)
            logits, caches = api.decode_step(model, tok, 40 + i, caches, cfg)
            assert bool(torch.isfinite(logits).all())
    assert decode_ops.decode_attention.launches == n + 4 * cfg.num_layers
