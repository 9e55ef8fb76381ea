"""The port's dense decoder, mamba2 SSM and recurrentgemma hybrid against
the JAX package's, on the CPU: full-sequence logits, and prefill followed
by one-token decode steps (logits at every step and the final caches).

Inputs and weights come from numpy / the JAX package's own init and are
handed to both frameworks (weights through ``repro_torch.bridge``).
Everything runs in fp32: the point is the algorithm. The two frameworks
sum the same products in other orders, so their results differ by fp32
rounding. Layers are held to atol = rtol = 1e-4. Whole-model logits get
atol 5e-4: the random-init residual stream of reduced stablelm grows to
~60, and against a float64 forward of the same weights the JAX logits
are off by 3.7e-4 and the port's by 1.1e-4 (max |logit| 3.6); qwen3's
qk-norm keeps both within 3e-6. Reduced granite's MQA keys are not scaled
down (fan_in = Kh = 1), so its attention logits are large: against a
float64 forward its JAX logits are off by 1.1e-3 and the port's by 6.3e-4
(max |logit| 3.7), and the two frameworks agree within the same atol
5e-4 + rtol 1e-4. mamba2's logits agree within 1e-5. A convention slip (norm scale, rope
pairing, GQA head order) moves logits by 1e-2 or more. Decode logits and
the caches' k/v after prefill + 8 steps are held to the same 5e-4 (the
caches carry the same residual stream), slot positions exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import config as jconfig  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import mamba2 as jmamba2  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.models import api, layers, mamba2  # noqa: E402
from repro_torch.models.segmentation import SegmentedService  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
LOGIT_TOL = dict(atol=5e-4, rtol=1e-4)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(out, want, **tol):
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(want, dtype=np.float32),
                               **(tol or TOL))


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    x = _rng(1).standard_normal((2, 5, 64), dtype=np.float32)
    g = _rng(2).standard_normal((64,), dtype=np.float32) * 0.1
    td = layers.torch_dtype(dtype)
    out = layers.rms_norm(torch.from_numpy(x).to(td),
                          torch.from_numpy(g).to(td), 1e-5)
    want = jlayers.rms_norm(jnp.asarray(x).astype(dtype),
                            jnp.asarray(g).astype(dtype), 1e-5)
    assert out.dtype == td
    # bf16: one ulp of the output (values up to ~4, ulp 2**-6)
    tol = TOL if dtype == "float32" else dict(atol=2e-2, rtol=1e-2)
    _close(out, want.astype(jnp.float32), **tol)


@pytest.mark.parametrize("pct", [1.0, 0.25])
def test_apply_rope_matches_jax(pct):
    x = _rng(3).standard_normal((2, 48, 4, 64), dtype=np.float32)
    pos = np.arange(48, dtype=np.int32)
    out = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), pct,
                            1e6)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), pct, 1e6)
    _close(out, want, atol=1e-5, rtol=1e-5)
    rot = int(64 * pct) // 2 * 2
    # the dims past rot_dim pass through untouched
    assert torch.equal(out[..., rot:], torch.from_numpy(x)[..., rot:])


def test_mlp_matches_jax():
    r = _rng(4)
    x = r.standard_normal((2, 7, 32), dtype=np.float32)
    w = {"w_gate": r.standard_normal((32, 64), dtype=np.float32) * 0.2,
         "w_up": r.standard_normal((32, 64), dtype=np.float32) * 0.2,
         "w_down": r.standard_normal((64, 32), dtype=np.float32) * 0.2}
    mlp = layers.MLP(layers.Maker(0, torch.float32, "cpu"), 32, 64)
    mlp.load_state_dict({k: torch.from_numpy(v) for k, v in w.items()})
    want = jlayers.mlp_apply({k: jnp.asarray(v) for k, v in w.items()},
                             jnp.asarray(x))
    _close(mlp(torch.from_numpy(x)), want)


def test_maker_draws_the_jax_distributions():
    """Same seed and name -> same values; another name -> other values;
    dense weights are N(0,1) truncated at 2 sigma, scaled by 1/sqrt(fan_in)
    with fan_in = shape[-2], the JAX package's rule; embeddings are
    0.02 * N(0,1)."""
    make = layers.Maker(7, torch.float32, "cpu")
    a = make("layers.0.mlp.w_up", (64, 256, 512))
    assert torch.equal(a, layers.Maker(7, torch.float32, "cpu")(
        "layers.0.mlp.w_up", (64, 256, 512)))
    assert not torch.equal(a, make("layers.1.mlp.w_up", (64, 256, 512)))
    assert not a.requires_grad
    scaled = a * 256 ** 0.5
    assert float(scaled.abs().max()) <= 2.0 + 1e-5
    # std of N(0,1) truncated at +-2 sigma is 0.8796
    assert abs(float(scaled.std()) - 0.8796) < 0.01
    e = make("embed", (512, 256), "embed")
    assert abs(float(e.std()) - 0.02) < 0.001
    assert torch.count_nonzero(make("ln1", (256,), "zeros")) == 0
    ones = layers.Maker(7, torch.bfloat16, "cpu")("b0_lam", (64,), "ones")
    assert ones.dtype == torch.bfloat16 and torch.equal(
        ones, torch.ones(64, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        make("x", (2,), "uniform")


@pytest.mark.parametrize("with_buf", [False, True], ids=["fresh", "buf"])
def test_causal_conv_matches_jax(with_buf):
    """The rec blocks' depthwise causal conv and its carried history."""
    r = _rng(6)
    x = r.standard_normal((2, 7, 16), dtype=np.float32)
    w = r.standard_normal((4, 16), dtype=np.float32)
    buf = r.standard_normal((2, 3, 16), dtype=np.float32) if with_buf \
        else None
    y, new_buf = mamba2._causal_conv(
        torch.from_numpy(x), torch.from_numpy(w),
        None if buf is None else torch.from_numpy(buf))
    want_y, want_buf = jmamba2._causal_conv(
        jnp.asarray(x), jnp.asarray(w),
        None if buf is None else jnp.asarray(buf))
    _close(y, want_y, atol=1e-6, rtol=1e-6)
    _close(new_buf, want_buf, atol=0, rtol=0)


# ------------------------------------------------------------ whole model
MODEL_CASES = {
    "qwen3-4b-mha": lambda: jconfig.get_config("qwen3-4b").reduced(),
    # reduced qwen3 has H = Kh = 4 and never exercises GQA
    "qwen3-4b-gqa": lambda: jconfig.get_config("qwen3-4b").reduced()
    .replace(num_kv_heads=2),
    "stablelm-1.6b": lambda: jconfig.get_config("stablelm-1.6b").reduced(),
    # 2 blocks (rec, attn), lru width 256, window 128, MQA head dim 64
    "recurrentgemma-9b": lambda: jconfig.get_config("recurrentgemma-9b")
    .reduced(),
    # MQA: 4 query heads on one kv head (48 at full width)
    "granite-20b": lambda: jconfig.get_config("granite-20b").reduced(),
    # 2 layers, d_inner 512, 16 heads of 32, state 32, SSD chunk 32
    "mamba2-2.7b": lambda: jconfig.get_config("mamba2-2.7b").reduced(),
}


def _port_cfg(jcfg, **kw):
    """The port's config of the same architecture, with the same fields."""
    base = get_config(jcfg.name.replace("-reduced", ""))
    return base.reduced().replace(num_kv_heads=jcfg.num_kv_heads,
                                  dtype=jcfg.dtype, **kw)


def _bridged(jcfg, seed=0, **kw):
    jparams = japi.build_params(jcfg, jax.random.key(seed))
    cfg = _port_cfg(jcfg, **kw)
    model = api.build_params(cfg, seed=seed, device="cpu")
    state = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    model.load_state_dict(state)
    return jparams, cfg, model, state


@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_logits_match_jax_forward(name):
    jcfg = MODEL_CASES[name]()
    jparams, cfg, model, _ = _bridged(jcfg)
    # the SSD chunk (32 at .reduced()) must divide the sequence: 64 = 2
    # chunks, where 48 trips the assertion in both packages
    seq = 64 if cfg.family == "ssm" else 48
    tokens = _rng(5).integers(0, cfg.vocab_size, (2, seq), dtype=np.int32)
    want, _ = japi.forward(jparams, jnp.asarray(tokens), jcfg)
    logits, aux = api.forward(model, torch.from_numpy(tokens), cfg)
    assert tuple(logits.shape) == want.shape
    assert float(aux) == 0.0
    _close(logits, want, **LOGIT_TOL)


# name: (JAX config, config fields set on both sides, prompt length)
DECODE_CASES = {
    "qwen3-4b": (MODEL_CASES["qwen3-4b-gqa"], {}, 24),
    "stablelm-1.6b": (MODEL_CASES["stablelm-1.6b"], {}, 24),
    # prompts of 40 over a 32-slot ring: prefill keeps the last 32 tokens
    # (the ring branch with its reorder) and decode wraps further
    "qwen3-4b-window32": (MODEL_CASES["qwen3-4b-gqa"],
                          dict(sliding_window=32), 40),
    "qwen3-4b-chunk32": (MODEL_CASES["qwen3-4b-gqa"],
                         dict(attention_chunk=32), 40),
    # past the reduced hybrid's 128-token window
    "recurrentgemma-9b": (MODEL_CASES["recurrentgemma-9b"], {}, 130),
    "granite-20b": (MODEL_CASES["granite-20b"], {}, 24),
    # two SSD chunks of 32; decode carries the state and conv buffers
    "mamba2-2.7b": (MODEL_CASES["mamba2-2.7b"], {}, 64),
}
DECODE_STEPS = 8


def _flat_caches(cfg, caches, jcaches):
    """(port tensors, JAX arrays) of two caches, field by field: the JAX
    dense and SSM caches are stacked over layers, the port's are a list."""
    if cfg.family in ("dense", "ssm"):
        return [torch.stack(f) for f in zip(*caches)], list(jcaches)
    return ([t for c in caches for t in c], [a for c in jcaches for a in c])


@pytest.mark.parametrize("name", sorted(DECODE_CASES))
def test_prefill_then_decode_matches_jax(name):
    make_jcfg, kw, prompt = DECODE_CASES[name]
    jcfg = make_jcfg().replace(**kw)
    jparams, cfg, model, _ = _bridged(jcfg, **kw)
    r = _rng(7)
    tokens = r.integers(0, cfg.vocab_size, (2, prompt), dtype=np.int32)
    steps = r.integers(0, cfg.vocab_size, (DECODE_STEPS, 2, 1),
                       dtype=np.int32)
    want, jcaches = japi.prefill(jparams, jnp.asarray(tokens), jcfg,
                                 extra_capacity=DECODE_STEPS)
    logits, caches = api.prefill(model, torch.from_numpy(tokens), cfg,
                                 extra_capacity=DECODE_STEPS)
    assert tuple(logits.shape) == want.shape == (2, 1, cfg.vocab_size)
    _close(logits, want, **LOGIT_TOL)
    for i in range(DECODE_STEPS):
        pos = prompt + i
        want, jcaches = japi.decode_step(jparams, jnp.asarray(steps[i]), pos,
                                         jcaches, jcfg)
        logits, caches = api.decode_step(model, torch.from_numpy(steps[i]),
                                         pos, caches, cfg)
        _close(logits, want, **LOGIT_TOL)
    got, ref = _flat_caches(cfg, caches, jcaches)
    assert [tuple(t.shape) for t in got] == [a.shape for a in ref]
    for t, a in zip(got, ref):
        _close(t, a, **LOGIT_TOL)


def test_init_decode_caches_match_jax():
    """Empty caches: same shapes, dtypes and empty-slot marks (-1) as the
    JAX package's, for a ragged seq_len, for the hybrid's window and for
    mamba2's zero state and conv buffers."""
    for jcfg, seq_len in ((MODEL_CASES["qwen3-4b-gqa"](), 40),
                          (MODEL_CASES["recurrentgemma-9b"](), 300),
                          (MODEL_CASES["mamba2-2.7b"](), 300)):
        cfg = _port_cfg(jcfg)
        got, ref = _flat_caches(
            cfg, api.init_decode_caches(cfg, 2, seq_len, device="cpu"),
            japi.init_decode_caches(jcfg, 2, seq_len))
        assert [tuple(t.shape) for t in got] == [a.shape for a in ref]
        for t, a in zip(got, ref):
            assert str(t.dtype).split(".")[1] == str(a.dtype)
            _close(t, a, atol=0, rtol=0)


def test_bridge_keeps_dtype_and_shape():
    jcfg = jconfig.get_config("qwen3-4b").reduced().replace(dtype="bfloat16")
    jparams, cfg, model, state = _bridged(jcfg)
    L = jcfg.num_layers
    assert set(state) == set(model.state_dict())
    for key, t in model.state_dict().items():
        assert state[key].dtype == t.dtype == torch.bfloat16, key
        assert state[key].shape == t.shape, key
    wq = np.asarray(jparams["layers"]["attn"]["wq"].astype(jnp.float32))
    assert wq.shape[0] == L
    np.testing.assert_array_equal(
        model.layers[1].attn.wq.float().numpy(), wq[1])


def test_segment_chain_equals_forward():
    """embed -> layer x L -> head through the service's segments gives the
    model's logits."""
    cfg = get_config("stablelm-1.6b").reduced()
    model = api.build_params(cfg, seed=3, device="cpu")
    svc = SegmentedService(cfg, model, batch=2, seq=24)
    assert len(svc.segments) == cfg.num_layers + 2
    tokens = svc.make_input()
    assert tokens.dtype == torch.int32 and tuple(tokens.shape) == (2, 24)
    state = tokens
    for seg in svc.segments:
        state = seg.fn(state)
    logits, _ = api.forward(model, tokens, cfg)
    torch.testing.assert_close(state, logits, rtol=0, atol=0)


def test_other_families_name_their_slice():
    cfg = get_config("qwen3-4b").reduced().replace(family="moe")
    with pytest.raises(NotImplementedError, match="MoE/MLA slice"):
        api.build_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        api.make_batch(cfg, 1, 8, device="cpu")
