"""The port's dense decoder against the JAX package's, on the CPU.

Inputs and weights come from numpy / the JAX package's own init and are
handed to both frameworks (weights through ``repro_torch.bridge``).
Everything runs in fp32: the point is the algorithm. The two frameworks
sum the same products in other orders, so their results differ by fp32
rounding. Layers are held to atol = rtol = 1e-4. Whole-model logits get
atol 5e-4: the random-init residual stream of reduced stablelm grows to
~60, and against a float64 forward of the same weights the JAX logits
are off by 3.7e-4 and the port's by 1.1e-4 (max |logit| 3.6); qwen3's
qk-norm keeps both within 3e-6. A convention slip (norm scale, rope
pairing, GQA head order) moves logits by 1e-2 or more.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import config as jconfig  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.models import api, layers  # noqa: E402
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


# ------------------------------------------------------------ whole model
MODEL_CASES = {
    "qwen3-4b-mha": lambda: jconfig.get_config("qwen3-4b").reduced(),
    # reduced qwen3 has H = Kh = 4 and never exercises GQA
    "qwen3-4b-gqa": lambda: jconfig.get_config("qwen3-4b").reduced()
    .replace(num_kv_heads=2),
    "stablelm-1.6b": lambda: jconfig.get_config("stablelm-1.6b").reduced(),
}


def _port_cfg(jcfg):
    """The port's config of the same architecture, with the same fields."""
    base = get_config(jcfg.name.replace("-reduced", ""))
    return base.reduced().replace(num_kv_heads=jcfg.num_kv_heads,
                                  dtype=jcfg.dtype)


def _bridged(jcfg, seed=0):
    jparams = japi.build_params(jcfg, jax.random.key(seed))
    cfg = _port_cfg(jcfg)
    model = api.build_params(cfg, seed=seed, device="cpu")
    state = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    model.load_state_dict(state)
    return jparams, cfg, model, state


@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_logits_match_jax_forward(name):
    jcfg = MODEL_CASES[name]()
    jparams, cfg, model, _ = _bridged(jcfg)
    tokens = _rng(5).integers(0, cfg.vocab_size, (2, 48), dtype=np.int32)
    want, _ = japi.forward(jparams, jnp.asarray(tokens), jcfg)
    logits, aux = api.forward(model, torch.from_numpy(tokens), cfg)
    assert tuple(logits.shape) == want.shape
    assert float(aux) == 0.0
    _close(logits, want, **LOGIT_TOL)


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
    cfg = get_config("qwen3-4b").reduced().replace(family="ssm")
    with pytest.raises(NotImplementedError, match="decode slice"):
        api.build_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        api.make_batch(cfg.replace(family="moe"), 1, 8, device="cpu")
