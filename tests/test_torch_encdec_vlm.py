"""The port's encoder-decoder (seamless-m4t-medium), VLM
(llava-next-mistral-7b) and h2o-danube-3-4b against the JAX package's, on
the CPU at ``.reduced()`` size (2 + 2 layers and 32 frames; 16 patches
and a 64-token window; head dim 64): full-sequence logits, prefill
followed by decode steps, the encoder and one decoder layer alone,
segment KernelIDs and segment chains, serving of the paper's Fig 16
pairs F and J, and ``attend``'s contract on positions.

Inputs come from numpy with a seed and weights from the JAX package's own
init, handed to both frameworks (weights through ``repro_torch.bridge``).
Everything runs in fp32, with the tolerances of
``tests/test_torch_models.py``: the encoder at atol = rtol = 1e-4;
logits, decode logits and caches at atol 5e-4, rtol 1e-4 (the
random-init residual stream grows with depth, and the two frameworks sum
the same products in other orders). The reduced encoder-decoder's
decoder is worse conditioned: the JAX init scales ``wq`` and ``wk`` by
1/sqrt(H) (fan_in = shape[-2]), so its attention logits have a standard
deviation near 50, the softmax is near one-hot, and one decoder layer
takes embeddings of size 0.02 to a residual stream of size 70. Against
a float64 forward of the same weights its fp32 logits are off by 2.6e-3
(JAX) and 2.0e-3 (port), max |logit| 4.0, and the two frameworks by
2.1e-3; so its decoder layer, logits, decode logits and caches are held
to atol 5e-3, rtol 1e-4 (``SEAMLESS_TOL``), about twice the larger
float64 gap (``test_tolerance_is_the_float64_gap``). llava's and
h2o's logits sit within 5e-4 of the float64 forward in both frameworks
and keep LOGIT_TOL. A slip of convention (a roped cross q
or a causal cross mask) moves its logits by about 4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import config as jconfig  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import segmentation as jseg  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models import vlm as jvlm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.launch.serve import main, serve_pair  # noqa: E402
from repro_torch.models import api, attention, encdec, vlm  # noqa: E402
from repro_torch.models.segmentation import SegmentedService  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
LOGIT_TOL = dict(atol=5e-4, rtol=1e-4)
SEAMLESS_TOL = dict(atol=5e-3, rtol=1e-4)
SEAMLESS, LLAVA, H2O = ("seamless-m4t-medium", "llava-next-mistral-7b",
                        "h2o-danube-3-4b")
NAMES = [SEAMLESS, LLAVA, H2O]
DECODE_STEPS = 8


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(out, want, **tol):
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(want, dtype=np.float32),
                               **(tol or TOL))


def _logit_tol(cfg):
    return SEAMLESS_TOL if cfg.family == "encdec" else LOGIT_TOL


def _bridged(name, seed=0):
    jcfg = jconfig.get_config(name).reduced()
    jparams = japi.build_params(jcfg, jax.random.key(seed))
    cfg = get_config(name).reduced()
    model = api.build_params(cfg, seed=seed, device="cpu")
    state = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    return jcfg, jparams, cfg, model


def _batch(cfg, text, seed=5):
    """The same batch as numpy for both frameworks: frames of 0.02 N(0, 1)
    and tokens for the encoder-decoder; the stub patches and tokens for
    the VLM; tokens for the dense model."""
    r = _rng(seed)
    tokens = r.integers(0, cfg.vocab_size, (2, text), dtype=np.int32)
    if cfg.family == "encdec":
        frames = (0.02 * r.standard_normal(
            (2, cfg.encoder_frames, cfg.d_model))).astype(np.float32)
        return ((torch.from_numpy(frames), torch.from_numpy(tokens)),
                (jnp.asarray(frames), jnp.asarray(tokens)))
    if cfg.family == "vlm":
        patches = vlm.stub_patches(cfg, 2, device="cpu")
        return ((patches, torch.from_numpy(tokens)),
                (jnp.asarray(patches.numpy()), jnp.asarray(tokens)))
    return torch.from_numpy(tokens), jnp.asarray(tokens)


# ------------------------------------------------------------ whole model
@pytest.mark.parametrize("name", NAMES)
def test_logits_match_jax_forward(name):
    jcfg, jparams, cfg, model = _bridged(name)
    batch, jbatch = _batch(cfg, 24)
    want, _ = japi.forward(jparams, jbatch, jcfg)
    logits, aux = api.forward(model, batch, cfg)
    assert tuple(logits.shape) == want.shape
    assert float(aux) == 0.0
    _close(logits, want, **_logit_tol(cfg))


def _flat_caches(cfg, caches, jcaches):
    """(port tensors, JAX arrays) field by field: the JAX caches are
    stacked over layers, the port's are a list."""
    if cfg.family == "encdec":
        got = [torch.stack([c.self_kv[i] for c in caches]) for i in range(3)]
        got += [torch.stack([c.cross_k for c in caches]),
                torch.stack([c.cross_v for c in caches])]
        return got, list(jcaches.self_kv) + [jcaches.cross_k,
                                             jcaches.cross_v]
    return [torch.stack(f) for f in zip(*caches)], list(jcaches)


# name: text tokens of the prompt. llava: 16 patches + 56 tokens and h2o's
# 70 tokens pass the reduced 64-token window, so prefill keeps a wrapped
# ring and decode wraps further; seamless: 24 tokens over 32 frames
PROMPTS = {SEAMLESS: 24, LLAVA: 56, H2O: 70}


def _float64_forward(model, batch, cfg, monkeypatch):
    """The port's forward in float64: weights, frames and every fp32 cast
    of its functions (``Tensor.float``) kept in float64."""
    orig = torch.Tensor.float
    monkeypatch.setattr(torch.Tensor, "float", lambda t, *a, **k: t
                        if t.dtype == torch.float64 else orig(t, *a, **k))
    if isinstance(batch, tuple):
        batch = tuple(t.double() if t.is_floating_point() else t
                      for t in batch)
    out = api.forward(model.double(), batch, cfg.replace(dtype="float64"))
    monkeypatch.undo()
    return out[0].numpy()


@pytest.mark.parametrize("name", NAMES)
def test_tolerance_is_the_float64_gap(name, monkeypatch):
    """The tolerances' reason: against a float64 forward of the same
    weights, the JAX package's fp32 logits and the port's are each within
    the tolerance their comparison is held to: LOGIT_TOL's 5e-4 for
    llava and h2o, SEAMLESS_TOL's 5e-3 for seamless."""
    jcfg, jparams, cfg, model = _bridged(name)
    batch, jbatch = _batch(cfg, 24)
    want = np.asarray(japi.forward(jparams, jbatch, jcfg)[0])
    got = api.forward(model, batch, cfg)[0].numpy()
    exact = _float64_forward(model, batch, cfg, monkeypatch)
    gaps = [float(np.abs(x - exact).max()) for x in (want, got)]
    assert all(g < _logit_tol(cfg)["atol"] for g in gaps), gaps


@pytest.mark.parametrize("name", NAMES)
def test_prefill_then_decode_matches_jax(name):
    jcfg, jparams, cfg, model = _bridged(name)
    batch, jbatch = _batch(cfg, PROMPTS[name], seed=7)
    steps = _rng(8).integers(0, cfg.vocab_size, (DECODE_STEPS, 2, 1),
                             dtype=np.int32)
    want, jcaches = japi.prefill(jparams, jbatch, jcfg,
                                 extra_capacity=DECODE_STEPS)
    logits, caches = api.prefill(model, batch, cfg,
                                 extra_capacity=DECODE_STEPS)
    assert tuple(logits.shape) == want.shape == (2, 1, cfg.vocab_size)
    tol = _logit_tol(cfg)
    _close(logits, want, **tol)
    prompt = PROMPTS[name] + (cfg.num_patches if cfg.family == "vlm" else 0)
    for i in range(DECODE_STEPS):
        want, jcaches = japi.decode_step(jparams, jnp.asarray(steps[i]),
                                         prompt + i, jcaches, jcfg)
        logits, caches = api.decode_step(model, torch.from_numpy(steps[i]),
                                         prompt + i, caches, cfg)
        _close(logits, want, **tol)
    got, ref = _flat_caches(cfg, caches, jcaches)
    assert [tuple(t.shape) for t in got] == [a.shape for a in ref]
    for t, a in zip(got, ref):
        _close(t, a, **tol)


@pytest.mark.parametrize("name", [SEAMLESS, LLAVA])
def test_init_decode_caches_match_jax(name):
    """Empty caches: the same shapes, dtypes and empty-slot marks (-1) as
    the JAX package's (llava's ring is its 64-token window)."""
    jcfg = jconfig.get_config(name).reduced()
    cfg = get_config(name).reduced()
    got, ref = _flat_caches(
        cfg, api.init_decode_caches(cfg, 2, 100, device="cpu"),
        japi.init_decode_caches(jcfg, 2, 100))
    assert [tuple(t.shape) for t in got] == [a.shape for a in ref]
    for t, a in zip(got, ref):
        assert str(t.dtype).split(".")[1] == str(a.dtype)
        _close(t, a, atol=0, rtol=0)


# ------------------------------------------------- encoder-decoder parts
def test_encode_matches_jax():
    """The bidirectional encoder (with rope) over the stub frames."""
    jcfg, jparams, cfg, model = _bridged(SEAMLESS)
    (frames, _), (jframes, _) = _batch(cfg, 8)
    _close(encdec.encode(model, frames, cfg),
           jencdec.encode(jparams, jframes, jcfg))


@pytest.mark.parametrize("layer", [0, 1])
def test_decoder_layer_matches_jax(layer):
    """One decoder layer alone on the path's inputs (the JAX package's
    token embeddings and encoder output): causal self-attention, then
    non-causal cross-attention (Sq 24 over Sk 32 frames), then the MLP."""
    jcfg, jparams, cfg, model = _bridged(SEAMLESS)
    _, (jframes, jtokens) = _batch(cfg, 24)
    x = np.array(jtfm.embed_tokens(jparams, jtokens, jcfg))
    enc = np.array(jencdec.encode(jparams, jframes, jcfg))
    lp = jax.tree.map(lambda a: a[layer], jparams["dec_layers"])
    want = jencdec._dec_layer(lp, jnp.asarray(x),
                              jnp.arange(24, dtype=jnp.int32),
                              jnp.asarray(enc), jcfg)
    got = encdec._dec_layer(model.dec_layers[layer], torch.from_numpy(x),
                            torch.arange(24, dtype=torch.int32),
                            torch.from_numpy(enc), cfg)
    _close(got, want, **SEAMLESS_TOL)


@pytest.mark.parametrize("name", [SEAMLESS, LLAVA])
@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_make_batch_matches_jax_avals(name, reduced):
    """make_batch gives the JAX package's shapes and dtypes: frames
    [B, Sf, D] in the config's dtype and int32 tokens; for the VLM the
    stub patches and max(S - P, 1) tokens (1 at full width and seq 48)."""
    cfg, jcfg = get_config(name), jconfig.get_config(name)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    got = api.make_batch(cfg, 2, 48, device="cpu")
    want = jax.eval_shape(lambda: japi.make_batch(jcfg, 2, 48))
    assert [(tuple(t.shape), str(t.dtype).split(".")[1]) for t in got] == \
        [(w.shape, str(w.dtype)) for w in want]


def test_stub_patches_match_jax():
    cfg = get_config(LLAVA).reduced()
    got = vlm.stub_patches(cfg, 3, device="cpu")
    want = jvlm.stub_patches(jconfig.get_config(LLAVA).reduced(), 3)
    assert tuple(got.shape) == want.shape == (3, 16, cfg.d_model)
    _close(got, want, atol=1e-7, rtol=0)
    bf16 = vlm.stub_patches(cfg.replace(dtype="bfloat16"), 1, device="cpu")
    assert bf16.dtype == torch.bfloat16


# ------------------------------------------------------------- segments
def _ids_and_states(svc, state, first=None):
    """KernelIDs and states down the segment chain; ``first`` replaces
    the first segment's body."""
    ids = []
    for i, seg in enumerate(svc.segments):
        ids.append(seg.kernel_id(state).encode())
        state = (first if i == 0 and first else seg.fn)(state)
    return ids, state


@pytest.mark.parametrize("name,unique", [(SEAMLESS, 3), (LLAVA, 3),
                                         (H2O, 3)])
def test_segment_kernel_ids_match_jax(name, unique):
    """Every segment's KernelID equals the JAX package's: int32 tokens,
    frames and activations in the config's dtype, the encoder-decoder's
    tuple state. The JAX package's VLM embed segment reads ``.shape`` of
    its (patches, tokens) batch and fails, so its KernelID is taken on
    that batch and its body is what it means: the tokens' embeddings
    after the stub patches."""
    jcfg = jconfig.get_config(name).reduced()
    jsvc = jseg.SegmentedService(
        jcfg, japi.build_params(jcfg, jax.random.key(0)), batch=1, seq=24)
    cfg = get_config(name).reduced()
    svc = SegmentedService(cfg, api.build_params(cfg, device="cpu"),
                           batch=1, seq=24)
    first = None
    if cfg.family == "vlm":
        def first(batch):
            return jtfm.embed_tokens(jsvc.params, batch[1], jcfg,
                                     jvlm.stub_patches(jcfg, 1))
    ids, toks = _ids_and_states(svc, svc.make_input())
    jids, _ = _ids_and_states(jsvc, jsvc.make_input(), first)
    assert ids == jids
    assert [seg.name for seg in svc.segments] == \
        [seg.name for seg in jsvc.segments]
    assert len(set(ids)) == unique
    assert isinstance(svc.segments[-1].host_work(toks), np.ndarray)


@pytest.mark.parametrize("name", [SEAMLESS, LLAVA])
def test_segment_chain_equals_forward(name):
    """encode -> dec_layer x Ld -> head (seamless) and embed with the stub
    patches -> layer x L -> head (llava) give the model's logits."""
    cfg = get_config(name).reduced()
    model = api.build_params(cfg, seed=3, device="cpu")
    svc = SegmentedService(cfg, model, batch=2, seq=24)
    names = [seg.name.split("/")[1] for seg in svc.segments]
    if name == SEAMLESS:
        assert names == ["encode"] + ["dec_layer"] * 2 + ["head"]
    else:
        assert names == ["embed"] + ["layer"] * 2 + ["head"]
    batch = svc.make_input()
    state = batch
    for seg in svc.segments:
        state = seg.fn(state)
    logits, _ = api.forward(model, batch, cfg)
    torch.testing.assert_close(state, logits, rtol=0, atol=0)


# -------------------------------------------------------------- serving
@pytest.mark.parametrize("high,low", [("stablelm-1.6b", H2O),
                                      (SEAMLESS, LLAVA)],
                         ids=["pair-F", "pair-J"])
def test_serve_pair_on_cpu(high, low):
    """Pairs F and J of the paper's Fig 16 serve under FIKIT at reduced
    scale."""
    out = serve_pair(high, low, mode="fikit", requests=2, measure_runs=2,
                     device="cpu", verbose=False)
    assert out["high_jct_ms"] > 0 and out["low_jct_ms"] > 0
    assert out["measure_high_ms"] > 0 and out["measure_low_ms"] > 0


def test_cli_serves_pair_j_on_cpu(capsys):
    main(["--mode", "sharing", "--requests", "1", "--device", "cpu",
          "--high", SEAMLESS, "--low", LLAVA])
    printed = capsys.readouterr().out
    assert "mode: sharing" in printed and "fills: 0" in printed


# ------------------------------------------------ attend's position rule
@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False,
                                                         window=8),
                                dict(causal=False, chunk=8)],
                         ids=["causal", "window", "chunk"])
def test_attend_refuses_masks_that_read_positions_when_sq_ne_sk(kw):
    """With Sq != Sk a causal, window or chunk mask would read positions
    that the kernel derives from indices: ``attend`` raises before any
    launch. Non-causal cross-attention is taken."""
    q = torch.zeros(1, 4, 2, 64)
    k = torch.zeros(1, 16, 2, 64)
    qpos = torch.arange(4, dtype=torch.int32)
    kpos = torch.arange(16, dtype=torch.int32)
    with pytest.raises(ValueError, match="cross-attention"):
        attention.attend(q, k, k, qpos, kpos, **kw)
    out = attention.attend(q, k, k, qpos, kpos, causal=False)
    assert tuple(out.shape) == (1, 4, 2, 64)


def test_cross_attention_matches_jax_attend():
    """Non-causal cross-attention (Sq 1 and 24 over Sk 32, GQA) through
    ``attend`` equals the JAX package's blockwise attention."""
    from repro.models import attention as jattn
    r = _rng(11)
    k = r.standard_normal((2, 32, 2, 64)).astype(np.float32)
    v = r.standard_normal((2, 32, 2, 64)).astype(np.float32)
    for sq in (1, 24):
        q = r.standard_normal((2, sq, 4, 64)).astype(np.float32)
        qpos = np.arange(sq, dtype=np.int32) + 5
        kpos = np.arange(32, dtype=np.int32)
        got = attention.attend(*(torch.from_numpy(a) for a in
                                 (q, k, v, qpos, kpos)), causal=False)
        want = jattn.attend(*(jnp.asarray(a) for a in (q, k, v, qpos, kpos)),
                            causal=False)
        _close(got, want, atol=2e-5, rtol=2e-5)
