"""The port's mamba2 (SSD) pieces against the JAX package's, on the CPU:
the chunked SSD scan, one mixer layer over a sequence and one decode
step, the empty caches and the weight bridge; and, within the port, the
chunked form against the recurrent one.

Inputs are numpy arrays from a seed, handed to both frameworks. The scan
computes in fp32 in both, summing the same products in other orders:
its fp32 outputs are held to atol 1e-5 (+ rtol 1e-5). From bf16 inputs
both compute in fp32 on the same values, so the state is held to the
same fp32 bound and y, rounded to bf16 at the end, to one bf16 ulp of
the JAX value (rtol 2 ** -7). Layers are held to atol = rtol = 1e-4 in
fp32, as in ``tests/test_torch_models.py``; in bf16, where every matmul
and cast rounds to bf16 in its own order, to one bf16 ulp of the largest
output (2 ** -7 of its size; the two differ by at most one ulp, in 0.04 %
of the outputs).
``jax.nn.softplus`` is logaddexp(x, 0) while ``F.softplus`` returns x
above 20: the difference there, log1p(exp(-x)) < 2.1e-9, is below fp32's
resolution.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import config as jconfig  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import mamba2 as jmamba2  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.models import api, mamba2  # noqa: E402
from repro_torch.models.layers import Maker, torch_dtype  # noqa: E402

SSD_TOL = dict(atol=1e-5, rtol=1e-5)
LAYER_TOL = {"float32": dict(atol=1e-4, rtol=1e-4)}
BF16_REL = 2 ** -7


def _rng(seed=0):
    return np.random.default_rng(seed)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(a: np.ndarray, dtype: str) -> torch.Tensor:
    return torch.from_numpy(a).to(torch_dtype(dtype))


def _j(a: np.ndarray, dtype: str):
    return jnp.asarray(a).astype(dtype)


def _hold(out, want, dtype):
    out, want = _f32(out), _f32(want)
    if dtype == "float32":
        np.testing.assert_allclose(out, want, **LAYER_TOL[dtype])
    else:
        scale = float(np.abs(want).max())
        assert float(np.abs(out - want).max()) <= BF16_REL * scale


def _jcfg():
    return jconfig.get_config("mamba2-2.7b").reduced()


# --------------------------------------------------------------- SSD scan
def _ssd_inputs(B, S, H, P, N, seed=0):
    """xh, B_, C_ of the size the mixer gives them (SiLU'd projections),
    dt = softplus(normal) > 0 and A = -exp(normal) < 0."""
    r = _rng(seed)
    xh = r.standard_normal((B, S, H, P), dtype=np.float32)
    dt = np.log1p(np.exp(r.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(0.5 * r.standard_normal(H)).astype(np.float32)
    B_ = r.standard_normal((B, S, N), dtype=np.float32) / np.sqrt(N)
    C_ = r.standard_normal((B, S, N), dtype=np.float32) / np.sqrt(N)
    return xh, dt, A, B_.astype(np.float32), C_.astype(np.float32)


# (S, chunk): one chunk (S == Lc), three chunks, and S < chunk (Lc = S)
SSD_CASES = {"one-chunk": (32, 32), "three-chunks": (96, 32),
             "short": (20, 32)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(SSD_CASES))
def test_ssd_chunked_matches_jax(case, dtype):
    S, chunk = SSD_CASES[case]
    xh, dt, A, B_, C_ = _ssd_inputs(2, S, 4, 8, 16)
    y, hT = mamba2._ssd_chunked(_t(xh, dtype), torch.from_numpy(dt),
                                torch.from_numpy(A), _t(B_, dtype),
                                _t(C_, dtype), chunk)
    want_y, want_h = jmamba2._ssd_chunked(
        _j(xh, dtype), jnp.asarray(dt), jnp.asarray(A), _j(B_, dtype),
        _j(C_, dtype), chunk)
    assert y.dtype == torch_dtype(dtype) and hT.dtype == torch.float32
    assert tuple(y.shape) == want_y.shape and tuple(hT.shape) == want_h.shape
    np.testing.assert_allclose(_f32(hT), _f32(want_h), **SSD_TOL)
    if dtype == "float32":
        np.testing.assert_allclose(_f32(y), _f32(want_y), **SSD_TOL)
    else:                                    # one bf16 ulp of the JAX value
        np.testing.assert_allclose(_f32(y), _f32(want_y), atol=1e-6,
                                   rtol=2 ** -7)


def test_ssd_chunk_must_divide_seq():
    """S 48 with chunk 32 (the reduced config's) raises in both packages:
    the port keeps the JAX package's rule."""
    xh, dt, A, B_, C_ = _ssd_inputs(1, 48, 2, 4, 8)
    with pytest.raises(AssertionError, match="48, 32"):
        jmamba2._ssd_chunked(*map(jnp.asarray, (xh, dt, A, B_, C_)), 32)
    with pytest.raises(AssertionError, match="48, 32"):
        mamba2._ssd_chunked(*map(torch.from_numpy, (xh, dt, A, B_, C_)), 32)


# ------------------------------------------------------------------ layers
def _layer_params(cfg, seed=1):
    """Every parameter of one layer drawn at random (the init's zeros
    too: ln, A_log, dt_bias, D_skip and out_norm), as numpy."""
    D, W = cfg.d_model, cfg.ssm_d_inner
    N, H, K = cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_conv
    r = _rng(seed)
    shapes = {"ln": (D,), "w_z": (D, W), "w_x": (D, W), "w_B": (D, N),
              "w_C": (D, N), "w_dt": (D, H), "conv_x": (K, W),
              "conv_B": (K, N), "conv_C": (K, N), "A_log": (H,),
              "dt_bias": (H,), "D_skip": (H,), "out_norm": (W,),
              "w_out": (W, D)}
    out = {}
    for name, shape in shapes.items():
        scale = 0.5 / np.sqrt(shape[0]) if len(shape) == 2 else 0.3
        out[name] = (scale * r.standard_normal(shape)).astype(np.float32)
    return out


def _layers(cfg, dtype):
    """The same random layer in both packages, in ``dtype``."""
    p = _layer_params(cfg)
    lp = mamba2.Mamba2Layer(Maker(0, torch_dtype(dtype), "cpu"), cfg)
    lp.load_state_dict({k: _t(v, dtype) for k, v in p.items()})
    return lp, {k: _j(v, dtype) for k, v in p.items()}


def _cache(cfg, B, dtype, seed=2):
    """A non-zero cache: an fp32 state and conv histories in ``dtype``."""
    H, P, N, K, W = (cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state,
                     cfg.ssm_conv, cfg.ssm_d_inner)
    r = _rng(seed)
    arrays = (r.standard_normal((B, H, P, N), dtype=np.float32),
              r.standard_normal((B, K - 1, W), dtype=np.float32),
              r.standard_normal((B, K - 1, N), dtype=np.float32),
              r.standard_normal((B, K - 1, N), dtype=np.float32))
    port = mamba2.SSMCache(torch.from_numpy(arrays[0]),
                           *(_t(a, dtype) for a in arrays[1:]))
    ref = jmamba2.SSMCache(jnp.asarray(arrays[0]),
                           *(_j(a, dtype) for a in arrays[1:]))
    return port, ref


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_apply_matches_jax(dtype):
    """The mixer over 64 tokens (two chunks), and the cache it returns."""
    jcfg = _jcfg().replace(dtype=dtype)
    cfg = get_config("mamba2-2.7b").reduced().replace(dtype=dtype)
    lp, jlp = _layers(cfg, dtype)
    x = _rng(3).standard_normal((2, 64, cfg.d_model), dtype=np.float32)
    y, cache = mamba2.layer_apply(lp, _t(x, dtype), cfg, return_cache=True)
    want, jcache = jmamba2.layer_apply(jlp, _j(x, dtype), jcfg,
                                       return_cache=True)
    assert y.dtype == torch_dtype(dtype)
    _hold(y, want, dtype)
    assert cache.state.dtype == torch.float32
    for t, a in zip(cache, jcache):
        assert tuple(t.shape) == a.shape
        assert str(t.dtype).split(".")[1] == str(a.dtype)
        _hold(t, a, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_decode_matches_jax(dtype):
    """One token from a non-zero cache: output, fp32 state and the
    shifted conv histories."""
    jcfg = _jcfg().replace(dtype=dtype)
    cfg = get_config("mamba2-2.7b").reduced().replace(dtype=dtype)
    lp, jlp = _layers(cfg, dtype)
    cache, jcache = _cache(cfg, 2, dtype)
    x = _rng(4).standard_normal((2, 1, cfg.d_model), dtype=np.float32)
    y, new = mamba2.layer_decode(lp, _t(x, dtype), cache, cfg)
    want, jnew = jmamba2.layer_decode(jlp, _j(x, dtype), jcache, jcfg)
    assert y.dtype == torch_dtype(dtype) and new.state.dtype == torch.float32
    _hold(y, want, dtype)
    for t, a in zip(new, jnew):
        assert tuple(t.shape) == a.shape
        _hold(t, a, dtype)


def test_chunked_form_equals_recurrent_form():
    """Within the port: the mixer over S tokens and, from the cache of
    the first S - 1, one decode step of the last token give the same last
    row (the check the card runs at full width in bf16). S 32 and 31 are
    each one chunk: both must divide by min(32, S)."""
    cfg = get_config("mamba2-2.7b").reduced()
    lp, _ = _layers(cfg, "float32")
    x = torch.from_numpy(
        _rng(5).standard_normal((2, 32, cfg.d_model), dtype=np.float32))
    full = mamba2.layer_apply(lp, x, cfg)
    _, cache = mamba2.layer_apply(lp, x[:, :-1], cfg, return_cache=True)
    last, _ = mamba2.layer_decode(lp, x[:, -1:], cache, cfg)
    torch.testing.assert_close(last, full[:, -1:], atol=1e-4, rtol=1e-4)


# ------------------------------------------------------------ caches, bridge
def test_init_decode_caches_dtypes():
    """One zero cache per layer: the state in fp32 [B, H, P, N], the conv
    histories [B, K-1, ·] in the model's dtype."""
    cfg = get_config("mamba2-2.7b").reduced().replace(dtype="bfloat16")
    caches = api.init_decode_caches(cfg, 3, 100, device="cpu")
    H, P, N, K, W = (cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state,
                     cfg.ssm_conv, cfg.ssm_d_inner)
    assert len(caches) == cfg.num_layers
    for c in caches:
        assert isinstance(c, mamba2.SSMCache)
        assert tuple(c.state.shape) == (3, H, P, N)
        assert c.state.dtype == torch.float32
        assert [tuple(t.shape) for t in c[1:]] == [(3, K - 1, W),
                                                   (3, K - 1, N),
                                                   (3, K - 1, N)]
        assert all(t.dtype == torch.bfloat16 for t in c[1:])
        assert all(not t.any() for t in c)


def test_bridge_covers_mamba2():
    """The JAX tree's keys are the model's state dict (layers split,
    embeddings tied: no lm_head), dtypes and shapes kept."""
    jcfg = _jcfg().replace(dtype="bfloat16")
    jparams = japi.build_params(jcfg, jax.random.key(0))
    cfg = get_config("mamba2-2.7b").reduced().replace(dtype="bfloat16")
    model = api.build_params(cfg, device="cpu")
    state = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    assert set(state) == set(model.state_dict())
    assert "lm_head" not in state and "layers.1.w_z" in state
    for key, t in model.state_dict().items():
        assert state[key].dtype == t.dtype == torch.bfloat16, key
        assert state[key].shape == t.shape, key
    model.load_state_dict(state)
    conv = np.asarray(jparams["layers"]["conv_x"].astype(jnp.float32))
    np.testing.assert_array_equal(model.layers[1].conv_x.float().numpy(),
                                  conv[1])
