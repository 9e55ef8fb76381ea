"""The port's partition specs against the JAX package's, on device-free
meshes: ``jax.sharding.AbstractMesh`` for the reference and
``repro_torch.launch.mesh.MeshShape`` for the port, at (1, 1), the
production (16, 16) and the multi-pod (2, 16, 16), for all ten configs at
full size (the reference's parameters as ShapeDtypeStructs, the port's on
the meta device: nothing is allocated). Parameters, AdamW moments (with
and without ZeRO across pods), token / embeds / logits specs and decode
caches are held entry for entry, through the weight bridge's names: the
reference stacks layers ([L, ...] leaves, a leading None in the spec),
the port keeps one tensor per layer. Also the context's no-op without a
mesh and the placements a spec gives.
"""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import config as jconfig  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.sharding import specs as jspecs  # noqa: E402
from repro_torch.bridge import STACKED  # noqa: E402
from repro_torch.config import SHAPES, get_config  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import MULTI_POD, SINGLE_POD, MeshShape  # noqa
from repro_torch.models import api  # noqa: E402
from repro_torch.sharding import context, specs  # noqa: E402

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "16x16": SINGLE_POD,
          "2x16x16": MULTI_POD}


def _meshes(name):
    shape, axes = MESHES[name]
    return (jax.sharding.AbstractMesh(shape, axes), MeshShape(shape, axes))


def _entries(spec):
    return tuple(None if e is None else e if isinstance(e, str) else tuple(e)
                 for e in spec)


def _flat_ref_specs(sds, spec_tree, stacked_replicated=True):
    """name -> spec entries of the reference's spec tree, flattened as the
    bridge flattens its parameters (stacked leaves split per layer, the
    stacked dim's entry dropped: it must be None unless
    ``stacked_replicated`` is false)."""
    out = {}

    def walk(prefix, node, spec):
        if isinstance(node, dict):
            for k, child in node.items():
                walk(f"{prefix}{k}.", child, spec[k])
            return
        if isinstance(node, (list, tuple)):
            for i, child in enumerate(node):
                walk(f"{prefix}{i}.", child, spec[i])
            return
        key = prefix[:-1]
        stack, _, rest = key.partition(".")
        e = _entries(spec)
        if stack in STACKED and rest:
            assert e[0] is None or not stacked_replicated, (key, e)
            for i in range(node.shape[0]):
                out[f"{stack}.{i}.{rest}"] = e[1:]
        else:
            out[key] = e

    walk("", sds, spec_tree)
    return out


_REF_PARAMS = {}


def _ref_params(arch):
    if arch not in _REF_PARAMS:
        _REF_PARAMS[arch] = jsteps.params_specs(jconfig.get_config(arch))
    return _REF_PARAMS[arch]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch, mesh):
    jmesh, tmesh = _meshes(mesh)
    sds = _ref_params(arch)
    want = _flat_ref_specs(sds, jspecs.param_specs(sds, jmesh))
    model = steps.params_specs(get_config(arch))
    got = {n: _entries(s) for n, s in specs.param_specs(model, tmesh).items()}
    assert got == want


@pytest.mark.parametrize("zero", [None, "pod"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_opt_specs_match_reference(arch, zero):
    """Moments share their parameter's spec; with ZeRO across pods (the
    multi-pod mesh) each moment's first unsharded divisible dim goes on
    ``pod``. The step is replicated."""
    jmesh, tmesh = _meshes("2x16x16")
    sds = _ref_params(arch)
    jp = jspecs.param_specs(sds, jmesh)
    jo = jspecs.opt_specs(None, jp, zero_axis=zero, params=sds, mesh=jmesh)
    model = steps.params_specs(get_config(arch))
    tp = specs.param_specs(model, tmesh)
    to = specs.opt_specs(None, tp, zero_axis=zero, params=model, mesh=tmesh)
    assert _entries(to.step) == _entries(jo.step) == ()
    want = _flat_ref_specs(sds, jo.mu, stacked_replicated=not zero)
    if zero:
        # The reference widens a stacked leaf on its first divisible dim,
        # the layer dim (layer i's moments on pod i // (L / 2)); the port
        # holds one tensor per layer, which every rank shards, so it
        # widens the first divisible dim of the layer's own shape. Those
        # leaves are held to the reference's rule applied to the
        # per-layer view (its own opt_specs over the flattened names and
        # shapes), every other leaf to the reference directly.
        flat_p = {n: jax.sharding.PartitionSpec(*e) for n, e in
                  _flat_ref_specs(sds, jp).items()}
        flat_sds = {n: p for n, p in model.named_parameters()}
        per_layer = jspecs.opt_specs(None, flat_p, zero_axis=zero,
                                     params=flat_sds, mesh=jmesh).mu
        stacked = {n for n in want if n.partition(".")[0] in STACKED}
        want = {n: (_entries(per_layer[n]) if n in stacked else e)
                for n, e in want.items()}
        assert any("pod" in e for e in want.values())
    for field in ("mu", "nu"):
        got = {n: _entries(s) for n, s in getattr(to, field).items()}
        assert got == want


@pytest.mark.parametrize("batch", [1, 6, 32, 128, 256])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_activation_specs_match_reference(mesh, batch):
    jmesh, tmesh = _meshes(mesh)
    for fn in ("token_spec", "embeds_spec"):
        assert _entries(getattr(specs, fn)(tmesh, batch)) == \
            _entries(getattr(jspecs, fn)(jmesh, batch))
    for vocab in (0, 151936, 256206):
        assert _entries(specs.logits_spec(tmesh, batch, vocab)) == \
            _entries(jspecs.logits_spec(jmesh, batch, vocab))


def _flat_ref_caches(cfg, spec, sds):
    """The reference's cache specs per layer, each a tuple of field
    entries (nested for the encoder-decoder's self-attention cache), the
    stacked dim dropped."""
    def fields(node, s, stacked):
        if hasattr(node, "_fields"):
            return tuple(fields(getattr(node, f), getattr(s, f), stacked)
                         for f in node._fields)
        e = _entries(s)
        return e[1:] if stacked else e

    if isinstance(sds, list):
        return [fields(c, s, False) for c, s in zip(sds, spec)]
    L = jax.tree.leaves(sds)[0].shape[0]
    return [fields(sds, spec, True)] * L


def _flat_port_caches(spec):
    def fields(s):
        if isinstance(s, specs.P):
            return _entries(s)
        return tuple(fields(f) for f in s)
    return [fields(s) for s in spec]


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_reference(arch, mesh, shape):
    jmesh, tmesh = _meshes(mesh)
    jcfg, cfg = jconfig.get_config(arch), get_config(arch)
    B, S = SHAPES[shape].global_batch, SHAPES[shape].seq_len
    sds = jax.eval_shape(lambda: japi.init_decode_caches(jcfg, B, S))
    want = _flat_ref_caches(jcfg, jspecs.cache_specs(jcfg, sds, jmesh, B),
                            sds)
    caches = api.init_decode_caches(cfg, B, S, device="meta")
    got = _flat_port_caches(specs.cache_specs(cfg, caches, tmesh, B))
    assert got == want


def test_constrain_is_a_no_op_without_a_mesh():
    x = torch.arange(12.0).reshape(3, 4)
    assert context.get_mesh() is None
    assert context.constrain(x, "batch", "model") is x
    assert context.batch_axes() is None and context.model_axis_size() == 1
    z = context.zeros((2, 3), torch.float32, "cpu", "batch", None)
    assert type(z) is torch.Tensor and not z.any()


def test_constrain_is_a_no_op_on_a_plain_tensor_under_a_mesh():
    x = torch.ones(4, 8)
    with context.mesh_context(MeshShape((2, 2), ("data", "model"))):
        assert context.batch_axes() == ("data",)
        assert context.model_axis_size() == 2
        assert context.constrain(x, "batch", "model") is x
    assert context.get_mesh() is None


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard
    m = MeshShape(*MULTI_POD)
    assert specs.placements(specs.P(("pod", "data"), None, "model"), m) == \
        [Shard(0), Shard(0), Shard(2)]
    assert specs.placements(specs.P(None, "data"), m) == \
        [Replicate(), Shard(1), Replicate()]
    with pytest.raises(ValueError, match="mesh order"):
        specs.placements(specs.P(("data", "pod")), m)
    assert context.spec_placements(m, (64, 6, 32), ("batch", None, "model")) \
        == [Shard(0), Shard(0), Shard(2)]
    # not divisible: dropped, as the JAX package's constrain drops it
    assert context.spec_placements(m, (6, 8), ("batch", "model")) == \
        [Replicate(), Replicate(), Replicate()]


@pytest.mark.parametrize("heads,kv_heads", [(4, 2), (8, 2), (12, 6)])
def test_kv_heads_for_a_rank_whose_kv_heads_are_replicated(heads, kv_heads):
    """``_sharded.kv_heads_for`` on each rank of a 4-way model axis where
    the query heads shard and the kv heads (which do not divide the axis)
    replicate: the rank's query head i reads global kv head i // G. H4
    Kh2 gives a rank one query head of a group of 2, H8 Kh2 two of a
    group of 4; H12 Kh6 gives three heads across groups of 2, which
    raises, naming the head counts. The fake backend's ranks move no
    data, so each rank is taken in turn in this process."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.kernels import _sharded
    from repro_torch.launch.mesh import make_mesh

    G, Hl = heads // kv_heads, heads // 4
    q = torch.arange(heads, dtype=torch.float32).reshape(1, heads, 1, 1)
    k = torch.arange(kv_heads, dtype=torch.float32).reshape(1, kv_heads, 1, 1)
    assert not dist.is_initialized()
    for rank in range(4):
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=4)
        try:
            mesh = make_mesh((1, 4), ("data", "model"), "cpu")
            qd = DTensor.from_local(q[:, rank * Hl:(rank + 1) * Hl], mesh,
                                    [Replicate(), Shard(1)], run_check=False)
            kd = DTensor.from_local(k, mesh, [Replicate(), Replicate()],
                                    run_check=False)
            if Hl % G and G % Hl:
                with pytest.raises(NotImplementedError,
                                   match=f"{Hl} of {heads} query heads .* "
                                         f"{kv_heads} kv heads"):
                    _sharded.kv_heads_for("op", qd, kd, kd, hdim=1)
                continue
            ql, kl, vl = _sharded.kv_heads_for("op", qd, kd, kd, hdim=1)
            qh, kh = ql.flatten().tolist(), kl.flatten().tolist()
            assert qh == list(range(rank * Hl, (rank + 1) * Hl))
            # local query head j reads local kv head j // (Hl / Kh_local),
            # which must be global kv head qh[j] // G
            per = max(Hl // len(kh), 1)
            assert [kh[j // per] for j in range(Hl)] == \
                [h // G for h in qh]
            assert torch.equal(vl, kl)
        finally:
            dist.destroy_process_group()
