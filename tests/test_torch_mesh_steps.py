"""The port's meshed step functions against the JAX package's, on the CPU:
the same reduced models on the same (1, 4) and (2, 2) meshes, at their
real shard counts.

The JAX package runs its own ``make_train_step``, ``make_prefill_step``
and ``make_serve_step`` in a subprocess with 4 forced host devices under
an Auto-axes ``jax.sharding.Mesh`` (``jax.make_mesh``'s Explicit axes
make its ``with_sharding_constraint`` raise under jax 0.9). The port runs
the same steps in 4 spawned gloo ranks over ``DeviceMesh``es of the same
shapes, on the bridged weights and the same numpy batch. Each side runs
every case once (a module fixture); the tests compare:

- one train step: the loss, the gradient norm and every parameter after
  the AdamW update;
- prefill's last-position logits and 4 decode steps' logits (the tokens
  given, not sampled);
- ``moe_apply`` alone, the expert-parallel branch: y and the aux, which
  under a mesh is the mean over the batch shards of each shard's aux (so
  not the un-meshed aux);
- ``loss_fn`` alone on vocab-sharded logits: the loss and its gradient.

Cases: reduced qwen3-4b and llama4-scout-17b-a16e at (1, 4) and (2, 2);
reduced recurrentgemma-9b with 3 layers (rec, rec, attn: MQA, its KV cache
sequence-sharded) and reduced mamba2-2.7b (its SSD scan on each rank's
shards) at (2, 2); reduced qwen3-4b with 2 kv heads at (1, 4)
(each rank's one query head reads one of two replicated kv heads).

The MoE train step is held to the reference's meshed loss, but its
gradient and update to the same arithmetic run un-meshed (each batch
shard's tokens through the single-device block, the aux the shards'
mean): the JAX package's meshed step gives the right loss and a wrong
gradient. Under its expert-parallel ``shard_map`` the cotangent of the
block's input is one model rank's share, not the sum over ranks (at
(1, 4), where the block's arithmetic is the un-meshed one, the gradient
with respect to its input is off by the size of the gradient itself,
while every weight's gradient is exact), so the reference's meshed
gradient norm misses the un-meshed one by several per cent
(``test_reference_expert_parallel_gradient_property``). The port's
meshed gradient is its un-meshed one at (1, 4).

Tolerances, as the un-meshed parity tests hold them: logits atol 5e-4;
the loss 5e-4 and the gradient norm 5e-4 of itself; a parameter after the
step within 2 lr + 2e-6 (Adam's first step moves an element by about
lr * sign(g), which may flip where g lies within rounding of zero) and
all but 1e-5 of the elements within 2e-6; the MoE block's y within 2e-5
and its aux within 1e-6; the vocab-sharded loss within 1e-5 and its
gradient within 1e-7 (its elements are at most 1 / 26, 26 labels being
valid).
"""
import datetime
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
B, S, DECODE = 4, 64, 4
#: (case, arch, mesh shape, config overrides)
CASES = [("qwen3-4b-1x4", "qwen3-4b", (1, 4), {}),
         ("qwen3-4b-2x2", "qwen3-4b", (2, 2), {}),
         ("llama4-1x4", "llama4-scout-17b-a16e", (1, 4), {}),
         ("llama4-2x2", "llama4-scout-17b-a16e", (2, 2), {}),
         ("recurrentgemma-2x2", "recurrentgemma-9b", (2, 2),
          {"num_layers": 3}),
         ("mamba2-2x2", "mamba2-2.7b", (2, 2), {}),
         ("qwen3-kh2-1x4", "qwen3-4b", (1, 4), {"num_kv_heads": 2})]
#: ``loss_fn`` alone on vocab-sharded logits [B, S, V] on these meshes
LOSS_SHAPE, LOSS_MESHES = (4, 8, 64), [(1, 4), (2, 2)]
#: (case, arch, mesh shape): moe_apply alone
MOE_CASES = [("llama4-1x4", "llama4-scout-17b-a16e", (1, 4)),
             ("llama4-2x2", "llama4-scout-17b-a16e", (2, 2)),
             ("deepseek-2x2", "deepseek-v2-236b", (2, 2))]

_REFERENCE = textwrap.dedent('''
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=4")
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from repro.config import InputShape, get_config
    from repro.launch import steps
    from repro.models import moe
    from repro.optim.adamw import adamw_init
    from repro.sharding.context import mesh_context
    from repro_torch import bridge

    d = sys.argv[1]
    with open(os.path.join(d, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    out = {}

    def expert_parallel_unmeshed(cfg, params, toks, nb):
        """The train step with no mesh and the expert-parallel block's
        arithmetic: each of the nb batch shards' tokens through the
        single-device block (its own capacity), the aux the mean of the
        shards' (jax.value_and_grad + adamw_update, as make_train_step)."""
        from repro.models import api
        from repro.optim.adamw import adamw_update

        def block(p, x, cfg):
            ys, auxs = [], []
            for xb in jnp.split(x, nb, axis=0):
                x2 = xb.reshape(-1, xb.shape[-1])
                y, aux = moe._moe_ffn_block(x2, p, cfg, 0, cfg.num_experts,
                                            p["w1"], p["w3"], p["w2"])
                if cfg.num_shared_experts:
                    y = y + moe._shared_expert(x2, p, 0,
                                               p["sh_gate"].shape[1])
                ys.append(y.reshape(xb.shape))
                auxs.append(aux)
            return jnp.concatenate(ys, axis=0), sum(auxs) / nb

        def loss(p, b, l):
            logits, aux = api.forward(p, b, cfg)
            return api.loss_fn(logits, l[:, :logits.shape[1]], aux)

        real, moe.moe_apply = moe.moe_apply, block
        try:
            lval, grads = jax.value_and_grad(loss)(
                params, jnp.asarray(toks), jnp.asarray(np.roll(toks, -1, 1)))
        finally:
            moe.moe_apply = real
        p2, _, m = adamw_update(grads, adamw_init(params), params)
        m["loss"] = lval
        return p2, m

    def mesh_of(shape):
        return jax.sharding.Mesh(
            np.array(jax.devices()[:4]).reshape(shape), ("data", "model"))

    for case, arch, shape, kw in inp["cases"]:
        cfg = dataclasses.replace(get_config(arch).reduced(), **kw)
        mesh = mesh_of(shape)
        params = jax.tree.map(jnp.asarray, inp["params"][case])
        toks = inp["tokens"][case]
        B, S = toks.shape
        with mesh:
            fn, _ = steps.make_train_step(
                cfg, mesh, InputShape("t", S, B, "train"), grad_accum=1)
            p2, _, m = fn(jax.tree.map(jnp.array, params),
                          adamw_init(params), jnp.asarray(toks),
                          jnp.asarray(np.roll(toks, -1, 1)))
            pf, _ = steps.make_prefill_step(
                cfg, mesh, InputShape("p", S, B, "prefill"))
            lg, caches = pf(params, jnp.asarray(toks))
            sv, _ = steps.make_serve_step(
                cfg, mesh, InputShape("d", S, B, "decode"))
            logits = [np.asarray(lg)]
            for i in range(inp["decode"]):
                lg, caches = sv(params, jnp.asarray(toks[:, i:i + 1]),
                                jnp.int32(S + i), caches)
                logits.append(np.asarray(lg))
        out[case] = {
            "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "lr": float(m["lr"]), "logits": logits}
        if cfg.family == "moe":
            # the meshed step's gradient with respect to the expert block's
            # input is off (see the module docstring); the gradient and
            # the update are taken from the same arithmetic un-meshed
            out[case]["meshed_grad_norm"] = out[case]["grad_norm"]
            p2, m = expert_parallel_unmeshed(cfg, params, toks, shape[0])
            out[case]["grad_norm"] = float(m["grad_norm"])
            out[case]["unmeshed_loss"] = float(m["loss"])
        out[case]["params"] = {
            k: v.numpy() for k, v in bridge.params_from_numpy(
                jax.tree.map(np.asarray, p2)).items()}
    for case, arch, shape in inp["moe_cases"]:
        cfg = get_config(arch).reduced()
        mesh = mesh_of(shape)
        p = jax.tree.map(jnp.asarray, inp["moe_params"][case])
        x = jnp.asarray(inp["moe_x"][case])
        with mesh, mesh_context(mesh):
            y, aux = jax.jit(lambda p, x: moe.moe_apply(p, x, cfg))(p, x)
        out["moe:" + case] = {"y": np.asarray(y), "aux": float(aux)}
    from repro.models import api as japi
    lg, lab = (jnp.asarray(inp["loss"][k]) for k in ("logits", "labels"))
    val, grad = jax.value_and_grad(
        lambda x: japi.loss_fn(x, lab, jnp.float32(0.5)))(lg)
    out["loss"] = {"value": float(val), "grad": np.asarray(grad)}
    with open(os.path.join(d, "reference.pkl"), "wb") as f:
        pickle.dump(out, f)
''')


def _port_worker(rank, d):
    """One of the port's 4 gloo ranks: every case's meshed steps; rank 0
    writes the results."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.config import InputShape, get_config
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import api, moe
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.sharding import specs

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(d, "store"), 4),
        rank=rank, world_size=4, timeout=datetime.timedelta(seconds=120))
    try:
        with open(os.path.join(d, "inputs.pkl"), "rb") as f:
            inp = pickle.load(f)
        out = {}
        for case, arch, shape, kw in inp["cases"]:
            cfg = dataclasses.replace(get_config(arch).reduced(), **kw)
            mesh = make_mesh(shape, ("data", "model"), "cpu")
            sd = {k: torch.from_numpy(v.copy())
                  for k, v in inp["state"][case].items()}
            toks = torch.from_numpy(inp["tokens"][case])
            Bc, Sc = toks.shape

            def fresh():
                model = api.build_params(cfg, 0, "cpu")
                model.load_state_dict(sd)
                return model

            model = fresh().requires_grad_(True)
            fn, _ = steps.make_train_step(
                cfg, mesh, InputShape("t", Sc, Bc, "train"), grad_accum=1)
            model, _, m = fn(model, adamw_init(dict(model.named_parameters())),
                             toks, torch.roll(toks, -1, 1))
            params = {n: p.detach().full_tensor()
                      for n, p in model.named_parameters()}
            pf, _ = steps.make_prefill_step(
                cfg, mesh, InputShape("p", Sc, Bc, "prefill"))
            sv, _ = steps.make_serve_step(
                cfg, mesh, InputShape("d", Sc, Bc, "decode"))
            model = fresh()
            lg, caches = pf(model, toks)
            logits = [lg.full_tensor()]
            for i in range(inp["decode"]):
                lg, caches = sv(model, toks[:, i:i + 1], Sc + i, caches)
                logits.append(lg.full_tensor())
            out[case] = {"loss": float(m["loss"]),
                         "grad_norm": float(m["grad_norm"]),
                         "params": params, "logits": logits}
        for case, arch, shape in inp["moe_cases"]:
            cfg = get_config(arch).reduced()
            mesh = make_mesh(shape, ("data", "model"), "cpu")
            p = moe.MoEFFN(moe.Maker(0, torch.float32, "cpu"), cfg)
            p.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in
                               inp["moe_state"][case].items()})
            specs.shard_model(p, mesh)
            x = torch.from_numpy(inp["moe_x"][case])
            with torch.no_grad(), steps.meshed(mesh):
                xd = specs.distribute(x, mesh, specs.P(("data",), None, None))
                y, aux = moe.moe_apply(p, xd, cfg)
                ep = mesh.shape[1] > 1 and cfg.num_experts >= mesh.shape[1]
            out["moe:" + case] = {"y": y.full_tensor(),
                                  "aux": float(aux.full_tensor()),
                                  "expert_parallel": ep}
        from torch.distributed.tensor.debug import CommDebugMode
        for shape in LOSS_MESHES:
            mesh = make_mesh(shape, ("data", "model"), "cpu")
            lg = specs.distribute(
                torch.from_numpy(inp["loss"]["logits"]), mesh,
                specs.logits_spec(mesh, *LOSS_SHAPE[::2])).requires_grad_(True)
            lab = specs.distribute(torch.from_numpy(inp["loss"]["labels"]),
                                   mesh, specs.token_spec(mesh, LOSS_SHAPE[0]))
            with CommDebugMode() as comms:
                val = api.loss_fn(lg, lab, torch.tensor(0.5))
                val.backward()
            out["loss:%dx%d" % shape] = {
                "value": float(val.detach().full_tensor()),
                "grad": lg.grad.full_tensor(),
                "placements": [[str(p) for p in x.placements]
                               for x in (lg, lg.grad)],
                "comms": {str(k): v for k, v in
                          comms.get_comm_counts().items()}}
        if rank == 0:
            torch.save(out, os.path.join(d, "port.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' results for every case: the JAX package's subprocess
    and the port's 4 ranks run at the same time."""
    import dataclasses

    import jax

    from repro.config import get_config as jget
    from repro.models import api as japi
    from repro_torch import bridge

    d = str(tmp_path_factory.mktemp("mesh_steps"))
    inp = {"cases": CASES, "moe_cases": MOE_CASES, "decode": DECODE,
           "params": {}, "state": {}, "tokens": {}, "moe_params": {},
           "moe_state": {}, "moe_x": {}}
    for i, (case, arch, _, kw) in enumerate(CASES):
        cfg = dataclasses.replace(jget(arch).reduced(), **kw)
        tree = jax.tree.map(np.asarray,
                            japi.build_params(cfg, jax.random.key(i)))
        inp["params"][case] = tree
        inp["state"][case] = {k: v.numpy() for k, v in
                              bridge.params_from_numpy(tree).items()}
        inp["tokens"][case] = np.random.default_rng(i).integers(
            0, cfg.vocab_size, (B, S)).astype(np.int32)
    for i, (case, arch, _) in enumerate(MOE_CASES):
        cfg = jget(arch).reduced()
        tree = jax.tree.map(np.asarray, japi.build_params(
            cfg, jax.random.key(100 + i)))["layers"]["moe"]
        tree = {k: v[0] for k, v in tree.items()}
        inp["moe_params"][case] = tree
        inp["moe_state"][case] = {k: v.numpy() for k, v in
                                  bridge.params_from_numpy(tree).items()}
        inp["moe_x"][case] = np.random.default_rng(100 + i).standard_normal(
            (B, 16, cfg.d_model)).astype(np.float32)
    rng = np.random.default_rng(200)
    labels = rng.integers(0, LOSS_SHAPE[2], LOSS_SHAPE[:2]).astype(np.int32)
    labels[0, :3] = labels[3, 5:] = -100
    inp["loss"] = {"logits": 3 * rng.standard_normal(LOSS_SHAPE).astype(
        np.float32), "labels": labels}
    with open(os.path.join(d, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)

    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    ref = subprocess.Popen([sys.executable, "-c", _REFERENCE, d], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        torch.multiprocessing.start_processes(
            _port_worker, args=(d,), nprocs=4, start_method="spawn")
    finally:
        log = ref.communicate(timeout=600)[0].decode()
    assert ref.returncode == 0, log[-4000:]
    with open(os.path.join(d, "reference.pkl"), "rb") as f:
        want = pickle.load(f)
    return want, torch.load(os.path.join(d, "port.pt"))


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_meshed_train_step_matches_reference(runs, case):
    want, got = runs[0][case], runs[1][case]
    assert abs(got["loss"] - want["loss"]) < 5e-4
    assert abs(got["grad_norm"] - want["grad_norm"]) < \
        5e-4 * want["grad_norm"]
    lr = want["lr"]
    flips = total = 0
    assert set(got["params"]) == set(want["params"])
    for n, w in want["params"].items():
        diff = (got["params"][n] - torch.from_numpy(w)).abs()
        assert float(diff.max()) <= 2 * lr + 2e-6, n
        flips += int((diff > 2e-6).sum())
        total += diff.numel()
    assert flips <= 1e-5 * total


@pytest.mark.parametrize("case", ["llama4-1x4", "llama4-2x2"])
def test_reference_expert_parallel_gradient_property(runs, case):
    """The JAX package's meshed MoE train step computes the loss of the
    expert-parallel arithmetic (its loss equals the un-meshed emulation's)
    but not its gradient: the block's input gradient misses the other
    model ranks' share, and the gradient norm moves by far more than
    rounding. The port holds to the arithmetic's gradient."""
    want = runs[0][case]
    assert abs(want["loss"] - want["unmeshed_loss"]) < 5e-4
    assert abs(want["meshed_grad_norm"] - want["grad_norm"]) > \
        1e-2 * want["grad_norm"]


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_meshed_prefill_and_decode_match_reference(runs, case):
    want, got = runs[0][case], runs[1][case]
    assert len(got["logits"]) == len(want["logits"]) == DECODE + 1
    for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
        assert tuple(g.shape) == w.shape == (B, 1, g.shape[-1])
        np.testing.assert_allclose(g.numpy(), w, atol=5e-4, rtol=0,
                                   err_msg=f"{case} step {i}")


@pytest.mark.parametrize("case", [c[0] for c in MOE_CASES])
def test_expert_parallel_block_matches_reference(runs, case):
    want, got = runs[0]["moe:" + case], runs[1]["moe:" + case]
    assert got["expert_parallel"]
    np.testing.assert_allclose(got["y"].numpy(), want["y"], atol=2e-5,
                               rtol=0)
    assert abs(got["aux"] - want["aux"]) < 1e-6


@pytest.mark.parametrize("shape", LOSS_MESHES)
def test_vocab_sharded_loss_matches_reference(runs, shape):
    """``loss_fn`` on vocab-sharded logits (labels partly ignored): the
    loss and its gradient as the JAX package's, the logits and their
    gradient vocab-sharded throughout, and only all-reduces (of [B, S]
    values) crossing ranks, no gather of the logits."""
    from torch.distributed.tensor import Shard
    want, got = runs[0]["loss"], runs[1]["loss:%dx%d" % shape]
    assert abs(got["value"] - want["value"]) < 1e-5
    np.testing.assert_allclose(got["grad"].numpy(), want["grad"], atol=1e-7,
                               rtol=0)
    for placements in got["placements"]:
        assert placements[1] == str(Shard(2)), placements
    assert set(got["comms"]) == {"c10d_functional.all_reduce"}, got["comms"]


# ------------------------------------------------- the (1, 1) host mesh
@pytest.fixture(scope="module")
def host_mesh():
    """The (1, 1) mesh over a world-1 gloo group, on one CPU thread: the
    embedding lookup's backward (index_put_ with accumulate) sums a
    repeated token's rows in the order the threads take them, so two
    un-meshed runs on several threads differ in the last bits of the
    embedding's gradient; on one they repeat, and the meshed run must
    equal them."""
    from repro_torch.launch.mesh import destroy_host_group, make_host_mesh
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield make_host_mesh("cpu")
    finally:
        torch.set_num_threads(threads)
        destroy_host_group()


def _host_case(arch):
    import dataclasses

    from repro_torch.config import get_config
    cfg = get_config(arch).reduced()
    if arch == "recurrentgemma-9b":
        cfg = dataclasses.replace(cfg, num_layers=3)
    return cfg


@pytest.mark.parametrize("arch", ["qwen3-4b", "llama4-scout-17b-a16e",
                                  "recurrentgemma-9b"])
def test_host_mesh_train_step_is_the_unmeshed_step_bit_for_bit(host_mesh,
                                                              arch):
    """On the (1, 1) mesh every shard is the whole tensor and every
    collective moves nothing: the meshed step (DTensor dispatch, the
    model's constraints, the MoE block's single-device branch) gives the
    un-meshed step's loss and parameters bit for bit."""
    from repro_torch.config import InputShape
    from repro_torch.launch import steps
    from repro_torch.models import api, moe
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.sharding.specs import unshard_model

    cfg = _host_case(arch)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int32))
    out = {}
    for mesh in (None, host_mesh):
        model = api.build_params(cfg, 0, "cpu").requires_grad_(True)
        fn, _ = steps.make_train_step(cfg, mesh,
                                      InputShape("t", 64, 2, "train"),
                                      grad_accum=1)

        def refuse(*a, **k):
            raise AssertionError("ep = 1 takes the single-device branch")
        real, moe._expert_parallel_block = moe._expert_parallel_block, refuse
        try:
            model, _, m = fn(model, adamw_init(dict(model.named_parameters())),
                             toks, torch.roll(toks, -1, 1))
        finally:
            moe._expert_parallel_block = real
        out[mesh is None] = (m, dict(unshard_model(model).named_parameters()))
    (m0, p0), (m1, p1) = out[True], out[False]
    assert torch.equal(m0["loss"], m1["loss"])
    assert torch.equal(m0["grad_norm"], m1["grad_norm"])
    for n in p0:
        assert torch.equal(p0[n], p1[n]), n


@pytest.mark.parametrize("arch", ["qwen3-4b", "llama4-scout-17b-a16e",
                                  "recurrentgemma-9b"])
def test_host_mesh_prefill_and_decode_are_the_unmeshed_ones_bit_for_bit(
        host_mesh, arch):
    from torch.distributed.tensor import DTensor

    from repro_torch.config import InputShape
    from repro_torch.launch import steps
    from repro_torch.models import api

    cfg = _host_case(arch)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int32))
    out = {}
    for mesh in (None, host_mesh):
        model = api.build_params(cfg, 0, "cpu")
        pf, _ = steps.make_prefill_step(cfg, mesh,
                                        InputShape("p", 64, 2, "prefill"))
        sv, _ = steps.make_serve_step(cfg, mesh,
                                      InputShape("d", 64, 2, "decode"))
        lg, caches = pf(model, toks)
        logits = [lg]
        for i in range(3):
            lg, caches = sv(model, toks[:, i:i + 1], 64 + i, caches)
            logits.append(lg)
        assert all(isinstance(x, DTensor) == (mesh is not None)
                   for x in logits)
        out[mesh is None] = [x.full_tensor() if isinstance(x, DTensor)
                             else x for x in logits]
    for a, b in zip(out[True], out[False]):
        assert torch.equal(a, b)


def test_train_on_a_one_device_mesh_runs_the_unmeshed_step(host_mesh):
    """``train`` on the (1, 1) mesh takes the un-meshed step, which gives
    the meshed step's bits there without DTensor's dispatch: the losses
    equal those of ``train`` with no mesh, and every step sees plain
    parameters."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch import train
    from repro_torch.models import api

    cfg = _host_case("qwen3-4b")
    out = {}
    for mesh in (None, host_mesh):
        model = api.build_params(cfg, 0, "cpu")
        seen = []
        out[mesh is None] = train.train(
            "qwen3-4b", steps=2, batch=2, seq=32, log_every=10,
            device="cpu", model=model, mesh=mesh,
            on_step=lambda step, m: seen.append(any(
                isinstance(p, DTensor) for p in model.parameters())))
        assert seen == [False, False]
    assert out[True] == out[False]
