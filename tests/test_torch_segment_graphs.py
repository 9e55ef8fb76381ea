"""The segments' CUDA graphs (``repro_torch.models.graphs``).

On the CPU: every family's segments run their bodies eagerly and capture
nothing; the launch-delta bookkeeping (``kernels._launches``) and the
replay path (copy in, replay, copy out) with a stand-in graph. On the
card (``-m cuda``): a replay equals the eager segment bit for bit for
every segment kind of the benchmark's four models and of the hybrid,
encoder-decoder, MoE and VLM families, interleaved requests each get
their own answer, a second input signature captures a second graph, and
flash's launch counts after replays equal the eager path's.
"""
import collections
import threading

import pytest

torch = pytest.importorskip("torch")

from repro_torch import spans  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.kernels import _launches  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.models import api, graphs  # noqa: E402
from repro_torch.models.segmentation import SegmentedService  # noqa: E402

#: one reduced model of each family, and the prompt length it serves
FAMILIES = {"qwen3-4b": 24, "llava-next-mistral-7b": 24, "mamba2-2.7b": 64,
            "llama4-scout-17b-a16e": 24, "recurrentgemma-9b": 24,
            "seamless-m4t-medium": 24}
#: the benchmark's four models, widths kept, two layers, at their cells'
#: shapes (batch, prompt)
SERVED = {"stablelm-1.6b": (2, 1024), "h2o-danube-3-4b": (4, 128),
          "qwen3-4b": (2, 1024), "mamba2-2.7b": (2, 2048)}


@pytest.fixture(autouse=True)
def _issued_slot_emptied():
    """Segments called here, outside an engine, stamp this thread's
    ``spans`` issued slot: leave it empty for the next test."""
    yield
    spans.take_issued(0.0)


def _service(name, device, seq, batch=2, reduced=True):
    cfg = get_config(name)
    cfg = cfg.reduced() if reduced else cfg.replace(num_layers=2)
    if device != "cpu" and reduced:
        cfg = cfg.replace(dtype="bfloat16")
    model = api.build_params(cfg, seed=3, device=device)
    return SegmentedService(cfg, model, batch=batch, seq=seq)


def _chain(svc, state, call):
    """Each segment's output, ``call(segment, state)`` over the chain."""
    outs = []
    for seg in svc.segments:
        state = call(seg, state)
        outs.append(state)
    return outs


def _equal(a, b) -> bool:
    if isinstance(a, tuple):
        return all(_equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def _diff(a, b) -> float:
    if isinstance(a, tuple):
        return max(_diff(x, y) for x, y in zip(a, b))
    return float((a.float() - b.float()).abs().max())


# ------------------------------------------------------------------ CPU
@pytest.mark.parametrize("name", list(FAMILIES))
def test_cpu_segments_run_their_bodies_eagerly(name):
    """On the CPU a segment is its body under inference mode, bit for bit,
    and no graph is captured or replayed."""
    svc = _service(name, "cpu", FAMILIES[name])
    before = spans.graph_counts()
    state = svc.make_input()
    for seg in svc.segments:
        call = seg.fn
        with torch.inference_mode():
            x = state if call.pick is None else call.pick(state)
            want = call.graphed.body(x)
        got = call(state)
        assert _equal(got, want), seg.name
        assert _equal(call.eager(state), want), seg.name
        assert call.graphed.captured == {}
        state = got
    assert spans.graph_counts() == before


class _Owner:
    """Stands in for a kernel wrapper's counters."""

    def __init__(self):
        self.launches = 0
        self.launches_by_shape = collections.Counter()


def test_recording_keeps_a_capture_out_of_the_counters():
    owner = _Owner()
    _launches.bump(owner, "launches")
    with _launches.recording() as delta:
        _launches.bump(owner, "launches", 2)
        _launches.bump(owner, "launches_by_shape", key=(1, 2))
        with _launches.recording() as inner:
            _launches.bump(owner, "launches")
        assert inner[(owner, "launches", None)] == 1
    assert owner.launches == 1 and not owner.launches_by_shape
    assert delta == {(owner, "launches", None): 2,
                     (owner, "launches_by_shape", (1, 2)): 1}
    for _ in range(3):
        _launches.add(delta)
    assert owner.launches == 7 and owner.launches_by_shape[(1, 2)] == 3


def test_recording_is_the_calling_threads_alone():
    """Another thread's launches during a capture land on the counters,
    none in the capture's delta, none lost."""
    owner, n, threads = _Owner(), 2000, 8
    started = threading.Barrier(threads + 1)

    def other():
        started.wait(timeout=30)
        for _ in range(n):
            _launches.bump(owner, "launches")
    workers = [threading.Thread(target=other) for _ in range(threads)]
    for w in workers:
        w.start()
    with _launches.recording() as delta:
        started.wait(timeout=30)
        for _ in range(n):
            _launches.bump(owner, "launches", 3)
    for w in workers:
        w.join(timeout=60)
        assert not w.is_alive()
    assert owner.launches == threads * n
    assert delta == {(owner, "launches", None): 3 * n}


class _StandInGraph:
    """A graph stand-in: a replay runs the body over the static inputs and
    writes the static outputs in place, as a CUDA graph's replay does, and
    like it counts no launch."""

    def __init__(self, body, static, static_out):
        self.body, self.static, self.static_out = body, static, static_out
        self.replays = 0

    def replay(self):
        self.replays += 1
        with _launches.recording():
            out = self.body(self.static)
        pairs = (zip(self.static_out, out) if isinstance(out, tuple)
                 else [(self.static_out, out)])
        for buf, y in pairs:
            if buf is not y:
                buf.copy_(y)


class _StandInGraphs(graphs.SegmentGraphs):
    """``SegmentGraphs`` with the capture of ``capture`` and a stand-in
    graph, so that the bookkeeping around it runs on the CPU."""

    def capture(self, body, state, sig):
        leaves = graphs._leaves(state)
        static_in = tuple(x.clone() for x in leaves)
        static = static_in if isinstance(state, tuple) else static_in[0]
        body(static)
        with _launches.recording() as launches:
            out = body(static)
        spans.count_graph("captured")
        return graphs.Captured(_StandInGraph(body, static, out), static_in,
                               out, launches)


def test_replay_bookkeeping_on_the_cpu(monkeypatch):
    """A signature's first call captures (counted eager, its launches once),
    later calls replay (each books the capture's launches), a second
    signature captures again, interleaved calls each get their own answer
    out of the shared static outputs, and an output that is an input
    buffer comes back as the caller's own tensor."""
    monkeypatch.setattr(graphs.Graphed, "_on_device",
                        staticmethod(lambda x: True))
    owner = _Owner()

    def body(state):
        enc, x = state
        _launches.bump(owner, "launches")
        return enc, x * 2 + enc.sum()

    g = graphs.Graphed(body, _StandInGraphs())
    before = spans.graph_counts()
    enc = torch.ones(3)
    a, b = torch.arange(3.0), torch.arange(3.0) + 10
    ya = g((enc, a))
    yb = g((enc, b))
    ya2 = g((enc, ya[1]))
    assert ya[0] is enc and yb[0] is enc
    assert torch.equal(ya[1], a * 2 + 3) and torch.equal(yb[1], b * 2 + 3)
    assert torch.equal(ya2[1], (a * 2 + 3) * 2 + 3)
    cap, = g.captured.values()
    assert yb[1] is not cap.static_out[1] and cap.graph.replays == 3
    assert owner.launches == 3
    g((torch.ones(2), torch.zeros(2)))
    assert len(g.captured) == 2 and owner.launches == 4
    after = spans.graph_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "captured": 2, "replayed": 2, "eager": 2}


# ----------------------------------------------------------------- card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    return torch.device("cuda")


def _eager_and_replayed(svc, state):
    eager = _chain(svc, state, lambda seg, s: seg.fn.eager(s))
    replayed = _chain(svc, state, lambda seg, s: seg.fn(s))
    again = _chain(svc, state, lambda seg, s: seg.fn(s))
    return eager, replayed, again


def _assert_bitwise(svc, eager, *runs):
    for run in runs:
        for seg, e, r in zip(svc.segments, eager, run):
            assert _equal(e, r), (f"{seg.name}: replay differs from eager "
                                  f"by {_diff(e, r)}")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SERVED))
def test_replay_equals_eager_on_the_served_models(name, cuda_device):
    """Every segment kind of the benchmark's models at full width (two
    layers), at its cell's shape: the capturing call and a replay equal
    the eager segment bit for bit."""
    batch, seq = SERVED[name]
    svc = _service(name, cuda_device, seq, batch=batch, reduced=False)
    before = spans.graph_counts()
    eager, replayed, again = _eager_and_replayed(svc, svc.make_input())
    _assert_bitwise(svc, eager, replayed, again)
    after = spans.graph_counts()
    n = len(svc.segments)
    assert {k: after[k] - before[k] for k in after} == {
        "captured": n, "replayed": n, "eager": n}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["recurrentgemma-9b", "seamless-m4t-medium",
                                  "llama4-scout-17b-a16e",
                                  "llava-next-mistral-7b", "mamba2-2.7b"])
def test_replay_equals_eager_in_every_family(name, cuda_device):
    """The hybrid (rglru's programmatic dependent launch), the
    encoder-decoder, the MoE (fixed-capacity dispatch), the VLM and the
    SSM, reduced in bf16: replay equals eager bit for bit."""
    svc = _service(name, cuda_device, FAMILIES[name])
    _assert_bitwise(svc, *_eager_and_replayed(svc, svc.make_input()))


@pytest.mark.cuda
def test_interleaved_requests_get_their_own_answers(cuda_device):
    """Two requests through one service, layer by layer in turns: each
    gets its own eager answer (the outputs are copied out of the pool)."""
    svc = _service("qwen3-4b", cuda_device, 64)
    g = torch.Generator(device=cuda_device)
    inputs = [svc.make_input(g.manual_seed(s)) for s in (1, 2)]
    want = [_chain(svc, x, lambda seg, s: seg.fn.eager(s))[-1]
            for x in inputs]
    states = list(inputs)
    for seg in svc.segments:
        states = [seg.fn(s) for s in states]
    for got, w in zip(states, want):
        assert torch.equal(got, w)
    assert not torch.equal(states[0], states[1])


@pytest.mark.cuda
def test_a_second_signature_captures_a_second_graph(cuda_device):
    svc = _service("qwen3-4b", cuda_device, 32)
    layer = svc.segments[1].fn
    for batch in (2, 1, 2):
        x = torch.randn(batch, 32, svc.cfg.d_model, device=cuda_device,
                        dtype=torch.bfloat16)
        assert torch.equal(layer(x), layer.eager(x))
    assert len(layer.graphed.captured) == 2


@pytest.mark.cuda
def test_flash_launches_after_replays_equal_the_eager_count(cuda_device):
    svc = _service("qwen3-4b", cuda_device, 64)
    fa = flash_ops.flash_attention
    x, n = svc.make_input(), 4

    def count(call):
        fa.launches = 0
        fa.launches_by_shape.clear()
        for _ in range(n):
            _chain(svc, x, call)
        return fa.launches, dict(fa.launches_by_shape)
    eager = count(lambda seg, s: seg.fn.eager(s))
    assert eager[0] == n * svc.cfg.num_layers
    assert count(lambda seg, s: seg.fn(s)) == eager    # capture, replays
    assert count(lambda seg, s: seg.fn(s)) == eager    # replays alone
