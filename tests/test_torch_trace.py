"""The serving engine's own spans (``repro_torch.trace``): how they nest,
that they add up to the engine's counters, that calls outside an engine
step leave none, the bounded buffer, and that recording changes nothing
the engine serves.  CPU, reduced granite-3-2b and h2o-danube-1.8b (sliding
window), float32."""

import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.api import AgentService, AgentSpec, EngineBackend
from repro_torch.configs import get_config
from repro_torch.core import make_scheduler
from repro_torch.core.cost import InferenceSpec, agent_cost
from repro_torch.engine import EngineAgent, ServeEngine
from repro_torch.engine import engine as engine_mod
from repro_torch.models import Model

VOCAB = 256
#: engine arguments of each case; ``window`` serves the sliding-window
#: model (window 64 in a 96-row ring), the others reduced granite
CASES = {
    "plain": {"pool_tokens": 4096},
    "swaps": {"pool_tokens": 128},
    "fused": {"pool_tokens": 4096, "fused_prefill": True},
    "window": {"pool_tokens": 4096},
}
PARENTS = {"step": None, "prefill": "step", "decode": "step",
           "decode.replay": "decode"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ("granite-3-2b", "h2o-danube-1.8b"):
        model = Model(get_config(arch).reduced(vocab=VOCAB), device="cpu")
        out[arch] = (model, model.init(0))
    return out


def synth_agents(seed, n=6):
    """Seeded agents of 1-2 stages x 1-2 inferences (prompts 8-39 tokens,
    16-47 decoded), some arriving later than iteration 0."""
    rng = np.random.default_rng(seed)
    agents = []
    for i in range(n):
        stages, specs = [], []
        for _ in range(1 + int(rng.integers(0, 2))):
            stage = []
            for _ in range(1 + int(rng.integers(0, 2))):
                p, d = int(rng.integers(8, 40)), int(rng.integers(16, 48))
                stage.append((rng.integers(0, VOCAB, size=p), d))
                specs.append(InferenceSpec(p, d))
            stages.append(stage)
        agents.append(EngineAgent(i, int(rng.integers(0, 3 * n)), stages,
                                  agent_cost(specs)))
    return agents


class Listener:
    """Every lifecycle callback, in order."""

    def __init__(self):
        self.events = []

    def __getattr__(self, name):
        if not name.startswith("on_"):
            raise AttributeError(name)
        return lambda *args: self.events.append((name, *args))


class NullRecorder:
    """Records nothing: each span it gives has no recorder."""

    def span(self, name, **attrs):
        return trace.Span(None, name, -1, attrs)

    child = span


def serve(models, case, recorder=None, seed=3):
    kw = dict(CASES[case])
    arch = "h2o-danube-1.8b" if case == "window" else "granite-3-2b"
    model, params = models[arch]
    listener = Listener()
    eng = ServeEngine(model, params,
                      make_scheduler("justitia", float(kw["pool_tokens"])),
                      max_batch=4, cache_len=96, prefill_chunk=32,
                      listener=listener, device="cpu", **kw)
    if recorder is not None:
        eng.trace = recorder
    agents = synth_agents(seed)
    for a in agents:
        eng.submit_agent(a)
    eng.run_until_idle()
    return eng, listener, agents


@pytest.fixture(scope="module")
def runs(models):
    return {case: serve(models, case) for case in CASES}


def by_id(eng):
    return {s.id: s for s in eng.trace.spans}


@pytest.mark.parametrize("case", list(CASES))
def test_spans_nest_as_the_engine_calls_its_layers(runs, case):
    eng, _, _ = runs[case]
    spans = by_id(eng)
    names = {s.name for s in spans.values()}
    want = set(PARENTS) - ({"prefill"} if case == "fused" else set())
    assert names == want
    for s in spans.values():
        parent = spans.get(s.parent)
        assert (parent.name if parent else None) == PARENTS[s.name], s
    children = {}
    for s in spans.values():
        children.setdefault(s.parent, []).append(s.name)
    for s in spans.values():
        kids = sorted(children.get(s.id, []))
        if s.name == "step":
            assert set(kids) <= {"prefill", "decode"}
            assert kids.count("decode") <= 1
        elif s.name == "decode" and s.attrs["k"]:
            assert kids == ["decode.replay"]


@pytest.mark.parametrize("case", list(CASES))
def test_stamps_are_monotone_and_children_lie_inside_parents(runs, case):
    eng, _, _ = runs[case]
    spans = by_id(eng)
    ordered = [spans[i] for i in sorted(spans)]
    assert [s.id for s in ordered] == list(range(len(ordered)))
    starts = [s.start for s in ordered]
    assert starts == sorted(starts)
    for s in ordered:
        assert 0 < s.start <= s.end
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start <= s.start and s.end <= p.end
    steps = [s for s in ordered if s.name == "step"]
    assert all(a.end <= b.start for a, b in zip(steps, steps[1:]))


@pytest.mark.parametrize("case", list(CASES))
def test_spans_add_up_to_the_engine_counters(runs, case):
    eng, _, _ = runs[case]
    spans = list(eng.trace.spans)
    decode = [s for s in spans if s.name == "decode"]
    prefill = [s for s in spans if s.name == "prefill"]
    m = eng.metrics
    assert sum(s.attrs["k"] for s in decode) == m["decode_steps"]
    assert sum(s.attrs["tokens"] for s in decode) == m["tokens"]
    if case == "fused":
        assert not prefill and m["prefills"] > 0
    else:
        assert sum(len(s.attrs["lens"]) for s in prefill) == m["prefills"]
        for s in prefill:
            a = s.attrs
            assert len(a["lens"]) <= a["padded"]
            assert a["padded"] & (a["padded"] - 1) == 0
            assert max(a["lens"]) <= a["bucket"] and a["bucket"] % 64 == 0
    if case == "swaps":
        assert m["swaps"] > 0


@pytest.mark.parametrize("case", list(CASES))
def test_decode_keys_sum_each_tokens_context(runs, case):
    """``keys``: each decoded token's context, clipped to the model's
    window."""
    eng, listener, agents = runs[case]
    decode = [s for s in eng.trace.spans if s.name == "decode"]
    # an agent's requests take consecutive rids, stage by stage, in order
    rids = {}
    for ev in listener.events:
        if ev[0] == "on_admit":
            rids.setdefault(ev[1], set()).add(ev[2])
    prompt = {rid: len(p) for a in agents
              for rid, (p, _) in zip(sorted(rids[a.agent_id]),
                                     (x for st in a.stages for x in st))}
    assert len(prompt) == sum(len(st) for a in agents for st in a.stages)
    window = eng.model.cfg.sliding_window or eng.cache_len
    seen, keys = {}, 0
    for ev in listener.events:
        if ev[0] == "on_token":
            rid = ev[2]
            seen[rid] = seen.get(rid, 0) + 1
            keys += min(prompt[rid] + seen[rid], window)
    assert sum(s.attrs["keys"] for s in decode) == keys
    if case == "window":
        assert max(prompt[r] + n for r, n in seen.items()) > window


def test_calls_outside_a_step_leave_no_span(models):
    model, params = models["granite-3-2b"]
    eng = ServeEngine(model, params, make_scheduler("justitia", 4096.0),
                      max_batch=4, cache_len=96, device="cpu")
    engine_mod._prefill_write(
        model, eng.cache_len, 32, params, eng.cache,
        torch.zeros((2, 64), dtype=torch.int32),
        torch.full((2,), 64, dtype=torch.int32), np.full(2, 4, np.int32))
    state = torch.zeros((3, 4), dtype=torch.int32)
    engine_mod._decode_window(model, 2, params, eng.cache, state)
    with eng.trace.child("prefill") as span:
        pass
    assert span.recorder is None and span.start <= span.end
    eng._admit()
    eng._decode_once()
    assert not eng.trace.spans and eng.trace.open is None


def test_the_buffers_drop_their_oldest_records_at_the_cap(monkeypatch):
    monkeypatch.setattr(trace, "CAPACITY", 4)
    rec = trace.Recorder()
    for i in range(6):
        with rec.span("step", i=i):
            with rec.child("decode"):
                pass
    assert len(rec.spans) == 4
    assert [(s.name, s.id, s.parent) for s in rec.spans] == [
        ("decode", 9, 8), ("step", 8, -1), ("decode", 11, 10),
        ("step", 10, -1)]
    assert rec.spans[1].attrs == {"i": 4}


def test_a_span_that_raises_closes_and_reopens_its_parent():
    rec = trace.Recorder()
    with rec.span("step") as step:
        with pytest.raises(ValueError):
            with rec.child("decode"):
                raise ValueError
        assert rec.open is step
        with rec.child("prefill") as pf:
            pass
    assert rec.open is None
    assert [(s.name, s.parent) for s in rec.spans] == [
        ("decode", step.id), ("prefill", step.id), ("step", -1)]
    assert pf.id == 2


@pytest.mark.parametrize("case", list(CASES))
def test_recording_changes_nothing_served(models, runs, case):
    eng, listener, _ = runs[case]
    null, null_listener, _ = serve(models, case, NullRecorder())
    assert null.completions == eng.completions
    assert null.now == eng.now
    assert null.metrics == eng.metrics
    assert null_listener.events == listener.events


def test_engine_backend_records_each_agents_requests(models):
    model, params = models["granite-3-2b"]
    backend = EngineBackend(model, params, "justitia", pool_tokens=4096,
                            max_batch=4, cache_len=96, prefill_chunk=32)
    service = AgentService(backend, record_events=False)
    rng = np.random.default_rng(5)
    want = {}
    for _ in range(5):
        stages = [[InferenceSpec(int(rng.integers(8, 40)),
                                 int(rng.integers(4, 20)))
                   for _ in range(1 + int(rng.integers(0, 3)))]
                  for _ in range(2)]
        handle = service.submit(AgentSpec(stages=stages))
        want[handle.agent_id] = sum(len(s) for s in stages)
    service.drain()
    eng = backend.engine
    spans = list(eng.trace.spans)
    assert spans and eng.trace.open is None
    assert sum(s.attrs["k"] for s in spans
               if s.name == "decode") == eng.metrics["decode_steps"]
    assert sum(s.attrs["tokens"] for s in spans
               if s.name == "decode") == eng.metrics["tokens"]
    assert sum(len(s.attrs["lens"]) for s in spans
               if s.name == "prefill") == eng.metrics["prefills"]
    assert eng.metrics["prefills"] == sum(want.values())
