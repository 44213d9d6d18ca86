"""The port's ``ServeEngine`` against the JAX ``ServeEngine`` on the same
seeded agents with bridged parameters (reduced granite-3-2b and reduced
xlstm-350m, float32, CPU).

Compared exactly: the fields of ``BENCH_engine.json``'s oracle
(completions, clock, tokens, prefills, swaps, decode steps) and the full
listener event streams with token values dropped.  Sampled token ids are
reported as a match rate, not gated exactly: float32 logits from XLA and
PyTorch differ in the last bits, which can flip the argmax of a near-tie.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import InferenceSpec, agent_cost, make_scheduler
from repro.engine import EngineAgent as JaxAgent
from repro.engine import ServeEngine as JaxEngine
from repro.models import Model as JaxModel
from repro_torch.configs import get_config as torch_get_config
from repro_torch.core import make_scheduler as torch_make_scheduler
from repro_torch.engine import EngineAgent, ServeEngine
from repro_torch.models import Model
from repro_torch.models.params import params_from_jax

VOCAB = 256
ORACLE_KEYS = ("tokens", "prefills", "swaps", "decode_steps")
#: floor on the sampled-token match rate (a sanity bound, not a gate)
MIN_TOKEN_MATCH = 0.9


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny tensors: one intra-op thread per test worker is faster and
    keeps the workers from oversubscribing the cores.  Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines():
    jm = JaxModel(get_config("granite-3-2b").reduced(vocab=VOCAB))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(torch_get_config("granite-3-2b").reduced(vocab=VOCAB),
               device="cpu", debug_checks=True)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return {
        "jax": (JaxEngine, JaxAgent, make_scheduler, jm, jp, {}),
        "torch": (ServeEngine, EngineAgent, torch_make_scheduler, tm, tp,
                  {"device": "cpu"}),
    }


def synth_agents(agent_cls, seed, n, closed_loop=False, lengths=None):
    """Seeded task-parallel agents: 1-2 stages x 1-2 inferences each;
    prompts of 8-39 tokens, or drawn from ``lengths``."""
    rng = np.random.default_rng(seed)
    agents = []
    for i in range(n):
        stages, specs = [], []
        for _ in range(1 + int(rng.integers(0, 2))):
            stage = []
            for _ in range(1 + int(rng.integers(0, 2))):
                if lengths is None:
                    p = int(rng.integers(8, 40))
                else:
                    p = int(lengths[rng.integers(len(lengths))])
                d = int(rng.integers(16, 48))
                stage.append((rng.integers(0, VOCAB, size=p), d))
                specs.append(InferenceSpec(p, d))
            stages.append(stage)
        agents.append(agent_cls(i, int(rng.integers(0, 3 * n)), stages,
                                agent_cost(specs), closed_loop=closed_loop))
    return agents


class Recorder:
    """Records every lifecycle callback; token values kept aside.

    ``follow_ups`` maps (agent, finished stage) to a (prompt, d, delay)
    follow-up that the stage callback appends with a resume delay — a
    closed-loop client with think time.
    """

    def __init__(self, follow_ups=None):
        self.events, self.tokens = [], []
        self.follow_ups = follow_ups or {}
        self.engine = None

    def __getattr__(self, name):
        if not name.startswith("on_"):
            raise AttributeError(name)

        def note(*args):
            if name == "on_token":
                self.tokens.append(args[2])
                args = args[:2] + (None,) + args[3:]
            self.events.append((name, *args))
            if name == "on_stage_complete":
                nxt = self.follow_ups.get((args[0], args[1]))
                if nxt is not None:
                    prompt, d, delay = nxt
                    self.engine.append_stage(args[0], [(prompt, d)],
                                             resume_delay=delay)

        return note


def run_both(engines, sched, n_agents=6, seed=7, follow_ups=None,
             closed_loop=False, lengths=None, **kw):
    kw.setdefault("pool_tokens", 4096)
    kw.setdefault("max_batch", 4)
    kw.setdefault("cache_len", 96)
    out = {}
    for name, (eng_cls, agent_cls, mk, model, params, extra) in engines.items():
        rec = Recorder(follow_ups)
        eng = eng_cls(model, params, mk(sched, float(kw["pool_tokens"])),
                      listener=rec, **kw, **extra)
        rec.engine = eng
        for a in synth_agents(agent_cls, seed, n_agents, closed_loop,
                              lengths):
            eng.submit_agent(a)
        eng.run_until_idle()
        eng.alloc.check_invariants()
        out[name] = (
            {"completions": dict(eng.completions), "now": eng.now,
             **{k: eng.metrics[k] for k in ORACLE_KEYS}},
            rec, eng,
        )
    return out["jax"], out["torch"]


def assert_same(jax_run, torch_run):
    (oj, rj, _), (ot, rt, _) = jax_run, torch_run
    assert ot == oj
    assert rt.events == rj.events
    assert len(rt.tokens) == len(rj.tokens) == oj["tokens"]
    match = float(np.mean(np.array(rt.tokens) == np.array(rj.tokens)))
    assert match >= MIN_TOKEN_MATCH, f"token match rate {match:.3f}"


@pytest.mark.parametrize("sched,pool", [
    ("justitia", 4096),
    ("justitia", 256),
    ("vtc", 4096),
    ("vtc", 256),
    ("vllm-fcfs", 256),
])
def test_engine_matches_jax(engines, sched, pool):
    jax_run, torch_run = run_both(engines, sched, pool_tokens=pool)
    assert_same(jax_run, torch_run)
    if pool == 256:
        assert jax_run[0]["swaps"] > 0, "pool 256 must force swaps"


@pytest.mark.parametrize("sched,pool", [("justitia", 4096), ("vtc", 256)])
def test_engine_matches_jax_at_cache_len_100(engines, sched, pool):
    """A cache length that the 16-token decode page does not divide: the
    port decodes over pages of 10 tokens and serves as the JAX engine
    does."""
    jax_run, torch_run = run_both(engines, sched, pool_tokens=pool,
                                  cache_len=100)
    assert_same(jax_run, torch_run)
    assert torch_run[2].cache["k"].shape[2] == 100
    if pool == 256:
        assert jax_run[0]["swaps"] > 0, "pool 256 must force swaps"


def test_engine_watermark_matches_jax(engines):
    jax_run, torch_run = run_both(engines, "justitia", n_agents=8,
                                  pool_tokens=512,
                                  admission_watermark=(0.2, 0.4))
    assert_same(jax_run, torch_run)
    assert jax_run[2].metrics["admission_deferrals"] > 0


@pytest.mark.parametrize("retention", ["hold", "spill"])
def test_engine_suspension_matches_jax(engines, retention):
    """Closed-loop agents appending a follow-up stage with think time: the
    agents suspend, hold or spill their KV, and resume identically."""
    rng = np.random.default_rng(11)
    follow_ups = {
        (aid, stage): (rng.integers(0, VOCAB, size=12), 20, 5 + 3 * aid)
        for aid in range(4) for stage in (0, 1)
    }
    jax_run, torch_run = run_both(
        engines, "justitia", n_agents=4, follow_ups=follow_ups,
        closed_loop=True, pool_tokens=384, suspend_retention=retention,
    )
    assert_same(jax_run, torch_run)
    assert torch_run[2].metrics["suspensions"] > 0
    assert torch_run[2].metrics["resumes"] == \
        torch_run[2].metrics["suspensions"]


@pytest.mark.parametrize("flag", ["prefix_cache", "fused_prefill"])
def test_unported_flags_raise(engines, flag):
    _, _, mk, model, params, extra = engines["torch"]
    with pytest.raises(NotImplementedError, match="not ported"):
        ServeEngine(model, params, mk("justitia", 4096.0), **{flag: True},
                    **extra)


# ------------------------------------------------------------------- xLSTM

#: prompt lengths of the xLSTM runs: each distinct length is one JAX
#: compilation of the exact-length prefill; 37 and 100 are ragged in the
#: port's 64-token mLSTM chunks
XLSTM_LENGTHS = (37, 64, 100)


@pytest.fixture(scope="module")
def xlstm_engines():
    over = dict(vocab=VOCAB, n_layers=4)
    jm = JaxModel(get_config("xlstm-350m").reduced(**over))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(torch_get_config("xlstm-350m").reduced(**over), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return {
        "jax": (JaxEngine, JaxAgent, make_scheduler, jm, jp, {}),
        "torch": (ServeEngine, EngineAgent, torch_make_scheduler, tm, tp,
                  {"device": "cpu"}),
    }


@pytest.mark.parametrize("sched,pool", [
    ("justitia", 4096),
    ("vtc", 256),
    ("vllm-fcfs", 4096),
])
def test_xlstm_engine_matches_jax(xlstm_engines, sched, pool):
    """Recurrent state served one exact-length prefill at a time: equal
    completions, clock, counters and event streams, every sampled token
    equal; pool 256 swaps the state out to the host and back."""
    jax_run, torch_run = run_both(xlstm_engines, sched, n_agents=5,
                                  lengths=XLSTM_LENGTHS, pool_tokens=pool,
                                  cache_len=160)
    assert_same(jax_run, torch_run)
    assert torch_run[1].tokens == jax_run[1].tokens
    if pool == 256:
        assert jax_run[0]["swaps"] > 0, "pool 256 must force swaps"
