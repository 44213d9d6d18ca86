"""The port's prefix-cache engine (``ServeEngine(prefix_cache=True)``, the
unfused admission) against the JAX one on the same seeded agents with
bridged parameters (reduced granite-3-2b and reduced xlstm-350m, float32,
CPU, ``Model(debug_checks=True)`` for granite).

The agents share block-aligned prompt heads (``chip_smoke``'s
``shared_prefix_agents``), so the cache hits.  Compared exactly: the
completions, the clock, every engine counter (``prefix_hits`` and
``prefill_tokens_saved`` among them), the per-agent hit fractions, every
listener event (``on_prefix_hit`` among them; token values set aside) and
every sampled token.  Also through ``service_for_backend("engine", ...,
prefix_cache=True)`` on the closed-loop workload, fused prefill off and
on.
"""

import jax
import numpy as np
import pytest
import torch

from repro import api as jax_api
from repro.configs import get_config
from repro.core import InferenceSpec, agent_cost, make_scheduler
from repro.engine import EngineAgent as JaxAgent
from repro.engine import ServeEngine as JaxEngine
from repro.models import Model as JaxModel
from repro_torch import api
from repro_torch.configs import get_config as torch_get_config
from repro_torch.core import InferenceSpec as TorchSpec
from repro_torch.core import agent_cost as torch_agent_cost
from repro_torch.core import make_scheduler as torch_make_scheduler
from repro_torch.engine import EngineAgent, ServeEngine
from repro_torch.models import Model
from repro_torch.models.params import params_from_jax
from test_torch_api import smoke
from test_torch_engine import Recorder

VOCAB = 256


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny tensors: one intra-op thread per test worker is faster and
    keeps the workers from oversubscribing the cores.  Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bridged_engines(arch: str, **over) -> dict:
    """Per side: the engine class, the agent classes ``(agent_cls, spec,
    cost)``, the scheduler factory, the model, its parameters and the
    engine's extra arguments."""
    jm = JaxModel(get_config(arch).reduced(**over))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(torch_get_config(arch).reduced(**over), device="cpu",
               debug_checks=torch_get_config(arch).kind in ("dense", "moe",
                                                           "vlm"))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return {
        "jax": (JaxEngine, (JaxAgent, InferenceSpec, agent_cost),
                make_scheduler, jm, jp, {}),
        "torch": (ServeEngine, (EngineAgent, TorchSpec, torch_agent_cost),
                  torch_make_scheduler, tm, tp, {"device": "cpu"}),
    }


@pytest.fixture(scope="module")
def engines():
    return bridged_engines("granite-3-2b", vocab=VOCAB)


def shared_agents(classes, seed=3, n=8, closed_loop=False):
    return smoke.shared_prefix_agents(*classes, seed, n, VOCAB,
                                      closed_loop=closed_loop)


def run_pair(engines, sched, make_agents=shared_agents, follow_ups=None,
             **kw):
    """Serve the same agents on both engines; per side the snapshot
    (completions, clock, every counter, hit fractions), the recorder and
    the engine."""
    kw.setdefault("pool_tokens", 2048)
    kw.setdefault("max_batch", 4)
    kw.setdefault("cache_len", 96)
    out = {}
    for name, (eng_cls, classes, mk, model, params, extra) in \
            engines.items():
        rec = Recorder(follow_ups)
        eng = eng_cls(model, params, mk(sched, float(kw["pool_tokens"])),
                      listener=rec, **kw, **extra)
        rec.engine = eng
        for a in make_agents(classes):
            eng.submit_agent(a)
        eng.run_until_idle()
        eng.alloc.check_invariants()
        snap = {"completions": dict(eng.completions), "now": eng.now,
                "metrics": dict(eng.metrics),
                "hit_fractions": eng.hit_fractions()}
        out[name] = (snap, rec, eng)
    return out["jax"], out["torch"]


def assert_pair_equal(jax_run, torch_run):
    (sj, rj, _), (st, rt, _) = jax_run, torch_run
    assert st == sj
    assert rt.events == rj.events
    assert rt.tokens == rj.tokens
    assert len(rt.tokens) == sj["metrics"]["tokens"]


@pytest.mark.parametrize("pool", [192, 2048])
@pytest.mark.parametrize("sched", ["justitia", "vtc", "vllm-fcfs"])
def test_prefix_engine_matches_jax(engines, sched, pool):
    jax_run, torch_run = run_pair(engines, sched, prefix_cache=True,
                                  pool_tokens=pool)
    assert_pair_equal(jax_run, torch_run)
    metrics = torch_run[0]["metrics"]
    assert metrics["prefix_hits"] > 0
    assert metrics["prefill_tokens_saved"] > 0
    hits = [e for e in torch_run[1].events if e[0] == "on_prefix_hit"]
    assert len(hits) == metrics["prefix_hits"]
    if pool == 192:
        assert metrics["swaps"] > 0, "pool 192 must force swaps"
    else:
        # a repeated 48-token prompt (three full blocks) hits in full
        assert any(e[3] == e[4] for e in hits)


@pytest.mark.parametrize("retention", ["hold", "spill"])
def test_prefix_engine_next_turn_matches_jax(engines, retention):
    """Closed-loop agents append a next turn that extends their first
    prompt, after think time: held KV is re-matched by the next turn,
    spilled KV is matched while its blocks survive in the index."""
    rng = np.random.default_rng(12)
    firsts = {a.agent_id: a.stages[0][0][0]
              for a in shared_agents((EngineAgent, TorchSpec,
                                      torch_agent_cost), n=4)}
    follow_ups = {
        (aid, stage): (np.concatenate([firsts[aid],
                                       rng.integers(0, VOCAB, size=8)]),
                       12, 4 + 3 * aid)
        for aid in range(4) for stage in (0, 1)
    }
    jax_run, torch_run = run_pair(
        engines, "justitia", follow_ups=follow_ups,
        make_agents=lambda c: shared_agents(c, n=4, closed_loop=True),
        prefix_cache=True, pool_tokens=512, suspend_retention=retention,
    )
    assert_pair_equal(jax_run, torch_run)
    metrics = torch_run[0]["metrics"]
    assert metrics["suspensions"] > 0
    assert metrics["prefix_hits"] > 0


def xlstm_agents(classes, seed=4, n=5):
    """Two exact prompt lengths (each one JAX compilation of the
    recurrent prefill): a 48-token first turn on one of two shared
    32-token heads, and a 64-token second turn that extends it."""
    agent_cls, spec, cost = classes
    rng = np.random.default_rng(seed)
    heads = [rng.integers(0, VOCAB, size=32) for _ in range(2)]
    agents = []
    for i in range(n):
        first = np.concatenate([heads[i % 2],
                                rng.integers(0, VOCAB, size=16)])
        second = np.concatenate([first, rng.integers(0, VOCAB, size=16)])
        stages = [[(first, int(rng.integers(12, 24)))],
                  [(second, int(rng.integers(12, 24)))]]
        specs = [spec(len(p), d) for stage in stages for p, d in stage]
        agents.append(agent_cls(i, int(rng.integers(0, 3 * n)), stages,
                                cost(specs)))
    return agents


def test_xlstm_prefix_engine_matches_jax():
    """The JAX engine takes ``prefix_cache=True`` on the ssm family (the
    recurrent prefill still runs the whole prompt; only the clock and the
    scheduler's charge shrink), and so does the port."""
    engines = bridged_engines("xlstm-350m", vocab=VOCAB, n_layers=4)
    jax_run, torch_run = run_pair(engines, "justitia",
                                  make_agents=xlstm_agents,
                                  prefix_cache=True, pool_tokens=2048)
    assert_pair_equal(jax_run, torch_run)
    assert torch_run[0]["metrics"]["prefix_hits"] > 0


def service_record(pkg, device_kw, fused: bool) -> dict:
    """The closed-loop workload through ``service_for_backend("engine",
    ..., prefix_cache=True)``: finish, JCT, the engine's counters and hit
    fractions, and every agent's events without token values."""
    svc = pkg.service_for_backend("engine", "justitia", prefix_cache=True,
                                  fused_prefill=fused, pool_tokens=512,
                                  **device_kw)
    run = dict(workload="closed", seed=20260731, n_agents=5)
    handles = svc.submit_many(smoke.api_specs(pkg, run))
    res = svc.drain()
    return {
        "finish": res.finish, "jct": res.jct,
        "counters": {k: res.metrics[k] for k in smoke.API_COUNTERS},
        "hit_fractions": res.metrics["hit_fractions"],
        "events": {h.agent_id: [smoke.event_row(e) for e in h.events]
                   for h in handles},
    }


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_prefix_service_matches_jax(fused):
    """Each side builds its own model from its own seed: the record does
    not depend on the weights."""
    want = service_record(jax_api, {}, fused)
    got = service_record(api, {"device": "cpu"}, fused)
    assert got == want
    assert got["counters"]["prefix_hits"] > 0
    assert (got["counters"]["fused_slices"] > 0) == fused
