"""The port's frozen serving engine (``repro_torch.engine.ReferenceServeEngine``)
against the JAX package's, and the port's ``ServeEngine`` against it.

* **Oracle against oracle.**  Reduced granite-3-2b and reduced xlstm-350m at
  float32 on the CPU, parameters bridged from the JAX ``Model.init``: the
  completions, clock, counters and event streams (token values dropped)
  equal the JAX frozen engine's; the sampled tokens agree at the rate
  ``tests/test_torch_engine.py`` asks of ``ServeEngine``.
* **The port's engines against each other**, as the JAX package pins its
  own (``tests/test_engine_pressure.py``, ``tests/test_fused_prefill.py``):
  swap-heavy runs with ordered events, allocator invariants at every event,
  the self-evicted-while-growing regression, chunked prefill, ``run(until)``
  slicing, the fused-off engine bit-identical.  Every model here runs with
  ``debug_checks=True``, so the frozen engine's decode of FREE slots at
  their stale positions keeps every slot's rows contiguous.
* **The swap copy**: a swapped request's restored rows equal its rows at
  swap-out, though its slot served another request meanwhile.
* **The refusals**, beside the JAX frozen engine's own failures.

Every workload is seeded: no Hypothesis draws.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import make_scheduler
from repro.engine import EngineAgent as JaxAgent
from repro.engine import ReferenceServeEngine as JaxReference
from repro.models import Model as JaxModel
from repro_torch.configs import get_config as torch_get_config
from repro_torch.core import InferenceSpec, agent_cost
from repro_torch.core import make_scheduler as torch_make_scheduler
from repro_torch.engine import EngineAgent, ReferenceServeEngine, ServeEngine
from repro_torch.models import Model
from repro_torch.models.params import params_from_jax
from test_torch_engine import (
    VOCAB,
    XLSTM_LENGTHS,
    _one_torch_thread,  # noqa: F401  (module fixture)
    assert_same,
    run_both,
)
from test_torch_families import LIMITS

ORACLE_KEYS = ("tokens", "prefills", "swaps", "decode_steps")


def bridged(arch, **over):
    """The engines dict of ``run_both`` with the two frozen engines."""
    jm = JaxModel(get_config(arch).reduced(**over))
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = torch_get_config(arch).reduced(**over)
    tm = Model(cfg, device="cpu", debug_checks=cfg.kind == "dense")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return {
        "jax": (JaxReference, JaxAgent, make_scheduler, jm, jp, {}),
        "torch": (ReferenceServeEngine, EngineAgent, torch_make_scheduler,
                  tm, tp, {"device": "cpu"}),
    }


@pytest.fixture(scope="module")
def oracles():
    return bridged("granite-3-2b", vocab=VOCAB)


@pytest.fixture(scope="module")
def xlstm_oracles():
    return bridged("xlstm-350m", vocab=VOCAB, n_layers=4)


# ------------------------------------------------- oracle against oracle


@pytest.mark.parametrize("cache_len", [96, 100])
@pytest.mark.parametrize("sched,pool", [
    ("justitia", 4096),
    ("justitia", 256),
    ("vtc", 4096),
    ("vtc", 256),
])
def test_oracle_matches_jax_oracle(oracles, sched, pool, cache_len):
    """Completions, clock, counters and token-free event streams equal;
    pool 256 swaps, and cache length 100 decodes over 10-token pages."""
    jax_run, torch_run = run_both(oracles, sched, pool_tokens=pool,
                                  cache_len=cache_len)
    assert_same(jax_run, torch_run)
    assert torch_run[2].cache["k"].shape[2] == cache_len
    if pool == 256:
        assert jax_run[0]["swaps"] > 0, "pool 256 must force swaps"


@pytest.mark.parametrize("sched,pool", [("justitia", 4096), ("vtc", 256)])
def test_xlstm_oracle_matches_jax_oracle(xlstm_oracles, sched, pool):
    """Recurrent state, one exact-length prefill per admission, swapped
    to the host and back at pool 256."""
    jax_run, torch_run = run_both(xlstm_oracles, sched, n_agents=5,
                                  lengths=XLSTM_LENGTHS, pool_tokens=pool,
                                  cache_len=160)
    assert_same(jax_run, torch_run)
    if pool == 256:
        assert jax_run[0]["swaps"] > 0, "pool 256 must force swaps"


# ------------------------------------ the port's engine against its oracle


@pytest.fixture(scope="module")
def tiny_model():
    model = Model(torch_get_config("granite-3-2b").reduced(vocab=VOCAB),
                  device="cpu", debug_checks=True)
    return model, model.init(seed=0)


def mk_agent(rng, aid, n_inf, p, d, arrival=0, stages=1, cost=None):
    sts = [[(rng.integers(0, VOCAB, size=p), d) for _ in range(n_inf)]
           for _ in range(stages)]
    specs = [InferenceSpec(p, d)] * (n_inf * stages)
    return EngineAgent(aid, arrival, sts,
                       agent_cost(specs) if cost is None else cost)


class EventLog:
    """The full lifecycle stream, token values dropped; with ``alloc`` the
    allocator's invariants are checked at every event."""

    def __init__(self, alloc=None):
        self.events = []
        self.alloc = alloc

    def __getattr__(self, name):
        if not name.startswith("on_"):
            raise AttributeError(name)

        def note(*args):
            if name == "on_token":
                args = args[:2] + (None,) + args[3:]
            self.events.append((name, args))
            if self.alloc is not None:
                self.alloc.check_invariants()

        return note


def run_engine(cls, model, params, sched_name, agents, *, listener=None,
               **kw):
    kw.setdefault("pool_tokens", 320)
    kw.setdefault("max_batch", 4)
    kw.setdefault("cache_len", 128)
    sched = torch_make_scheduler(sched_name, float(kw["pool_tokens"]))
    eng = cls(model, params, sched, listener=listener, device="cpu", **kw)
    for a in agents:
        eng.submit_agent(a)
    done = eng.run_until_idle(max_iters=100_000)
    eng.alloc.check_invariants()
    return eng, done


def pressure_agents(seed=0, n=4):
    """Agents whose concurrent KV demand is ~3x the 320-token pool."""
    rng = np.random.default_rng(seed)
    return [mk_agent(rng, i, 2, 40, 48, arrival=2 * i) for i in range(n)]


@pytest.mark.parametrize("sched_name", ["justitia", "vtc"])
def test_swap_heavy_pressure_matches_reference_and_orders_events(
        tiny_model, sched_name):
    """Tiny pool, repeated swap cycles: both engines drain, the streams
    are equal (order and stamps, token values aside) and each request's
    lifecycle is legal."""
    model, params = tiny_model
    logs, engines = {}, {}
    for cls in (ServeEngine, ReferenceServeEngine):
        log = EventLog()
        eng, done = run_engine(cls, model, params, sched_name,
                               pressure_agents(), listener=log)
        assert set(done) == {0, 1, 2, 3}, cls.__name__
        logs[cls], engines[cls] = log, eng
    new, ref = engines[ServeEngine], engines[ReferenceServeEngine]
    assert new.metrics["swaps"] > 0
    assert new.alloc.swap_events > 0
    assert new.completions == ref.completions
    assert new.now == ref.now
    for key in ORACLE_KEYS:
        assert new.metrics[key] == ref.metrics[key], key
    assert logs[ServeEngine].events == logs[ReferenceServeEngine].events
    state = {}
    for kind, args in logs[ServeEngine].events:
        if kind not in ("on_admit", "on_swap_out", "on_swap_in", "on_token"):
            continue
        rid = args[1]
        prev = state.get(rid, "new")
        if kind == "on_admit":
            assert prev == "new", f"rid {rid} admitted twice"
            state[rid] = "running"
        elif kind == "on_swap_out":
            assert prev == "running", f"rid {rid} swapped out while {prev}"
            state[rid] = "swapped"
        elif kind == "on_swap_in":
            assert prev == "swapped", f"rid {rid} swapped in while {prev}"
            state[rid] = "running"
        else:
            assert prev == "running", f"rid {rid} decoded while {prev}"


@pytest.mark.parametrize("cls", [ServeEngine, ReferenceServeEngine],
                         ids=["ServeEngine", "ReferenceServeEngine"])
def test_pressure_run_holds_allocator_invariants_at_every_event(
        tiny_model, cls):
    model, params = tiny_model
    eng = cls(model, params, torch_make_scheduler("justitia", 320.0),
              pool_tokens=320, max_batch=4, cache_len=128, device="cpu")
    log = EventLog(alloc=eng.alloc)
    eng.listener = log
    for a in pressure_agents(seed=1):
        eng.submit_agent(a)
    done = eng.run_until_idle(max_iters=100_000)
    assert len(done) == 4
    assert eng.metrics["swaps"] > 0
    assert any(kind == "on_swap_out" for kind, _ in log.events)


def test_self_evicted_while_growing_regression(tiny_model):
    """An elephant agent (worst key) whose own growth exhausts the pool
    evicts ITSELF and stops decoding that step, on both engines alike."""
    model, params = tiny_model

    def agents():
        rng2 = np.random.default_rng(3)
        eleph = mk_agent(rng2, 0, 1, 16, 40, cost=1e9)
        mouse = mk_agent(rng2, 1, 1, 16, 40, arrival=1)
        return [eleph, mouse]

    results = {}
    for cls in (ServeEngine, ReferenceServeEngine):
        log = EventLog()
        eng, done = run_engine(cls, model, params, "justitia", agents(),
                               listener=log, pool_tokens=96, max_batch=2,
                               cache_len=128, block_size=16)
        assert set(done) == {0, 1}
        results[cls] = (eng, log)
    new_eng, new_log = results[ServeEngine]
    ref_eng, ref_log = results[ReferenceServeEngine]
    swap_outs = [a for k, a in new_log.events if k == "on_swap_out"]
    assert any(a[0] == 0 for a in swap_outs), "elephant never self-evicted"
    seen_out = False
    for kind, args in new_log.events:
        if kind == "on_swap_out" and args[0] == 0:
            seen_out = True
        elif kind == "on_swap_in" and args[0] == 0:
            seen_out = False
        elif kind == "on_token" and args[0] == 0:
            assert not seen_out, "self-evicted request kept decoding"
    assert new_log.events == ref_log.events
    assert new_eng.completions == ref_eng.completions


def test_chunked_prefill_engine_matches_reference_completions(tiny_model):
    """Prompts spanning several prefill chunks: equal completions, clock
    and counters (the on_admit stamps legitimately differ here)."""
    model, params = tiny_model

    def agents():
        rng2 = np.random.default_rng(5)
        return [
            mk_agent(rng2, 0, 2, 100, 20),
            mk_agent(rng2, 1, 1, 70, 16, arrival=2),
            mk_agent(rng2, 2, 1, 90, 12, arrival=4),
        ]

    results = {}
    for cls in (ServeEngine, ReferenceServeEngine):
        eng, done = run_engine(cls, model, params, "justitia", agents(),
                               pool_tokens=2048, max_batch=4, cache_len=128,
                               prefill_chunk=32)
        assert set(done) == {0, 1, 2}
        results[cls] = eng
    new, ref = results[ServeEngine], results[ReferenceServeEngine]
    assert new.metrics["prefills"] == ref.metrics["prefills"] == 4
    assert new.completions == ref.completions
    assert new.now == ref.now
    for key in ("tokens", "decode_steps", "swaps"):
        assert new.metrics[key] == ref.metrics[key], key


def test_run_until_slicing_matches_reference_with_prefill_cost(tiny_model):
    """A decode window must not run past ``run(until)`` when the admission
    pass advanced the clock: an arrival submitted at the slice boundary
    lands at the same iteration on both engines."""
    model, params = tiny_model

    def drive(cls):
        rng = np.random.default_rng(9)
        eng = cls(model, params, torch_make_scheduler("justitia", 2048.0),
                  pool_tokens=2048, max_batch=4, cache_len=128,
                  prefill_chunk=32, device="cpu")
        eng.submit_agent(mk_agent(rng, 0, 1, 100, 24))
        for until in (5, 9, 14, 30):
            eng.run(until)
            assert eng.now >= until
        eng.submit_agent(mk_agent(rng, 1, 1, 40, 8, arrival=eng.now))
        done = eng.run_until_idle(max_iters=10_000)
        return eng.now, done

    assert drive(ServeEngine) == drive(ReferenceServeEngine)


def perf_agents(seed, n):
    """The seeded agents of ``benchmarks/perf_engine.py``'s
    ``synth_agents`` (1-2 stages x 1-2 inferences, prompts of 8-23 tokens,
    decodes of 32-69), as the port's ``EngineAgent``s."""
    rng = np.random.default_rng(seed)
    agents = []
    for i in range(n):
        stages, specs = [], []
        for _ in range(1 + int(rng.integers(0, 2))):
            stage = []
            for _ in range(1 + int(rng.integers(0, 2))):
                p = int(rng.integers(8, 24))
                d = int(rng.integers(32, 70))
                stage.append((rng.integers(0, 256, size=p), d))
                specs.append(InferenceSpec(p, d))
            stages.append(stage)
        agents.append(EngineAgent(i, int(rng.integers(0, 5 * n)), stages,
                                  agent_cost(specs)))
    return agents


@pytest.mark.parametrize("sched", ["justitia", "vtc"])
def test_fused_off_bit_identical_to_reference(tiny_model, sched):
    """With fused prefill off (the default) ``ServeEngine`` is the frozen
    engine: completions, clock, token/prefill/swap/decode-step counts."""
    model, params = tiny_model
    snaps = {}
    for cls in (ServeEngine, ReferenceServeEngine):
        eng = cls(model, params, torch_make_scheduler(sched, 256.0),
                  pool_tokens=256, max_batch=4, cache_len=96, device="cpu")
        for a in perf_agents(3, 10):
            eng.submit_agent(a)
        eng.run_until_idle(max_iters=5_000_000)
        eng.alloc.check_invariants()
        snaps[cls.__name__] = {
            "completions": dict(eng.completions), "now": eng.now,
            **{k: eng.metrics[k] for k in ORACLE_KEYS}}
    assert snaps["ServeEngine"] == snaps["ReferenceServeEngine"]
    assert snaps["ServeEngine"]["swaps"] > 0


# ---------------------------------------------------------- the swap copy


class SwapTap(ReferenceServeEngine):
    """The frozen engine, noting each victim's slot rows at swap-out and
    comparing them with the rows its restore writes back."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.at_swap_out = {}
        self.restores = []   # (rows equal, slot rewritten meanwhile)

    def _swap_out_worst(self):
        swapped = super()._swap_out_worst()
        if swapped:
            req = next(r for r in self.swapped
                       if r.rid not in self.at_swap_out)
            slot = self.slot_free[-1]
            self.at_swap_out[req.rid] = {
                k: big[:, slot].clone() for k, big in self.cache.items()}
        return swapped

    def _restore_slot(self, req):
        slot = self.slot_free[-1]
        before = {k: big[:, slot].clone() for k, big in self.cache.items()}
        super()._restore_slot(req)
        assert req.slot == slot
        snap = self.at_swap_out.pop(req.rid)
        self.restores.append((
            all(torch.equal(self.cache[k][:, slot], snap[k]) for k in snap),
            any(not torch.equal(before[k], snap[k]) for k in snap),
        ))


def test_swapped_rows_are_restored_as_they_were(tiny_model):
    """The swap-out copy is owned: a restore writes back the rows the
    request had at swap-out, though the slot was rewritten meanwhile."""
    model, params = tiny_model
    eng, done = run_engine(SwapTap, model, params, "justitia",
                           pressure_agents(seed=2, n=5))
    assert set(done) == set(range(5))
    assert eng.restores and not eng.at_swap_out
    assert all(equal for equal, _ in eng.restores)
    assert any(rewritten for _, rewritten in eng.restores), (
        "no slot was rewritten between a swap-out and its restore")


def test_free_slots_decode_at_their_stale_positions(tiny_model):
    """One request on four slots: every step decodes all four rows (the
    frozen behaviour) and the slot-contiguity check of ``debug_checks``
    holds for the free ones."""
    model, params = tiny_model
    assert model.debug_checks
    rng = np.random.default_rng(4)
    eng, done = run_engine(ReferenceServeEngine, model, params, "justitia",
                           [mk_agent(rng, 0, 1, 20, 12)])
    assert done == {0: eng.now - 1}
    assert eng.metrics["decode_steps"] == 12
    # the three never-used slots decoded at position 0 every step
    kv_pos = eng.cache["kv_pos"]
    assert (kv_pos[:, :3, 0] == 0).all() and (kv_pos[:, :3, 1:] == -1).all()


# ------------------------------------------------------------ the refusals


@pytest.mark.parametrize("arch", list(LIMITS))
def test_oracle_refuses_what_serve_engine_refuses(arch):
    model = Model(torch_get_config(arch).reduced(vocab=VOCAB), device="cpu")
    params = model.init(seed=0)
    for cls in (ServeEngine, ReferenceServeEngine):
        with pytest.raises(NotImplementedError, match=LIMITS[arch]):
            cls(model, params, torch_make_scheduler("justitia", 4096.0),
                device="cpu")


def _jax_oracle_after_one_admission(arch):
    model = JaxModel(get_config(arch).reduced(vocab=VOCAB))
    params = model.init(jax.random.PRNGKey(0))
    eng = JaxReference(model, params, make_scheduler("justitia", 4096.0),
                       max_batch=4, cache_len=128)
    spec = [(np.arange(12, dtype=np.int32) % VOCAB, 4)]
    eng.submit_agent(JaxAgent(0, 0, [spec],
                              agent_cost([InferenceSpec(12, 4)])))
    eng._release_arrivals()
    eng._admit()
    return eng


def test_jax_oracle_fails_on_the_encoder_decoder():
    """The JAX frozen engine never passes the audio frames."""
    with pytest.raises(KeyError, match="embeds"):
        _jax_oracle_after_one_admission("whisper-tiny")


def test_jax_oracle_writes_the_hybrid_state_into_the_wrong_row():
    """The JAX frozen engine serves the hybrid without an error, but its
    slot write takes every leaf's batch on axis 1: the Mamba2 state, batch
    on axis 2, of a prompt admitted into slot 3 lands in row 0."""
    eng = _jax_oracle_after_one_admission("zamba2-2.7b")
    slot = next(iter(eng.slot_req))
    assert slot == 3
    h = np.asarray(eng.cache["mamba_h"])
    assert not np.any(h[:, :, slot]) and np.any(h[:, :, 0])
