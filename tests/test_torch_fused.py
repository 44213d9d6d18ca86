"""The port's fused prefill-in-window engine (``ServeEngine(fused_prefill=
True)``) against the JAX one (reduced granite-3-2b, float32, bridged
parameters, CPU, ``Model(debug_checks=True)``, so paged decode's
slot-contiguity precondition is asserted after every decode step, the
fused ones included).

* Exact against JAX on agents that share prompt heads, under justitia and
  vtc, at ``cache_len`` 96, with ``prefill_chunk`` 4, 8 and 16, pools 256
  and 2048, prefix cache off and on: completions, clock, every counter
  (``fused_slices`` among them), hit fractions, every event and every
  sampled token; and in 80-token slices that run past the cache end.
* In the port alone: fused tokens equal unfused tokens (``prefill_slice``
  computes what ``prefill_chunked`` computes; only the clock moves), and a
  copy of the JAX package's scheduling-free window check
  (``tests/test_fused_prefill.py``) on deterministic seeds.
* The gate: the ssm family and ring caches raise the JAX engine's
  ``ValueError``; fused admission of a fully cached prompt streams no
  slice; a 2-replica fleet on 1 and 2 worker threads serves both flags as
  the JAX fleet does, each engine with its own in-flight prefill.
"""

import jax
import numpy as np
import pytest

from repro import api as jax_api
from repro.configs import get_config
from repro.core import make_scheduler
from repro.engine import ServeEngine as JaxEngine
from repro.models import Model as JaxModel
from repro_torch import api
from repro_torch.configs import get_config as torch_get_config
from repro_torch.core import make_scheduler as torch_make_scheduler
from repro_torch.engine import EngineAgent, ServeEngine
from repro_torch.models import Model
from test_torch_api import VOCAB as API_VOCAB
from test_torch_api import bridged, smoke
from test_torch_engine import Recorder, synth_agents
from test_torch_prefix import (
    VOCAB,
    _one_torch_thread,  # noqa: F401  (module fixture)
    assert_pair_equal,
    bridged_engines,
    run_pair,
)


@pytest.fixture(scope="module")
def engines():
    return bridged_engines("granite-3-2b", vocab=VOCAB)


@pytest.mark.parametrize("prefix", [False, True],
                         ids=["no_prefix", "prefix"])
@pytest.mark.parametrize("pool", [256, 2048])
@pytest.mark.parametrize("chunk", [4, 8, 16])
@pytest.mark.parametrize("sched", ["justitia", "vtc"])
def test_fused_engine_matches_jax(engines, sched, chunk, pool, prefix):
    jax_run, torch_run = run_pair(engines, sched, fused_prefill=True,
                                  prefix_cache=prefix, prefill_chunk=chunk,
                                  pool_tokens=pool)
    assert_pair_equal(jax_run, torch_run)
    metrics = torch_run[0]["metrics"]
    assert metrics["fused_slices"] > 0
    assert (metrics["prefix_hits"] > 0) == prefix


@pytest.mark.parametrize("pool", [192, 2048])
def test_fused_slices_past_the_cache_end_match_jax(engines, pool,
                                                   monkeypatch):
    """80-token slices in a 96-row cache: every slice that starts after a
    32-token prefix hit runs past the cache end, and its rows there are
    dropped, as JAX drops them."""
    model = engines["torch"][3]
    slice_fn, past = model.prefill_slice, []

    def spy(params, cache, tokens, slot, start, total):
        if start + tokens.shape[0] > cache["k"].shape[2]:
            past.append(start)
        return slice_fn(params, cache, tokens, slot, start, total)

    monkeypatch.setattr(model, "prefill_slice", spy)
    jax_run, torch_run = run_pair(engines, "vtc", fused_prefill=True,
                                  prefix_cache=True, prefill_chunk=80,
                                  pool_tokens=pool)
    assert_pair_equal(jax_run, torch_run)
    assert past


@pytest.mark.parametrize("prefix", [False, True],
                         ids=["no_prefix", "prefix"])
def test_fused_tokens_match_unfused(engines, prefix):
    """Every request's sampled tokens are the same under both admission
    paths in the port; only the clock accounting differs.  Requests are
    matched as (agent, its n-th request): the clock decides when a later
    stage is submitted, and so the global request ids."""
    *_, tm, tp, extra = engines["torch"]
    toks = []
    for fused in (False, True):
        rec = Recorder()
        eng = ServeEngine(tm, tp, torch_make_scheduler("justitia", 2048.0),
                          pool_tokens=2048, max_batch=4, cache_len=96,
                          prefill_chunk=8, fused_prefill=fused,
                          prefix_cache=prefix, listener=rec, **extra)
        for a in synth_agents(EngineAgent, 5, 8):
            eng.submit_agent(a)
        eng.run_until_idle()
        assert (eng.metrics["fused_slices"] > 0) == fused
        per_rid = {}
        for ev, tok in zip((e for e in rec.events if e[0] == "on_token"),
                           rec.tokens):
            per_rid.setdefault((ev[1], ev[2]), []).append(tok)
        per_request, seen = {}, {}
        for aid, rid in sorted(per_rid, key=lambda key: key[1]):
            n = seen[aid] = seen.get(aid, -1) + 1
            per_request[aid, n] = per_rid[aid, rid]
        toks.append((per_request, set(eng.completions)))
    assert toks[1] == toks[0]


def test_fused_composes_with_prefix_cache(engines):
    """Three agents share a block-aligned head; the third repeats the
    first's prompt whole, so it decodes straight from the zero-clock head
    write and streams no slice: the slices cover the other two suffixes
    only.  The JAX engine gives the same run."""
    rng = np.random.default_rng(9)
    head = rng.integers(0, VOCAB, size=32)
    prompts = [np.concatenate([head, rng.integers(0, VOCAB, size=16)])
               for _ in range(2)]
    prompts.append(prompts[0].copy())

    def agents(classes):
        agent_cls, spec, cost = classes
        return [agent_cls(i, 40 * i, [[(p, 12)]], cost([spec(len(p), 12)]))
                for i, p in enumerate(prompts)]

    jax_run, torch_run = run_pair(engines, "justitia", make_agents=agents,
                                  fused_prefill=True, prefix_cache=True,
                                  prefill_chunk=8, cache_len=256)
    assert_pair_equal(jax_run, torch_run)
    metrics = torch_run[0]["metrics"]
    assert metrics["prefix_hits"] == 2
    assert metrics["prefill_tokens_saved"] == 32 + 48
    assert metrics["fused_slices"] == sum(-(-n // 8) for n in (48, 16))


# ------------------------------------------- scheduling-free fused windows


class SpyEngine(ServeEngine):
    """Records every decode window (start iteration, width) and the
    iteration at which a fused prefill stream exhausted its prompt."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.windows = []
        self.pf_exhaust = []

    def _decode_once(self, limit=None):
        t0 = self.now
        pf = self._pf
        k = super()._decode_once(limit)
        self.windows.append((t0, k))
        if pf is not None and self._pf is None:
            self.pf_exhaust.append((self.now, pf.total, pf.written))
        return k


class TriggerTap:
    """Records the engine iteration of every scheduling event."""

    def __init__(self):
        self.pass_start = []       # admissions / swaps: pass boundaries
        self.stage_complete = []   # (agent_id, stage, now)

    def on_admit(self, agent_id, rid, now):
        self.pass_start.append(now)

    def on_swap_out(self, agent_id, rid, now):
        self.pass_start.append(now)

    def on_swap_in(self, agent_id, rid, now):
        self.pass_start.append(now)

    def on_stage_complete(self, agent_id, stage, now):
        self.stage_complete.append((agent_id, stage, now))


@pytest.mark.parametrize("seed,n_agents,chunk,pool,sched", [
    (0, 2, 4, 256, "justitia"),
    (1, 6, 16, 2048, "vtc"),
    (2, 4, 8, 256, "vtc"),
    (3, 5, 4, 2048, "justitia"),
    (4, 6, 8, 256, "justitia"),
    (5, 3, 16, 256, "vtc"),
])
def test_fused_windows_are_scheduling_free(engines, seed, n_agents, chunk,
                                           pool, sched):
    """A fused window spans no scheduling trigger: admissions and swaps
    only at pass starts, stage-submitting completions and slice exhaustion
    only on a window's last step, and exhaustion overshoots the prompt by
    less than one slice.  Final-stage completions are exempt: with empty
    queues they schedule nothing."""
    *_, tm, tp, extra = engines["torch"]
    agents = synth_agents(EngineAgent, seed, n_agents)
    n_stages = {a.agent_id: len(a.stages) for a in agents}
    tap = TriggerTap()
    eng = SpyEngine(tm, tp, torch_make_scheduler(sched, float(pool)),
                    pool_tokens=pool, max_batch=4, cache_len=96,
                    prefill_chunk=chunk, listener=tap, fused_prefill=True,
                    **extra)
    for a in agents:
        eng.submit_agent(a)
    eng.run_until_idle(max_iters=5_000_000)
    eng.alloc.check_invariants()
    assert eng.metrics["fused_slices"] > 0

    starts = {t0 for t0, _ in eng.windows}
    last_steps = {t0 + k - 1 for t0, k in eng.windows}
    interior = set()
    for t0, k in eng.windows:
        interior.update(range(t0 + 1, t0 + k - 1))

    for t in tap.pass_start:
        assert int(t) in starts, f"admission/swap at {t} not a pass start"
        assert int(t) not in interior, "admission/swap inside a window"
    for aid, stage, t in tap.stage_complete:
        if stage < n_stages[aid] - 1:
            assert int(t) in last_steps, (
                f"agent {aid} stage {stage} (has a successor) completed at "
                f"{t}, not on a window's last step"
            )
            assert int(t) not in interior, "stage boundary inside a window"
    for now, total, written in eng.pf_exhaust:
        assert now in last_steps, (
            f"prefill exhaustion at {now} not on a window's last step"
        )
        assert written - total < chunk, (
            f"fused stream overshot the prompt: wrote {written} of "
            f"{total} (chunk {chunk})"
        )


# ------------------------------------------------------------------ gating


@pytest.mark.parametrize("arch,over,cache_len", [
    ("xlstm-350m", dict(n_layers=2), 96),
    ("granite-3-2b", dict(sliding_window=32), 96),
], ids=["ssm", "ring"])
def test_fused_gate_raises_as_jax_does(arch, over, cache_len):
    over = dict(vocab=VOCAB, **over)
    jm = JaxModel(get_config(arch).reduced(**over))
    tm = Model(torch_get_config(arch).reduced(**over), device="cpu")
    errors = []
    for eng_cls, model, mk in ((JaxEngine, jm, make_scheduler),
                               (ServeEngine, tm, torch_make_scheduler)):
        with pytest.raises(ValueError, match="fused_prefill") as err:
            eng_cls(model, None, mk("justitia", 256.0), pool_tokens=256,
                    max_batch=2, cache_len=cache_len, fused_prefill=True,
                    **({"device": "cpu"} if eng_cls is ServeEngine else {}))
        errors.append(str(err.value))
    assert errors[1] == errors[0]


# ------------------------------------------------------------------- fleet


@pytest.fixture(scope="module")
def fleet_runs():
    """The closed-loop workload on a 2-replica fleet with both flags: the
    JAX fleet's run, and the port's at 1 and 2 worker threads."""
    jm, jp, tm, tp = bridged("granite-3-2b", vocab=API_VOCAB)
    run = dict(workload="closed", seed=20260731, n_agents=5,
               pool_tokens=512,
               service=dict(replicas=2, router="round_robin",
                            prefix_cache=True, fused_prefill=True))
    return {
        "jax": smoke.serve_api(jax_api, jm, jp, run),
        1: smoke.serve_api(api, tm, tp, run, fleet_workers=1),
        2: smoke.serve_api(api, tm, tp, run, fleet_workers=2),
    }


@pytest.mark.parametrize("workers", [1, 2])
def test_fused_prefix_fleet_matches_jax(fleet_runs, workers):
    (want, jax_handles), (got, handles) = fleet_runs["jax"], \
        fleet_runs[workers]
    assert smoke.record_diff(got, want) == ""
    assert smoke.sampled_tokens(handles) == smoke.sampled_tokens(jax_handles)
    assert len(got["counters"]) == 2
    for counters in got["counters"]:
        assert counters["fused_slices"] > 0

