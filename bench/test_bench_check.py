"""The output check fails what it has to fail.

* The control: the plain reference with fp8 operands put in the
  program's place reads far above the program's gap, at a reduced width
  on the CPU.  (Its readings at full width on the card, which the cells'
  limits are set from, are ``calibrate.py``'s; PERF.md lists them.)
* Faults planted under a rehearsal run, which skips only the harness's
  look for a card: a decode step that returns its state unchanged, a
  token altered where the decode step samples it, a first token altered
  where the prefill samples it, and tokens lost on their way to the
  service.  Each makes ``correct`` false.
"""

from __future__ import annotations

import pytest
import torch

import harness
import rehearse

MEM = "granite-3-2b.agents-open"


def _readings(dtype: str, seed: int = 5):
    torch.set_num_threads(2)
    cell = harness.cell_of(MEM)
    ov = rehearse.overrides(cell)
    ov["config"] = {**rehearse.SMALL, "dtype": dtype}
    run = harness.Run(cell, seed, 4.0, device="cpu", overrides=ov)
    run.setup()
    run.serve()
    sample = run.sample()
    run.free_program()
    return (run.served_gaps(sample), run.served_gaps(sample, control=True),
            sample)


def test_the_control_reads_far_above_the_program():
    prog, control, sample = _readings("float32")
    assert sum(len(s) for _, s in sample) >= 300
    limit = rehearse.overrides(harness.cell_of(MEM))["limit"]
    assert prog <= limit < control / 10
    prog16, control16, _ = _readings("bfloat16")
    assert control16 > max(3 * prog16, limit)


def _altered_decode(inner):
    def step(model, params, cache, state):
        nxt, new = inner(model, params, cache, state)
        nxt = nxt.clone()
        nxt[0] = (nxt[0] + 1) % model.cfg.vocab
        return nxt, new
    return step


def _stuck_decode(inner):
    def step(model, params, cache, state):
        nxt, _ = inner(model, params, cache, state)
        return nxt, state
    return step


def _altered_prefill(inner):
    def write(model, *args):
        return (inner(model, *args) + 1) % model.cfg.vocab
    return write


def _lost_tokens(inner):
    seen = {"n": 0}

    def on_token(self, agent_id, rid, token, t, **kw):
        seen["n"] += 1
        if seen["n"] % 50:
            inner(self, agent_id, rid, token, t, **kw)
    return on_token


FAULTS = {
    "token_altered_in_decode": ("engine", "_decode_step", _altered_decode),
    "decode_state_unchanged": ("engine", "_decode_step", _stuck_decode),
    "first_token_altered_in_prefill": ("engine", "_prefill_write",
                                       _altered_prefill),
    "tokens_lost_before_the_service": ("dispatcher", "on_token",
                                       _lost_tokens),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_makes_the_run_incorrect(fault, monkeypatch):
    from repro_torch.api import service
    from repro_torch.engine import engine as engine_mod

    where, attr, make = FAULTS[fault]
    obj = engine_mod if where == "engine" else service._Dispatcher
    monkeypatch.setattr(obj, attr, make(getattr(obj, attr)))
    out, run = rehearse.rehearse(MEM, seconds=3.0)
    assert out["checks"]["empty_sample"]["value"] == 0
    assert not out["correct"], out["checks"]


def test_the_sound_rehearsal_is_correct():
    out, _ = rehearse.rehearse(MEM, seconds=3.0)
    assert out["correct"], out["checks"]
    assert torch.get_default_dtype() == torch.float32
