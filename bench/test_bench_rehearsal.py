"""The harness driven end to end on the CPU at a reduced width
(``rehearse.py``): wall stamps in order, the drain, ``failed``, the
closed loop's resubmission, the traced run's spans; and ``run.py``'s
refusal without a card."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import harness
from rehearse import rehearse

BENCH = Path(__file__).resolve().parent
MEM, CLOSED = "granite-3-2b.agents-open", "h2o-danube-1.8b.agents-closed"


def _stamps_in_order(run):
    rec = run.rec
    for aid in run.attempted():
        assert rec.due[aid] <= rec.submit[aid]
        if aid not in rec.done:
            continue
        stage_done = rec.stage_done[aid]
        for rid, (s, _) in rec.inference_of(aid).items():
            sub = rec.submit[aid] if s == 0 else stage_done[s - 1]
            assert sub <= rec.admit[rid] <= stage_done[s]
        assert max(stage_done.values()) <= rec.done[aid]
        assert len(stage_done) == len(rec.agents[aid].stages)


def test_open_loop_rehearsal_serves_every_due_agent():
    out, run = rehearse(MEM, seconds=6.0, rate_per_s=1.0)
    assert out["correct"], out["checks"]
    assert out["attempted"] == 6
    assert out["failed"] == 0
    assert set(out["metrics"]) == {"jct_mean_s", "jct_p90_s", "setup_s"}
    _stamps_in_order(run)
    assert run.window_end >= run.end and run.drain_end >= run.window_end
    due = sorted(run.rec.due[a] - run.t0 for a in run.attempted())
    assert due == pytest.approx(sorted(t for t, _ in run.source.plan))
    decoded = sum(d for a in run.attempted()
                  for d in (x[1] for x in run.rec.agents[a].inferences))
    assert run.rec.n_tokens == decoded == run.engine.metrics["tokens"]
    assert out["checks"]["count_errors"]["value"] == 0


def test_unfinished_agents_count_as_failed_and_above_every_jct():
    out, run = rehearse(MEM, seconds=2.0, rate_per_s=6.0)
    assert out["attempted"] == 12
    assert 0 < out["failed"] < 12
    assert run.drain_end <= run.t0 + 4.0 + 5.0
    jct = run.jcts()
    done = [run.rec.done[a] - run.rec.due[a] for a in run.attempted()
            if a in run.rec.done]
    assert len(jct) == 12 and min(jct[len(done):]) >= max(done)
    assert out["checks"]["count_errors"]["value"] == 0


def test_closed_loop_rehearsal_resubmits_as_agents_complete():
    out, run = rehearse(CLOSED, seconds=6.0)
    assert out["correct"], out["checks"]
    clients = run.mix["clients"]
    assert out["attempted"] > clients and out["failed"] == 0
    assert set(out["metrics"]) == {"tokens_per_s", "setup_s"}
    _stamps_in_order(run)
    rec = run.rec
    # a client's next agent is due when its last completed, so no more than
    # ``clients`` agents are ever in flight, and every resubmission is due
    # at a completion stamp
    subs = sorted(rec.submit[a] for a in run.attempted())
    for t in subs:
        live = sum(rec.submit[a] <= t < rec.done.get(a, np.inf)
                   for a in run.attempted())
        assert live <= clients
    completions = set(rec.done.values())
    later = [a for a in run.attempted() if rec.due[a] - run.t0 >
             run.mix["stagger_s"]]
    assert later and all(rec.due[a] in completions for a in later)
    assert out["metrics"]["tokens_per_s"]["value"] == pytest.approx(
        run.window_tokens / (run.window_end - run.t0))


def test_classes_stated_in_the_mix_are_served_end_to_end():
    stated = {"name": "Stated", "keywords": ["alpha", "beta"],
              "stages": [{"n_parallel": [1, 3],
                          "prefill": {"uniform": [64, 200]},
                          "decode": {"skew_normal": [20, 4, 1.0],
                                     "clip": [4, 40]}}]}
    out, run = rehearse(CLOSED, seconds=4.0, classes=[stated, "EV"])
    assert out["correct"], out["checks"]
    names = {run.rec.agents[a].cls for a in run.attempted()}
    assert names == {"Stated", "EV"}
    _stamps_in_order(run)


def test_traced_rehearsal_records_spans_and_reads_no_device_metric():
    out, run = rehearse(MEM, seconds=4.0, trace=True)
    assert out["correct"]
    names = {s[0] for s in run.tracer.spans}
    assert {"engine.step", "engine.admit", "engine.prefill",
            "engine.decode_window", "engine.decode_launch",
            "harness.submit"} <= names
    assert run.tracer.traced is not None and run.tracer.traced[1]
    assert run.tracer.decodes and run.tracer.prefills and run.tracer.paged
    got = set(out["metrics"])
    assert {"cost_err.open", "queue_wait_s.open", "swaps_per_agent.open",
            "decode_step_ms.open"} <= got
    assert not any(n.startswith(("mfu", "idle_share")) or "roofline" in n
                   for n in got)
    assert "breakdown" not in out
    # the patches are gone after the run
    from repro_torch.engine import engine as engine_mod
    from repro_torch.models import transformer
    from repro_torch.kernels import ops
    assert transformer.paged_gqa_decode is ops.paged_gqa_decode
    assert transformer.flash_prefill is ops.flash_prefill
    assert engine_mod._decode_window.__module__ == engine_mod.__name__


def test_run_refuses_without_a_card_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: run.py runs there")
    env = {**os.environ, "PYTHONPATH": ""}
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", MEM,
         "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_one_short_run_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card: bench/run.py measures only there")
    out, run = harness.execute(MEM, 7, 10.0, False)
    assert out["correct"], out["checks"]
