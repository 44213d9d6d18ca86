"""The per-layer metrics that read the program's own records
(``program_trace.py``), on a traced CPU rehearsal of each cell: what they
read off the card, that the benchmark's patches still see every call
while the program's spans lie inside them, that the program's FLOPs equal
the harness's, and that a program without records gives nothing.

    python -m pytest bench
"""

from __future__ import annotations

import types

import pytest
import torch

import harness
import program_trace
from rehearse import rehearse

OPEN, CLOSED = "granite-3-2b.agents-open", "h2o-danube-1.8b.agents-closed"
#: the metrics that read the program's records, by cell
PROGRAM = {
    OPEN: {"step_mfu.open"},
    CLOSED: {"replay_ms.closed", "prefill_pad_share.closed",
             "step_mfu.closed"},
}
#: of those, the ones that need the card
DEVICE = {"step_mfu.open", "step_mfu.closed"}


@pytest.fixture(scope="module")
def traced():
    return {cell: rehearse(cell, seconds=4.0, trace=True)
            for cell in (OPEN, CLOSED)}


def _inside(inner, outer) -> bool:
    """Each (start, end) of ``inner`` lies inside one of ``outer``."""
    outer = sorted(outer)
    return all(any(a <= s and t <= b for a, b in outer) for s, t in inner)


@pytest.mark.parametrize("cell", [OPEN, CLOSED])
def test_traced_rehearsal_reads_the_program_metrics(traced, cell):
    out, run = traced[cell]
    assert out["correct"], out["checks"]
    got = set(out["metrics"])
    assert PROGRAM[cell] - DEVICE <= got
    assert not got & DEVICE
    values = {n: out["metrics"][n]["value"] for n in PROGRAM[cell] - DEVICE}
    for name, v in values.items():
        if name.startswith("replay_ms"):
            assert v > 0, name
        else:
            assert 0 <= v < 100, name


@pytest.mark.parametrize("cell", [OPEN, CLOSED])
def test_the_benchmark_patches_see_every_call_around_the_programs_spans(
        traced, cell):
    _, run = traced[cell]
    tr, rec = run.tracer, run.engine.trace
    assert tr.decodes and tr.prefills and tr.paged and tr.flash

    def bench(name):
        return [(a, b) for n, a, b, *_ in tr.spans if n == name]

    def program(name):
        return [(s.start / 1e9, s.end / 1e9) for s in rec.spans
                if s.name == name]

    pairs = [("engine.step", "step"), ("engine.prefill", "prefill"),
             ("engine.decode_window", "decode"),
             ("engine.decode_window", "decode.replay")]
    for outer, inner in pairs:
        assert program(inner) and _inside(program(inner), bench(outer))
    # each decode span that ran a window launched it once; the warm-up's
    # direct launch ran outside an engine step and left no span
    launched = [s for s in rec.spans if s.name == "decode" and s.attrs["k"]]
    assert len(bench("engine.decode_launch")) == len(launched) + 1
    assert len(bench("engine.step")) == len(program("step"))


@pytest.mark.parametrize("cell", [OPEN, CLOSED])
def test_the_programs_flops_equal_the_harness_count_of_the_traced_seconds(
        traced, cell):
    _, run = traced[cell]
    tr, rec = run.tracer, run.engine.trace
    lo, hi = (round(x * 1e9) for x in tr.traced)
    keep, spans = set(), []
    for s in sorted(rec.spans, key=lambda s: s.id):
        if (s.name == "step" and lo <= s.start and s.end <= hi) or (
                s.parent in keep):
            keep.add(s.id)
            spans.append(s)
    want = tr.useful_flops(run.family, run.cfg)
    assert want > 0
    assert program_trace.useful_flops(run, spans) == pytest.approx(
        want, rel=1e-12)


def test_the_selection_leaves_out_the_profiled_seconds(traced):
    _, run = traced[OPEN]
    lo, hi = (round(x * 1e9) for x in run.tracer.traced)
    spans = program_trace.window_spans(run)
    steps = [s for s in spans if s.name == "step"]
    every = [s for s in run.engine.trace.spans if s.name == "step"]
    assert steps and len(steps) < len(every)
    assert not any(s.start < hi and lo < s.end for s in steps)
    assert {s.id for s in every if not (s.start < hi and lo < s.end)} == {
        s.id for s in steps}
    decode = [s for s in spans if s.name == "decode"]
    replay = [s for s in spans if s.name == "decode.replay"]
    assert program_trace.replay_ms(run) == pytest.approx(
        sum(s.end - s.start for s in replay) / 1e6
        / sum(s.attrs["k"] for s in decode))


@pytest.mark.parametrize("name", sorted(set().union(*PROGRAM.values())))
def test_a_program_without_records_gives_nothing(name):
    run = types.SimpleNamespace(
        engine=types.SimpleNamespace(metrics={}), tracer=None, t0=0.0,
        drain_end=1.0, device=torch.device("cuda"), family=None, cfg={})
    assert harness.load_reader(name)(run) is None
