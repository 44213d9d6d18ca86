"""The JAX examples' record (``tests/torch_examples_jax_runs.json``), which
``tests/test_torch_examples.py`` and ``chip_smoke.py`` phase 13 hold the
port's examples to, regenerates unchanged from the JAX examples
(``scripts/record_jax_examples.py``, about 40 s on the CPU), and covers
what phase 13 reads from it."""

import importlib.util
import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


smoke = _load("chip_smoke", ROOT / "chip_smoke.py")
recorder = _load("record_jax_examples",
                 ROOT / "scripts" / "record_jax_examples.py")
TEXT = smoke.EXAMPLES_RECORD.read_text()
RECORD = json.loads(TEXT)
PARTS = ("serve_agents", "quickstart", "fairness_demo", "train_small")


@pytest.fixture(scope="module")
def regenerated():
    return recorder.build_record(smoke)


@pytest.mark.parametrize("part", PARTS)
def test_record_regenerates_unchanged(part, regenerated):
    """Each example's part of the committed record is what the JAX
    example gives today."""
    assert regenerated[part] == RECORD[part]


def test_record_file_is_the_recorder_dump(regenerated):
    assert recorder.dumps(regenerated) == TEXT


def test_record_covers_the_example_sets():
    sets = RECORD["serve_agents"]
    assert {n: r["argv"] for n, r in sets.items()} == smoke.EXAMPLE_SETS
    for name, rec in sets.items():
        closed = "--closed-loop" in rec["argv"]
        assert (rec["costs"] is None) == closed
        assert ("events" in rec) == (name in smoke.EXAMPLE_EVENT_SETS)
        assert any(line.startswith("jct: ") for line in rec["lines"])
        if rec["costs"]:
            assert len(rec["costs"]) == 8
            assert rec["costs"] == sets["default"]["costs"]
    assert sets["fused"]["metrics"]["prefix_hits"] > 0
    assert sets["fused"]["metrics"]["fused_slices"] > 0
    assert sets["tooluse"]["metrics"]["suspend_spills"] > 0
    assert any(line.startswith("latency: ") for line in sets["sim"]["lines"])
    assert len(sets["fleet"]["metrics"]["per_replica"]) == 2


def test_chaos_crash_lands_inside_the_run():
    """The chaos seed's crash falls while the crashed replica serves an
    agent, long before the drain; the JAX fleet declares no failure all
    the same (see ``scripts/record_jax_examples.py``)."""
    rec = RECORD["serve_agents"]["chaos"]
    (chaos,) = [x for x in rec["lines"] if x.startswith("chaos: ")]
    replica, at = chaos.split()[2], float(chaos.split("t=")[1].split("s")[0])
    busy = []
    for aid, rows in rec["events"].items():
        times = [r[1] for r in rows]
        served = {r[2] for r in rows if r[0] == "RequestAdmitted"}
        if served == {int(replica)} and min(times) < at < max(times):
            busy.append(aid)
    assert busy, (replica, at)
    assert rec["metrics"]["replica_failures"] == 0
    assert rec["metrics"]["live_replicas"] == 2
