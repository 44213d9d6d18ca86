"""BENCHMARK.json keeps the benchmark's contract, the harness finds every
cell's files by name, the traffic is deterministic per seed, and nothing
under ``bench/`` loads JAX or the JAX package.

    python -m pytest bench
"""

from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import numpy as np
import pytest

import harness
from traffic import generator

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|proj|_dim$|_rank$|"
                    r"head_dim|expansion|experts_per_tok|num_experts_per)")
CELLS = [c["name"] for c in SPEC["workloads"]]
PER_LAYER = [m["name"] for m in SPEC["per_layer"]]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def reports(cell: str, kind: str) -> set[str]:
    return {m["name"] for m in harness.cell_metrics(SPEC, cell, kind)}


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert not p.startswith("/") and (ROOT / p).is_dir()
        assert not p.endswith("_torch") and p != "benchmarks"
    cmd = SPEC["command"]
    assert 1 <= len(cmd) <= 32
    assert all(1 <= len(w) <= 200 and "\t" not in w and "\n" not in w
               for w in cmd)
    for word in cmd:
        if "/" in word and (ROOT / word).exists():
            assert any(word.startswith(p + "/") for p in SPEC["paths"])
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_full_check_fits_its_time_with_24_cells():
    runs = 2 + 14 * 24
    total = runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_names_and_units_use_only_the_allowed_characters():
    names = ([c["name"] for c in SPEC["configs"]] + CELLS
             + [m["name"] for m in SPEC["end_to_end"]] + PER_LAYER
             + [c["config"] for c in SPEC["workloads"]]
             + [c["traffic"] for c in SPEC["workloads"]]
             + [k for c in SPEC["configs"] for k in c["reduced"]])
    for name in names:
        assert NAME.match(name), name
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [e["name"] for e in SPEC[kind]]
        assert len(got) == len(set(got)), kind
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_entries_have_exactly_the_contract_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for c in SPEC["workloads"]:
        assert set(c) == {"name", "config", "traffic", "chips", "why"}
        assert c["chips"] in (1, 4) and 1 <= len(c["why"]) <= 200
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    for text in ([c["why"] for c in SPEC["configs"] + SPEC["workloads"]]
                 + [c["source"] for c in SPEC["configs"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}
    for cell in CELLS:
        e2e = reports(cell, "end_to_end")
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        assert reports(cell, "per_layer"), cell
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m.get("workloads", [])) <= set(CELLS), m["name"]


@pytest.mark.parametrize("name", PER_LAYER)
def test_per_layer_metric_moves_an_end_to_end_metric_its_cells_report(name):
    m = next(x for x in SPEC["per_layer"] if x["name"] == name)
    assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    for cell in m.get("workloads", CELLS):
        assert m["moves"] in reports(cell, "end_to_end"), (name, cell)
    assert callable(harness.load_reader(name))
    if name.split(".")[0].endswith("_roofline") or "mfu" in name:
        assert m["unit"] == "%"


def test_one_layer_name_per_layer_and_roofline_names():
    for m in SPEC["per_layer"]:
        if m["source"] == "device_trace" and "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    c = harness.cell_of(cell, SPEC)
    cfg = harness.load_config(c["config"])
    entry = next(x for x in SPEC["configs"] if x["name"] == c["config"])
    assert entry["file"] == f"bench/configs/{c['config']}.json"
    assert entry["reduced"] == cfg["reduced"]
    assert not any(WIDTHS.search(k) for k in entry["reduced"])
    assert entry["source"] == cfg["source"]
    assert harness.reference_of(cfg).logits
    assert callable(harness.family_of(cfg).params)
    port = harness.port_config(cfg)
    assert port.name == cfg["arch"]
    mix = generator.load(c["traffic"])
    assert {"engine", "predictor", "pool_seed", "classes"} <= set(mix)
    for p, d in (s for a in generator.agent_pool(mix, 10.0)
                 for st in a.stages for s in st):
        assert p + d + 1 <= mix["engine"]["cache_len"]


def test_configs_each_used_by_a_cell_with_their_own_file():
    used = {c["config"] for c in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))


def test_files_under_paths_are_named_from_name_characters():
    for path in BENCH.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel


@pytest.mark.parametrize("cell", CELLS)
def test_traffic_is_the_same_per_seed_and_the_same_work_across_seeds(cell):
    mix = generator.load(harness.cell_of(cell, SPEC)["traffic"])
    if mix["kind"] == "open_agents":
        a = generator.source(mix, 5, 20.0, 512).plan
        b = generator.source(mix, 5, 20.0, 512).plan
        c = generator.source(mix, 2**31 + 9, 20.0, 512).plan
        assert [t for t, _ in a] == [t for t, _ in c]
        assert ([x.index for _, x in a] == [x.index for _, x in b]
                != [x.index for _, x in c])
        assert (sorted(tuple(x.inferences) for _, x in a)
                == sorted(tuple(x.inferences) for _, x in c))
        pairs = [(x, y) for (_, x), (_, y) in zip(a, b)]
    else:
        qa = generator.source(mix, 5, 20.0, 512)
        qb = generator.source(mix, 5, 20.0, 512)
        qc = generator.source(mix, 2**31 + 9, 20.0, 512)
        pairs = [(qa.next(), qb.next()) for _ in range(20)]
        other = [qc.next() for _ in range(20)]
        assert [x.index for x, _ in pairs] != [x.index for x in other]
        assert qa.starts == qc.starts
    for x, y in pairs:
        assert x.index == y.index and x.text == y.text
        assert all(np.array_equal(p, q) for sp, sq in
                   zip(x.prompts, y.prompts) for p, q in zip(sp, sq))
    h1, h2 = generator.predictor_history(mix), generator.predictor_history(mix)
    assert h1 == h2 and set(h1) == {generator.class_name(c)
                                    for c in mix["classes"]}


#: the first queued cell's mix (PERF.md, Open questions), stated as data:
#: MRS map-stage prompts and short answers, in a class of the file's own
DOCS = {
    "kind": "closed_agents", "clients": 8, "stagger_s": 0.0,
    "pool_size": 64, "pool_seed": 20261019,
    "classes": [{
        "name": "MRSmap", "complexity_spread": 0.0,
        "keywords": ["summarize", "chunk", "mapreduce", "section"],
        "stages": [{"n_parallel": [2, 6],
                    "prefill": {"skew_normal": [2600, 600, 2.5],
                                "clip": [1024, 3584]},
                    "decode": {"uniform": [8, 48]}}]}],
    "predictor": {"history_per_class": 4, "epochs": 1, "max_features": 8},
    "engine": {"max_batch": 32, "cache_len": 4096, "pool_tokens": 131072,
               "prefill_chunk": 512, "max_window": 32},
}


def test_a_mix_states_its_own_classes_as_data():
    pool = generator.agent_pool(DOCS, 10.0)
    assert pool == generator.agent_pool(DOCS, 10.0) and len(pool) == 64
    prompts = [p for a in pool for p, _ in a.stages[0]]
    outputs = [d for a in pool for _, d in a.stages[0]]
    assert all(len(a.stages) == 1 and 2 <= len(a.stages[0]) <= 6
               for a in pool)
    assert 1024 <= min(prompts) and max(prompts) <= 3584
    assert 2600 < np.median(prompts) < 3584
    assert set(outputs) <= set(range(8, 49)) and len(set(outputs)) > 20
    assert all(a.name == "MRSmap" for a in pool)
    assert all(p + d + 1 <= DOCS["engine"]["cache_len"]
               for a in pool for p, d in a.stages[0])
    hist = generator.predictor_history(DOCS)
    assert set(hist) == {"MRSmap"} and len(hist["MRSmap"][1]) == 4
    src = generator.source(DOCS, 2**31 + 9, 10.0, 512)
    assert src.starts == [0.0] * 8 and src.longest == max(prompts)


def test_a_traffic_kind_is_found_by_name():
    assert generator.kind_of(DOCS).Source
    with pytest.raises(ValueError, match="sessions"):
        generator.kind_of({**DOCS, "kind": "sessions"})


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not (
                node.level):
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: p.relative_to(BENCH).as_posix())
def test_no_module_under_bench_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert _imports(path) <= {"__future__", "torch", "numpy", "math"}


def test_isolation_check_compares_whole_top_level_names():
    src = "import repro_torch.models\nfrom repro_torch import api\n"
    tmp = BENCH / "__pycache__"
    tmp.mkdir(exist_ok=True)
    probe = tmp / "probe_imports.py"
    probe.write_text(src)
    assert not _imports(probe) & FORBIDDEN
    probe.write_text("import repro.models\n")
    assert _imports(probe) & FORBIDDEN == {"repro"}
    probe.unlink()
