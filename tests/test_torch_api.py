"""The port's serving API (``repro_torch.api``, ``.sim``, ``.workloads``,
``.launch.serve``) against the JAX package's on the same seeded workloads
(CPU).

* Engine runs: the runs of ``chip_smoke.API_RUNS`` through
  ``AgentService.engine`` on reduced granite-3-2b (vocab 512, float32) with
  parameters bridged from the JAX model, and reduced xlstm-350m on the open
  workload.  Finish, JCT, engine counters and every agent's event sequence
  (tokens left out) must be exactly equal; sampled tokens are reported as
  a match rate for granite (float32 logits from XLA and PyTorch differ in
  the last bits, which can flip a near-tie) and must be equal for xLSTM,
  as in ``tests/test_torch_engine.py``.
* The record: ``tests/torch_api_jax_runs.json`` regenerates unchanged from
  the JAX package, and the port's own runs at two configs (reduced
  float32, and a wider bfloat16 one) equal it, which is why it can hold
  the full-width bfloat16 model on the card (``chip_smoke.py`` phase 7).
* The sim backend, the launchers, the refused flags, and a port copy of the
  event grammar of ``tests/test_event_conformance.py``.
"""

import contextlib
import importlib.util
import io
import json
import sys
from pathlib import Path
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from repro import api as jax_api
from repro.configs import get_config
from repro.launch import serve as jax_serve
from repro.models import Model as JaxModel
from repro_torch import api
from repro_torch.api import (
    AdmissionDeferred,
    AgentArrived,
    AgentCompleted,
    AgentRequeued,
    AgentResumed,
    AgentSuspended,
    RequestAdmitted,
    RequestSwappedIn,
    RequestSwappedOut,
    StageCompleted,
    TokenGenerated,
)
from repro_torch.configs import get_config as torch_get_config
from repro_torch.launch import serve
from repro_torch.models import Model
from repro_torch.models.params import params_from_jax

ROOT = Path(__file__).resolve().parent.parent
VOCAB = 512
#: floor on the granite sampled-token match rate (a sanity bound, not a
#: gate; tests/test_torch_engine.py's)
MIN_TOKEN_MATCH = 0.9
#: a wider bfloat16 granite: the record must not depend on width or dtype
WIDE_BF16 = dict(d_model=256, n_heads=8, n_kv_heads=2, head_dim=64,
                 d_ff=512, vocab=4096, dtype="bfloat16")


def load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


smoke = load("chip_smoke", ROOT / "chip_smoke.py")
recorder = load("record_jax_api_runs",
                ROOT / "scripts" / "record_jax_api_runs.py")
RECORD = json.loads(smoke.API_RECORD.read_text())
SINGLE_RUNS = [n for n, r in smoke.API_RUNS.items() if "replicas" not in
               r.get("service", {})]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny tensors: one intra-op thread per test worker is faster and
    keeps the workers from oversubscribing the cores.  Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bridged(arch: str, **over):
    """The reduced JAX model and parameters, and the port's model on the
    CPU with the same parameters."""
    jm = JaxModel(get_config(arch).reduced(**over))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(torch_get_config(arch).reduced(**over), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def granite():
    return bridged("granite-3-2b", vocab=VOCAB)


@pytest.fixture(scope="module")
def jax_runs(granite):
    """Every run of the record, served by the JAX engine."""
    jm, jp, _, _ = granite
    return recorder.jax_runs(smoke, jm, jp)


@pytest.fixture(scope="module")
def port_runs(granite):
    """The single-engine runs, served by the port on bridged parameters."""
    _, _, tm, tp = granite
    return {name: smoke.serve_api(api, tm, tp, smoke.API_RUNS[name])
            for name in SINGLE_RUNS}


def token_match(handles_a, handles_b) -> float:
    a, b = smoke.sampled_tokens(handles_a), smoke.sampled_tokens(handles_b)
    assert {k: len(v) for k, v in a.items()} == \
        {k: len(v) for k, v in b.items()}
    flat_a = np.concatenate([a[k] for k in sorted(a)])
    flat_b = np.concatenate([b[k] for k in sorted(b)])
    return float(np.mean(flat_a == flat_b))


# ----------------------------------------------------------- the record


def test_record_regenerates_unchanged(jax_runs):
    """The committed record is what the JAX package gives today."""
    assert recorder.build_record(smoke, jax_runs) == RECORD


def test_record_covers_the_phase_7_runs():
    assert set(RECORD["runs"]) == set(smoke.API_RUNS)
    assert set(RECORD["launcher"]) == set(smoke.LAUNCHER_ARCHS)
    closed, tooluse = RECORD["runs"]["closed"], RECORD["runs"]["tooluse"]
    assert closed["counters"][0]["swaps"] >= 1
    assert tooluse["counters"][0]["suspensions"] == 4
    assert tooluse["counters"][0]["suspend_spills"] == 4
    assert len(RECORD["runs"]["fleet"]["counters"]) == 2


@pytest.mark.parametrize("config", ["f32", "bf16-wide"])
@pytest.mark.parametrize("run", list(smoke.API_RUNS))
def test_port_record_holds_at_two_configs(config, run):
    """The port's own parameters (not JAX's), at reduced float32 and at a
    wider bfloat16 config, give the record exactly: it depends neither on
    width, dtype nor token values."""
    over = dict(vocab=VOCAB) if config == "f32" else WIDE_BF16
    model = Model(torch_get_config("granite-3-2b").reduced(**over),
                  device="cpu")
    got, _ = smoke.serve_api(api, model, model.init(seed=0),
                             smoke.API_RUNS[run])
    assert smoke.record_diff(got, RECORD["runs"][run]) == ""


# ----------------------------------------------------------- engine runs


@pytest.mark.parametrize("run", SINGLE_RUNS)
def test_engine_run_matches_jax(jax_runs, port_runs, run):
    (want, jax_handles), (got, handles) = jax_runs[run], port_runs[run]
    assert smoke.record_diff(got, want) == ""
    match = token_match(handles, jax_handles)
    assert match >= MIN_TOKEN_MATCH, f"token match rate {match:.3f}"


def test_xlstm_open_run_matches_jax():
    """Reduced xlstm-350m on the open workload: equal records and every
    sampled token equal."""
    jm, jp, tm, tp = bridged("xlstm-350m", vocab=VOCAB)
    run = smoke.API_RUNS["open"]
    want, jax_handles = smoke.serve_api(jax_api, jm, jp, run)
    got, handles = smoke.serve_api(api, tm, tp, run)
    assert got == want
    assert want["finish"] == RECORD["runs"]["open"]["finish"]
    assert smoke.sampled_tokens(handles) == smoke.sampled_tokens(jax_handles)


@pytest.mark.parametrize("flag", ["prefix_cache", "fused_prefill"])
def test_unported_flags_raise_through_the_api(granite, flag):
    _, _, tm, tp = granite
    with pytest.raises(NotImplementedError, match="not ported"):
        api.AgentService.engine(tm, tp, "justitia", **{flag: True})
    with pytest.raises(NotImplementedError, match="not ported"):
        api.service_for_backend("engine", "justitia", device="cpu",
                                **{flag: True})


def test_no_device_named_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.service_for_backend("engine", "justitia")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--backend", "engine"])


# ------------------------------------------------------------ sim backend


def sim_rows(service, handles):
    res = service.drain()
    return (res.finish, res.jct, res.makespan, res.swaps,
            {h.agent_id: [smoke.event_row(e) for e in h.events]
             for h in handles})


@pytest.mark.parametrize("workload", ["open", "closed", "tooluse"])
@pytest.mark.parametrize("token_events", [False, True])
def test_sim_backend_matches_jax(workload, token_events):
    """``SimBackend`` under justitia is float-identical to the JAX
    package's: finish, JCT, makespan, swaps and every event."""
    out = []
    for pkg in (jax_api, api):
        rng = np.random.default_rng(5)
        if workload == "open":
            specs = pkg.specs_from_classes(rng, 40, 20.0)
        else:
            kw = ({"classes": ("chat", "react", "tooluse")}
                  if workload == "tooluse" else {})
            specs = pkg.specs_from_closed_loop(rng, 12, 20.0, **kw)
        svc = pkg.AgentService.sim("justitia", total_kv=6000.0,
                                   token_events=token_events)
        out.append(sim_rows(svc, svc.submit_many(specs)))
    assert out[1] == out[0]


# -------------------------------------------------------------- launchers


def launcher_output(main, argv=None) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return smoke.launcher_lines(buf.getvalue())


@pytest.mark.parametrize("arch", list(smoke.LAUNCHER_ARCHS))
def test_engine_launcher_matches_jax(arch):
    """``--backend engine --device cpu`` prints the JAX launcher's lines
    (the record holds them; ``test_record_regenerates_unchanged`` runs the
    JAX launcher)."""
    got = launcher_output(serve.main, ["--backend", "engine", "--device",
                                       "cpu", "--arch", arch])
    assert got == RECORD["launcher"][arch]


@pytest.mark.parametrize("extra", [[], ["--replicas", "2"]],
                         ids=["single", "fleet"])
def test_sim_launcher_matches_jax(extra):
    argv = ["--backend", "sim", *extra]
    with mock.patch.object(sys, "argv", ["repro.launch.serve", *argv]):
        want = launcher_output(lambda _: jax_serve.main())
    assert want["completions"].startswith("completions: {0:")
    assert launcher_output(serve.main, argv) == want


# ---------------------------------------------------- event conformance


def assert_conformant_stream(
    handle, *, expect_replica=False, token_demands=None, expect_tokens=True,
    allow_requeue=False,
):
    """The lifecycle grammar of ``tests/test_event_conformance.py``
    (``assert_conformant_stream``), copied against the port's event
    classes: Arrival <= Admit <= (Swap)* <= StageComplete* <=
    (Suspended <= Resumed)* <= AgentComplete, timestamps monotone, token
    counts per request equal to the decode demands, the replica set on
    every fleet event.  Returns the stage count on the final replica."""
    evs = handle.events
    aid = handle.agent_id
    assert evs, f"agent {aid}: no events recorded"
    assert isinstance(evs[0], AgentArrived), f"agent {aid}: first event"
    assert isinstance(evs[-1], AgentCompleted), f"agent {aid}: last event"
    assert sum(isinstance(e, AgentArrived) for e in evs) == 1
    assert sum(isinstance(e, AgentCompleted) for e in evs) == 1

    times = [e.time for e in evs]
    for a, b in zip(times, times[1:]):
        assert b >= a - 1e-9, f"agent {aid}: time went backwards {a}->{b}"

    admitted: set = set()
    swapped_out: dict = {}
    token_counts: dict = {}
    stages_seen = 0
    requeues = 0
    suspended = False
    suspensions = 0
    resumes = 0
    prev_ev = evs[0]
    cur_replica = evs[0].replica
    for ev in evs[1:-1]:
        assert ev.agent_id == aid
        if expect_replica:
            assert ev.replica is not None, f"agent {aid}: {ev} lacks replica"
        if suspended:
            assert isinstance(ev, (AgentResumed, AgentRequeued)), (
                f"agent {aid}: {type(ev).__name__} emitted while suspended"
            )
        if isinstance(ev, AgentSuspended):
            assert isinstance(prev_ev, StageCompleted), (
                f"agent {aid}: AgentSuspended after {type(prev_ev).__name__}"
            )
            assert ev.until >= ev.time - 1e-9, (
                f"agent {aid}: suspension resumes in the past"
            )
            suspended = True
            suspensions += 1
            prev_ev = ev
            continue
        if isinstance(ev, AgentResumed):
            assert suspended, f"agent {aid}: AgentResumed without suspension"
            suspended = False
            resumes += 1
            prev_ev = ev
            continue
        prev_ev = ev
        if isinstance(ev, AgentRequeued):
            assert allow_requeue, f"agent {aid}: unexpected AgentRequeued"
            suspended = False
            if expect_replica:
                assert ev.from_replica == cur_replica
                assert ev.replica != ev.from_replica
            cur_replica = ev.replica
            admitted = set()
            swapped_out = {}
            stages_seen = 0
            requeues += 1
            continue
        if expect_replica and cur_replica is not None:
            assert ev.replica == cur_replica, (
                f"agent {aid}: {ev} on replica {ev.replica}, expected "
                f"{cur_replica}"
            )
        if isinstance(ev, AdmissionDeferred):
            assert ev.rid not in admitted
        elif isinstance(ev, RequestAdmitted):
            assert ev.rid not in admitted, f"agent {aid}: rid admitted twice"
            admitted.add(ev.rid)
        elif isinstance(ev, RequestSwappedOut):
            assert ev.rid in admitted, f"agent {aid}: swap-out before admit"
            assert not swapped_out.get(ev.rid)
            swapped_out[ev.rid] = True
        elif isinstance(ev, RequestSwappedIn):
            assert swapped_out.get(ev.rid), f"agent {aid}: swap-in first"
            swapped_out[ev.rid] = False
        elif isinstance(ev, TokenGenerated):
            assert ev.rid in admitted, f"agent {aid}: token before admit"
            assert not swapped_out.get(ev.rid)
            token_counts[ev.rid] = token_counts.get(ev.rid, 0) + 1
        elif isinstance(ev, StageCompleted):
            assert ev.stage == stages_seen, (
                f"agent {aid}: stage {ev.stage} completed out of order"
            )
            stages_seen += 1
    assert stages_seen >= 1, f"agent {aid}: no StageCompleted"
    assert not any(swapped_out.values())
    assert not suspended, f"agent {aid}: completed while suspended"
    if requeues == 0:
        assert suspensions == resumes
    if expect_tokens:
        assert token_counts, f"agent {aid}: no TokenGenerated events"
    if token_demands is not None and requeues == 0:
        assert sorted(token_counts.values()) == sorted(token_demands)
    return stages_seen


def engine_demands(spec, token_scale: int = smoke.API_SERVE["token_scale"]):
    """An open spec's decode demands at engine scale (EngineBackend's
    ``_scale_spec`` rule)."""
    return [max(1, int(round(s.decode / token_scale)))
            for stage in spec.stages for s in stage]


@pytest.mark.parametrize("run", SINGLE_RUNS)
def test_port_engine_streams_conform(port_runs, run):
    _, handles = port_runs[run]
    open_loop = smoke.API_RUNS[run]["workload"] == "open"
    for h in handles:
        stages = assert_conformant_stream(
            h, token_demands=engine_demands(h.spec) if open_loop else None)
        if open_loop:
            assert stages == len(h.spec.stages)
    if run == "tooluse":
        assert sum(isinstance(e, AgentSuspended)
                   for h in handles for e in h.events) == 4
