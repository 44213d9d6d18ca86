"""The port's replicated fleet (``repro_torch.api.ReplicatedBackend``)
against the JAX package's, and the kernel build and launch counts under
the fleet's threads (CPU).

* The record's fleet run (2 replicas, round robin, on reduced granite-3-2b
  with parameters bridged from JAX) at ``fleet_workers`` 1 and 2: finish,
  JCT, each engine's counters and every agent's event sequence, replica
  included, exactly equal to the JAX fleet's and to the record; every
  stream obeys the event grammar with the replica set.
* A 2-replica sim fleet under justitia is float-identical to the JAX one.
* ``kernels.ops``: ``kernel_library`` called from several threads at once
  builds each source once and loads each library once (``nvcc`` and
  ``ctypes`` faked: there is no ``nvcc`` here), and the launch counts lose
  no count under threads.
"""

import ctypes
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest

from repro import api as jax_api
from repro_torch import api
from repro_torch.kernels import ops
from test_torch_api import (
    RECORD,
    assert_conformant_stream,
    bridged,
    engine_demands,
    sim_rows,
    smoke,
    token_match,
    MIN_TOKEN_MATCH,
    VOCAB,
)

FLEET = smoke.API_RUNS["fleet"]


@pytest.fixture(scope="module")
def fleet_runs():
    """The JAX fleet's run, and the port's at 1 and 2 worker threads."""
    jm, jp, tm, tp = bridged("granite-3-2b", vocab=VOCAB)
    return {
        "jax": smoke.serve_api(jax_api, jm, jp, FLEET),
        1: smoke.serve_api(api, tm, tp, FLEET, fleet_workers=1),
        2: smoke.serve_api(api, tm, tp, FLEET, fleet_workers=2),
    }


@pytest.mark.parametrize("workers", [1, 2])
def test_fleet_matches_jax(fleet_runs, workers):
    (want, jax_handles), (got, handles) = fleet_runs["jax"], \
        fleet_runs[workers]
    assert smoke.record_diff(got, want) == ""
    assert smoke.record_diff(got, RECORD["runs"]["fleet"]) == ""
    match = token_match(handles, jax_handles)
    assert match >= MIN_TOKEN_MATCH, f"token match rate {match:.3f}"


@pytest.mark.parametrize("workers", [1, 2])
def test_fleet_streams_conform(fleet_runs, workers):
    _, handles = fleet_runs[workers]
    replicas = set()
    for h in handles:
        assert_conformant_stream(h, expect_replica=True,
                                 token_demands=engine_demands(h.spec))
        replicas.add(h.events[0].replica)
    assert replicas == {0, 1}


@pytest.mark.parametrize("router", ["round_robin", "least_loaded"])
@pytest.mark.parametrize("workers", [None, 2])
def test_sim_fleet_matches_jax(router, workers):
    """A 2-replica sim fleet under justitia: finish, JCT, makespan, swaps
    and every event (replica included) float-identical."""
    out = []
    kw = {} if workers is None else {"fleet_workers": workers}
    for pkg in (jax_api, api):
        specs = pkg.specs_from_classes(np.random.default_rng(9), 40, 20.0)
        svc = pkg.AgentService.sim("justitia", replicas=2, router=router,
                                   total_kv=6000.0, token_events=True, **kw)
        try:
            out.append(sim_rows(svc, svc.submit_many(specs)))
        finally:
            svc.backend.close()
    assert out[1] == out[0]


# -------------------------------------------------- the kernels' threads


class _FakeProc:
    """Stands in for an ``nvcc`` process: writes its ``-o`` target after a
    pause long enough for other threads to arrive."""

    started = []

    def __init__(self, cmd, **kw):
        self.out = cmd[cmd.index("-o") + 1]
        self.returncode = 0
        _FakeProc.started.append(cmd[-1])

    def communicate(self):
        time.sleep(0.05)
        with open(self.out, "wb") as f:
            f.write(b"\0")
        return "ptxas info: fake\n", None


class _FakeLib:
    loaded = []

    def __init__(self, path):
        _FakeLib.loaded.append(path)

    def __getattr__(self, name):
        return types.SimpleNamespace(name=name)


def test_kernel_library_builds_and_loads_once_under_threads(monkeypatch,
                                                            tmp_path):
    _FakeProc.started, _FakeLib.loaded = [], []
    monkeypatch.setattr(ops, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(ops, "_LIBRARY", {})
    monkeypatch.setattr(ops, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "Popen", _FakeProc)
    monkeypatch.setattr(ctypes, "CDLL", _FakeLib)
    barrier = threading.Barrier(4)
    got, errors = [], []

    def call():
        try:
            barrier.wait(timeout=10)
            got.append(ops.kernel_library())
        except Exception as exc:  # reported below
            errors.append(exc)

    threads = [threading.Thread(target=call) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(got) == 4 and all(g is got[0] for g in got)
    sources = sorted(str(m.SOURCE) for m in ops._KERNELS.values())
    assert sorted(_FakeProc.started) == sources
    assert sorted(_FakeLib.loaded) == sorted(
        str(ops._library_path(m.SOURCE)) for m in ops._KERNELS.values())
    assert set(got[0]) == set(ops._KERNELS)
    assert not list(tmp_path.glob("*.tmp"))
    # built libraries are loaded, not built again, by the next process
    monkeypatch.setattr(ops, "_LIBRARY", {})
    ops.kernel_library()
    assert len(_FakeProc.started) == len(sources)


def test_launch_counts_lose_nothing_under_threads():
    """Eight threads raise the three counts together, the interpreter
    switching threads as often as it can: every count arrives."""
    per, n = 30000, 8
    wrappers = (ops.paged_gqa_decode, ops.flash_prefill, ops.mlstm_chunk)
    interval = sys.getswitchinterval()
    barrier = threading.Barrier(n)
    ops.reset_launch_counts()
    try:
        sys.setswitchinterval(1e-6)

        def raise_counts():
            barrier.wait(timeout=10)
            for i in range(per):
                ops._count(wrappers[i % 3])

        threads = [threading.Thread(target=raise_counts) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert [w.launches for w in wrappers] == [
            n * len(range(k, per, 3)) for k in range(3)]
    finally:
        sys.setswitchinterval(interval)
        ops.reset_launch_counts()
    assert [w.launches for w in wrappers] == [0, 0, 0]
