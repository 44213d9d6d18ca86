"""One run of one benchmark cell.

The system under test is ``repro_torch``'s serving path:
``AgentService`` over ``EngineBackend``, which wraps
``repro_torch.engine.ServeEngine``, under the justitia scheduler, with the
engine's decode windows sized as the engine sizes them.  A run:

1. makes the weights on the device from ``--seed`` (the configuration's
   ``families/<family>.py``) and fits the port's cost predictor on the
   mix's history;
2. warms up the shapes the cell's traffic uses (the kernels' build and
   load, the largest prefill passes, a decode window);
3. serves the mix in wall time for ``--seconds`` (``traffic/<kind>.py``
   decides when an agent falls due): an agent is submitted once its due
   time has passed, between two engine steps (one admission
   pass and one decode window each), with its arrival at the service's
   clock; lifecycle callbacks stamp wall time;
4. serves every agent submitted in the window to completion, by a
   deadline one more ``--seconds`` after it; an agent still unfinished
   then is ``failed``;
5. frees the program's state and judges what it served against the plain
   reference (``reference/<family>.py``) in float32.

With ``trace=True`` the run also wraps the engine's admission, prefill
and decode-window methods and the kernel wrappers in spans
(``spans.py``), profiles a steady few seconds of the window with
``torch.profiler``, and reads the per-layer metrics from them
(``metrics/<name>.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from traffic import generator

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: seconds the profiler covers in a traced run, from 40 % into the window
TRACE_SECONDS = 4.0
TRACE_START = 0.4
#: requests the output check compares, the longest among them
CHECK_REQUESTS = 12
#: the largest prefill batch warmed up (a pass pads to a power of two)
WARM_BATCH = 64


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_of(name: str, bench: Optional[dict] = None) -> dict:
    bench = bench or benchmark()
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def load_config(name: str) -> dict:
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def family_of(cfg: dict):
    """The configuration's family module, ``families/<family>.py``: its
    weights, its fields in the port's registry, its FLOPs."""
    return importlib.import_module(f"families.{cfg['family']}")


def reference_of(cfg: dict):
    """The family's plain reference, ``reference/<family>.py``."""
    return importlib.import_module(f"reference.{cfg['family']}")


def port_config(cfg: dict, strict: bool = True):
    """The port's ``ModelConfig`` of ``cfg``: the registry's entry for
    ``cfg["arch"]``, which has to hold the sizes that the file states
    (``strict``), or that entry resized to them (a rehearsal at reduced
    width).  The family module says which fields the file sets."""
    from repro_torch.configs import get_config

    base = get_config(cfg["arch"])
    want = family_of(cfg).port_fields(cfg)
    if not strict:
        return dataclasses.replace(base, **want)
    diff = {k: (getattr(base, k), v) for k, v in want.items()
            if getattr(base, k) != v}
    if diff:
        raise ValueError(f"the port's {cfg['arch']} differs from the "
                         f"benchmark's file: {diff}")
    return base


def _dtype(name: str):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def _bucket(n: int) -> int:
    return -(-max(n, 1) // 64) * 64


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Records:
    """What the lifecycle callbacks saw, stamped on the host's wall clock
    (``time.perf_counter``), plus the first token of each request, which
    the engine samples in its prefill pass and feeds to the first decode
    step without an event."""

    def __init__(self):
        self.agents: dict[int, generator.Agent] = {}
        self.due: dict[int, float] = {}
        self.submit: dict[int, float] = {}
        self.pred: dict[int, float] = {}
        self.done: dict[int, float] = {}
        self.stage_done: dict[int, dict[int, float]] = {}
        self.rids: dict[int, list[int]] = {}
        self.admit: dict[int, float] = {}
        self.tokens: dict[int, list[int]] = {}
        self.first: dict[int, int] = {}
        self.prompt: dict[int, np.ndarray] = {}
        self.swapped: set[int] = set()
        self.n_tokens = 0

    def hooks(self):
        from repro_torch.api import AgentHooks

        return AgentHooks(on_admit=self.on_admit, on_token=self.on_token,
                          on_swap=self.on_swap,
                          on_stage_complete=self.on_stage_complete,
                          on_complete=self.on_complete)

    def on_admit(self, ev) -> None:
        self.admit.setdefault(ev.rid, time.perf_counter())
        self.rids.setdefault(ev.agent_id, []).append(ev.rid)

    def on_token(self, ev) -> None:
        self.tokens.setdefault(ev.rid, []).append(int(ev.token))
        self.n_tokens += 1

    def on_swap(self, ev) -> None:
        self.swapped.add(ev.rid)

    def on_stage_complete(self, ev) -> None:
        self.stage_done.setdefault(ev.agent_id, {})[ev.stage] = (
            time.perf_counter())

    def on_complete(self, ev) -> None:
        self.done[ev.agent_id] = time.perf_counter()

    def inference_of(self, aid: int) -> dict[int, tuple[int, int]]:
        """rid -> (stage, index): the engine numbers a stage's requests
        consecutively, in order, and a later stage's after them."""
        flat = [(s, j) for s, stage in enumerate(self.agents[aid].stages)
                for j in range(len(stage))]
        return dict(zip(sorted(self.rids.get(aid, [])), flat))


class Run:
    """One run of ``cell`` (a ``BENCHMARK.json`` workload entry).

    ``device`` is ``"cuda"`` on the card.  A rehearsal passes ``"cpu"``,
    where the kernels' plain versions run, with ``overrides`` that shrink
    the configuration (``"config"``) and the mix (``"traffic"``, including
    its ``"engine"``) and a ``limit`` for the output check."""

    def __init__(self, cell: dict, seed: int, seconds: float, *,
                 trace: bool = False, device: str = "cuda",
                 overrides: Optional[dict] = None,
                 started: Optional[float] = None):
        overrides = overrides or {}
        self.t_process = time.perf_counter() if started is None else started
        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.trace = bool(trace)
        self.device = torch.device(device)
        self.cfg = {**load_config(cell["config"]),
                    **overrides.get("config", {})}
        mix = generator.load(cell["traffic"])
        over = dict(overrides.get("traffic", {}))
        engine = {**mix["engine"], **over.pop("engine", {})}
        self.mix = {**mix, **over, "engine": engine}
        self.strict = not overrides.get("config")
        self.limit = overrides.get(
            "limit", self.cfg.get("check", {}).get("served_gap_limit"))
        self.rec = Records()
        self.tracer = None

    # ------------------------------------------------------------ set-up

    def setup(self) -> None:
        from repro_torch.api import AgentService, EngineBackend
        from repro_torch.models import Model
        from repro_torch.predictor import AgentCostPredictor

        cfg, mix, eng = self.cfg, self.mix, self.mix["engine"]
        self.phases = {"imports": time.perf_counter() - self.t_process}
        mark = time.perf_counter()

        def phase(name: str) -> None:
            nonlocal mark
            self._sync()
            now = time.perf_counter()
            self.phases[name] = now - mark
            mark = now

        self.port_cfg = port_config(cfg, strict=self.strict)
        self.family = family_of(cfg)
        self.params = self.family.params(cfg, self.seed, self.device,
                                         _dtype(cfg["dtype"]))
        phase("weights")
        pmix = mix["predictor"]
        self.predictor = AgentCostPredictor(
            max_features=int(pmix["max_features"]), device=self.device)
        self.predictor.fit(generator.predictor_history(mix),
                           epochs=int(pmix["epochs"]))
        phase("predictor")
        self.source = generator.source(mix, self.seed, self.seconds,
                                       int(cfg["vocab_size"]))
        self.model = Model(self.port_cfg, device=self.device)
        self.backend = EngineBackend(
            self.model, self.params, eng.get("scheduler", "justitia"),
            pool_tokens=int(eng["pool_tokens"]),
            max_batch=int(eng["max_batch"]),
            cache_len=int(eng["cache_len"]),
            prefill_chunk=int(eng["prefill_chunk"]),
            max_window=int(eng["max_window"]),
            token_scale=1, time_scale=1.0, seed=self.seed)
        self.engine = self.backend.engine
        self.service = AgentService(self.backend, record_events=False)
        self._watch_prefill()
        phase("engine")
        if self.trace:
            import spans

            self.tracer = spans.Tracer(self)
            self.tracer.install()
        self._warm_up(_bucket(self.source.longest))
        gc.collect()
        gc.freeze()
        phase("warm_up")
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()

    def _watch_prefill(self) -> None:
        """Record each admitted request's first token (the prefill pass's
        sample, which the engine keeps host-side) and its prompt."""
        eng, rec = self.engine, self.rec
        inner = eng._prefill_batch

        def prefill_batch(batch):
            inner(batch)
            for req in batch:
                rec.first[req.rid] = int(eng.slot_last_tok[req.slot])
                rec.prompt[req.rid] = req.prompt

        eng._prefill_batch = prefill_batch

    def _warm_up(self, longest_bucket: int) -> None:
        """Build and load the kernels, run the prefill passes at the shapes
        that grow the device's memory the most (the largest batch at the
        longest bucket of each prefill path) and a two-step decode window.
        The passes write no slot (every slot index lies past the cache)
        and the window runs every slot frozen; a slot is written whole
        when it is admitted, so nothing of it reaches the served work."""
        from repro_torch.engine import engine as engine_mod

        eng = self.engine
        eng.warmup()
        b = min(eng.max_batch, WARM_BATCH)
        b = 1 << (b.bit_length() - 1)
        chunk = eng.prefill_chunk
        shapes = {(1, 64), (b, min(longest_bucket, _bucket(chunk))),
                  (b, longest_bucket)}
        dev = self.device
        for k, s in sorted(shapes):
            engine_mod._prefill_write(
                self.model, eng.cache_len, chunk, self.params, eng.cache,
                torch.zeros((k, s), dtype=torch.int32, device=dev),
                torch.full((k,), s, dtype=torch.int32, device=dev),
                np.full(k, eng.max_batch, np.int32))
        state = torch.zeros((3, eng.max_batch), dtype=torch.int32,
                            device=dev)
        engine_mod._decode_window(self.model, min(2, eng.max_window),
                                  self.params, eng.cache, state)[1].cpu()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    # ------------------------------------------------------------ serving

    def _submit(self, agent: generator.Agent, due: float) -> int:
        from repro_torch.api import AgentSpec
        from repro_torch.core.cost import InferenceSpec

        pred = float(self.predictor.predict(agent.cls, agent.text))
        spec = AgentSpec(
            stages=[[InferenceSpec(p, d) for p, d in stage]
                    for stage in agent.stages],
            arrival=self.service.now, predicted_cost=pred,
            true_cost=agent.true_cost, name=agent.cls,
            prompts=agent.prompts)
        t = time.perf_counter()
        handle = self.service.submit(spec, hooks=self.rec.hooks())
        aid = handle.agent_id
        rec = self.rec
        rec.agents[aid], rec.due[aid], rec.submit[aid] = agent, due, t
        rec.pred[aid] = pred
        return aid

    def span(self, name: str):
        """The tracer's span ``name``, or nothing when tracing is off."""
        if self.tracer is None:
            return contextlib.nullcontext()
        return self.tracer.span(name)

    def submit(self, agent, due: float) -> int:
        with self.span("harness.submit"):
            return self._submit(agent, due)

    def step(self) -> None:
        with self.span("engine.step"):
            self.engine.step()

    def wait(self, until: float) -> None:
        """Idle until ``until`` (perf_counter seconds) or 10 ms."""
        dt = min(until - time.perf_counter(), 0.01)
        if dt <= 0:
            return
        with self.span("harness.wait"):
            time.sleep(dt)

    def serve(self) -> None:
        t0 = time.perf_counter()
        self.t0 = t0
        self.setup_s = t0 - self.t_process
        self.end = t0 + self.seconds
        if self.tracer is not None:
            self.tracer.plan(t0 + TRACE_START * self.seconds, TRACE_SECONDS)
        src = self.source
        while src.offer(self, time.perf_counter()):
            if self.tracer is not None:
                self.tracer.tick()
            if self.engine.busy:
                self.step()
            else:
                self.wait(min(src.next_due(self), self.end))
        self.window_end = time.perf_counter()
        self.window_tokens = self.rec.n_tokens
        self.window_decode_steps = self.engine.metrics["decode_steps"]
        if self.tracer is not None:
            self.tracer.stop()
        # the profiler's stop in a traced run stalls serving for seconds:
        # the harness's own cost, so the drain gets that much longer
        stall = self.tracer.stop_s if self.tracer is not None else 0.0
        deadline = t0 + 2 * self.seconds + stall
        while self.engine.busy and time.perf_counter() < deadline:
            self.step()
        self.drain_end = time.perf_counter()
        self._sync()
        if self.device.type == "cuda":
            self.memory_peak = int(torch.cuda.max_memory_allocated())
        else:
            self.memory_peak = 0

    # ------------------------------------------------------------ results

    def attempted(self) -> list[int]:
        """Agents the window offered: every one submitted in it."""
        return sorted(self.rec.agents)

    def jcts(self) -> list[float]:
        """Wall seconds from each attempted agent's due time to its last
        token; an unfinished agent counts as above every finished one."""
        rec = self.rec
        done = [rec.done[a] - rec.due[a] for a in self.attempted()
                if a in rec.done]
        top = max(done, default=0.0)
        late = [max(top, self.drain_end - rec.due[a])
                for a in self.attempted() if a not in rec.done]
        return done + late

    def end_to_end(self) -> dict:
        jct = self.jcts()
        window = self.window_end - self.t0
        return {
            "jct_mean_s": float(np.mean(jct)),
            "jct_p90_s": float(np.percentile(jct, 90)),
            "tokens_per_s": self.window_tokens / window,
            "setup_s": self.setup_s,
        }

    def lag(self) -> tuple[float, float]:
        """How late the generator submitted the window's agents: median and
        largest seconds past the due time."""
        rec = self.rec
        lags = [rec.submit[a] - rec.due[a] for a in self.attempted()]
        return statistics.median(lags), max(lags)

    # ------------------------------------------------------------ checks

    def free_program(self) -> None:
        """Drop the engine's cache and staging buffers (the weights, which
        the benchmark made, stay for the reference)."""
        eng = self.engine
        eng.cache = None
        eng._staging.clear()
        for req in eng.slot_req.values():
            req.swapped_kv = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def close(self) -> None:
        """Release everything the run holds on the device, for a caller
        that runs several in one process: the set-up froze the objects
        it made (``gc.freeze``), among them the engine with the prefill
        watcher that refers back to it."""
        self.free_program()
        self.engine.__dict__.pop("_prefill_batch", None)
        self.service = self.backend = self.engine = None
        self.model = self.params = self.predictor = None
        gc.unfreeze()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def count_errors(self) -> int:
        """Inferences of finished agents that did not serve exactly their
        requested tokens on exactly their prompt: a request missing, a
        token count other than the decode budget, no first token, or a
        prompt other than the one offered."""
        rec, errors = self.rec, 0
        for aid in self.attempted():
            if aid not in rec.done:
                continue
            agent = rec.agents[aid]
            where = rec.inference_of(aid)
            errors += abs(len(agent.inferences) - len(rec.rids.get(aid, [])))
            for rid, (s, j) in where.items():
                d = agent.stages[s][j][1]
                ok = (len(rec.tokens.get(rid, [])) == d
                      and rid in rec.first
                      and np.array_equal(rec.prompt.get(rid),
                                         agent.prompts[s][j]))
                errors += not ok
        return errors

    def sample(self) -> list[tuple[np.ndarray, list[int]]]:
        """(prompt, served tokens) of up to ``CHECK_REQUESTS`` finished
        requests: the longest, the longest prompt past one prefill chunk,
        one that was swapped out and in, and the rest drawn from the seed.
        The served tokens are the prefill's sample and every decoded one."""
        rec = self.rec
        cands = []
        for aid in self.attempted():
            if aid not in rec.done:
                continue
            agent = rec.agents[aid]
            for rid, (s, j) in rec.inference_of(aid).items():
                if rid in rec.first and rid in rec.tokens:
                    cands.append((rid, agent.prompts[s][j],
                                  [rec.first[rid]] + rec.tokens[rid]))
        if not cands:
            return []
        chunk = int(self.mix["engine"]["prefill_chunk"])
        picks = [max(cands, key=lambda c: len(c[1]) + len(c[2]))]
        long = [c for c in cands if len(c[1]) > chunk]
        if long:
            picks.append(max(long, key=lambda c: len(c[1])))
        swapped = [c for c in cands if c[0] in rec.swapped]
        if swapped:
            picks.append(swapped[0])
        rng = np.random.default_rng([self.seed, 11])
        for i in rng.permutation(len(cands)):
            if len(picks) >= CHECK_REQUESTS:
                break
            picks.append(cands[int(i)])
        seen, out = set(), []
        for rid, prompt, served in picks:
            if rid not in seen:
                seen.add(rid)
                out.append((prompt, served))
        return out

    def served_gaps(self, sample, control: bool = False) -> float:
        """The widest gap by which a served token's logit lies below the
        float32 reference's best at its position.  ``control``: the gap
        of the token the fp8 reference would put first there instead."""
        ref = reference_of(self.cfg)
        widest = 0.0
        for prompt, served in sample:
            p = len(prompt)
            seq = np.concatenate([prompt, np.asarray(served[:-1], np.int32)])
            toks = torch.from_numpy(seq.astype(np.int64)).to(self.device)
            logits = ref.logits(self.cfg, self.params, toks, first=p - 1)
            if control:
                pick = ref.logits(self.cfg, self.params, toks, first=p - 1,
                                  precision="fp8").argmax(-1)
            else:
                pick = torch.tensor(served, device=self.device)
            gap = logits.max(-1).values - logits.gather(
                1, pick[:, None]).squeeze(1)
            widest = max(widest, float(gap.max()))
        return widest

    def check(self) -> dict:
        """The numbers compared, each with its limit."""
        self.free_program()
        sample = self.sample()
        gap = self.served_gaps(sample)
        return {"served_gap": {"value": gap, "limit": self.limit},
                "count_errors": {"value": self.count_errors(), "limit": 0},
                "empty_sample": {"value": int(not sample), "limit": 0}}


def correct(checks: dict) -> bool:
    return all(c["limit"] is not None and c["value"] <= c["limit"]
               for c in checks.values())


def load_reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, kind: str) -> list[dict]:
    """The cell's metrics of ``kind`` (``end_to_end`` or ``per_layer``):
    those whose ``workloads`` name the cell, or that list none."""
    return [m for m in bench[kind]
            if cell in m.get("workloads", [cell])]


def execute(name: str, seed: int, seconds: float, trace: bool, *,
            device: str = "cuda", overrides: Optional[dict] = None,
            started: Optional[float] = None) -> tuple[dict, Run]:
    """Run the cell ``name`` and return the result line's fields (without
    ``device``, which the card's caller adds) and the run."""
    bench = benchmark()
    run = Run(cell_of(name, bench), seed, seconds, trace=trace,
              device=device, overrides=overrides, started=started)
    try:
        run.setup()
        run.serve()
    finally:
        if run.tracer is not None:
            run.tracer.uninstall()
    e2e = run.end_to_end()
    if trace:
        run.tracer.read()
        metrics = {}
        for m in cell_metrics(bench, name, "per_layer"):
            value = load_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell_metrics(bench, name, "end_to_end")}
    checks = run.check()
    attempted = run.attempted()
    out = {
        "correct": correct(checks),
        "attempted": len(attempted),
        "failed": sum(a not in run.rec.done for a in attempted),
        "metrics": metrics,
    }
    if run.tracer is not None and run.tracer.breakdown:
        out["breakdown"] = run.tracer.breakdown
    out["checks"] = checks
    return out, run
