"""End-to-end example of the port: one workload spec, two backends, one
AgentService (the PyTorch counterpart of ``examples/serve_agents.py``).

    PYTHONPATH=src python examples/serve_agents_torch.py --backend engine
    PYTHONPATH=src python examples/serve_agents_torch.py --backend sim
    PYTHONPATH=src python examples/serve_agents_torch.py --device cpu

The full production path in miniature, on ``repro_torch``: the 9-class
agent workload sampler generates task-parallel agents with synthetic
prompts and bursty (Mooncake-like) arrival times; the per-class TF-IDF+MLP
predictor (paper §4.2), fitted at start on ``--device``, predicts each
agent's KV token-time at arrival; the scheduler (any name registered with
``@register_scheduler``) computes its priority keys; and
:class:`repro_torch.api.AgentService` streams the agents into the chosen
backend *online*: agents are submitted with future arrival times and enter
the system mid-run, like live traffic.

The flags are the JAX example's, plus ``--device``: the predictor and the
engine's model run on the CUDA card unless ``--device`` names another
device (``cpu``); with no device named and no CUDA device the example
raises.  ``--backend engine`` serves reduced h2o-danube-1.8b (or
``--arch``; granite-3-2b with ``--fused-prefill``) through the port's
engine and its CUDA kernels; ``--backend sim`` serves the same AgentSpec
list on the discrete-event cluster.  ``--replicas``, ``--router``,
``--stream``, ``--closed-loop``, ``--prefix-cache``, ``--fused-prefill``,
``--chaos``, the watchdog flags, ``--admission-watermark``,
``--suspend-retention``, ``--fleet-workers``, ``--steal-threshold``,
``--steal-interval`` and ``--closed-loop-classes`` mean what they mean in
the JAX example (see its docstring).

What is printed equals the JAX example's output for the same flags but for
the wall seconds, as long as the predicted costs are the same: the engine
clock counts iterations, which depend neither on the device, the width,
the dtype nor the sampled tokens.  The costs are the predictor's, and the
port's MLPs start from torch's draws, not JAX's, so a run that fits the
predictor (every run without ``--closed-loop``) may order near-tied agents
differently from the JAX example.

``main`` is plain functions that other programs reuse: ``parse_args``,
``build_specs`` (the predictor's fit included; ``fit`` takes another
predictor), ``build_service`` (``fault_plan`` and ``service_kwargs``
turn the flags into its arguments) and ``serve`` (the hooks and the
printing).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.api import (
    AgentHooks,
    FaultPlan,
    router_names,
    service_for_backend,
    specs_from_classes,
    specs_from_closed_loop,
)
from repro_torch.api.workload import DEFAULT_CLASSES
from repro_torch.core import scheduler_names
from repro_torch.device import resolve_device
from repro_torch.predictor import AgentCostPredictor
from repro_torch.workloads import sample_agent


def parse_args(argv=None) -> argparse.Namespace:
    """The JAX example's flags, plus ``--device``; the same refusals."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="engine",
                    choices=("engine", "sim"))
    ap.add_argument("--scheduler", default="justitia",
                    choices=scheduler_names())
    ap.add_argument("--n-agents", type=int, default=8)
    ap.add_argument("--window-s", type=float, default=30.0)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--router", default="memory_cost_aware",
                    choices=router_names())
    ap.add_argument("--stream", action="store_true",
                    help="per-token streaming on either backend (sim: "
                         "discretized token_events decode model)")
    ap.add_argument("--closed-loop", action="store_true",
                    help="serve the closed-loop session family (multi-turn "
                         "chat / react tool loops) instead of fixed graphs")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="prefix-aware KV reuse (engine: content-hash "
                         "block sharing; sim: analytic hit model)")
    ap.add_argument("--fused-prefill", action="store_true",
                    help="(engine) stream each admitted prompt into the "
                         "fused decode windows one chunk-slice per "
                         "iteration")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="(replicated fleets) inject a seeded FaultPlan "
                         "(one replica crashes mid-window) with the "
                         "progress watchdog armed")
    ap.add_argument("--watchdog-timeout", type=float, default=None,
                    metavar="S",
                    help="(replicated fleets) suspect a busy, lagging "
                         "replica after S seconds without progress "
                         "(--chaos default: 2%% of the window, min 0.25s)")
    ap.add_argument("--watchdog-retries", type=int, default=None,
                    help="suspect probes before a replica is declared "
                         "dead (fleet default: 3)")
    ap.add_argument("--watchdog-backoff", type=float, default=None,
                    help="multiplier between successive suspect probes "
                         "(fleet default: 2.0)")
    ap.add_argument("--admission-watermark", type=float, nargs=2,
                    default=None, metavar=("LOW", "HIGH"),
                    help="watermark admission control: defer admissions "
                         "when free pool drops below LOW (fraction), "
                         "resume above HIGH")
    ap.add_argument("--suspend-retention", default=None,
                    choices=("hold", "spill", "drop"),
                    help="KV retention for agents suspended through "
                         "tool-call think time")
    ap.add_argument("--fleet-workers", type=int, default=None, metavar="N",
                    help="(replicated fleets) advance the children "
                         "concurrently on an N-thread pool")
    ap.add_argument("--steal-threshold", type=float, default=None,
                    metavar="X",
                    help="(replicated fleets) migrate queued, never-"
                         "admitted agents off a replica whose backlog "
                         "exceeds X times the fleet mean (X > 1)")
    ap.add_argument("--steal-interval", type=float, default=None,
                    metavar="S",
                    help="workload seconds between stealing passes "
                         "(fleet default: 1.0)")
    ap.add_argument("--closed-loop-classes", default=None,
                    metavar="A,B,...",
                    help="comma-separated closed-loop family names for "
                         "--closed-loop")
    ap.add_argument("--arch", default=None,
                    help="engine model arch (default h2o-danube-1.8b; "
                         "granite-3-2b with --fused-prefill)")
    ap.add_argument("--device", default=None,
                    help="device of the predictor and the engine's model "
                         "(default: the CUDA card; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    if args.closed_loop_classes and not args.closed_loop:
        ap.error("--closed-loop-classes requires --closed-loop")
    if args.chaos is not None and args.replicas <= 1:
        ap.error("--chaos requires --replicas > 1")
    if args.watchdog_timeout is not None and args.replicas <= 1:
        ap.error("--watchdog-timeout requires --replicas > 1")
    if args.fleet_workers is not None and args.replicas <= 1:
        ap.error("--fleet-workers requires --replicas > 1")
    if args.steal_threshold is not None and args.replicas <= 1:
        ap.error("--steal-threshold requires --replicas > 1")
    if args.steal_interval is not None and args.steal_threshold is None:
        ap.error("--steal-interval requires --steal-threshold")
    return args


def predictor_history(rng: np.random.Generator) -> dict:
    """60 sampled agents of each default class: class -> (prompts, true
    costs), the predictor's training set."""
    samples = {}
    for cls in DEFAULT_CLASSES:
        hist = [sample_agent(rng, cls) for _ in range(60)]
        samples[cls] = ([a.prompt for a in hist],
                        [a.true_cost for a in hist])
    return samples


def fit_predictor(samples: dict, device) -> AgentCostPredictor:
    """The per-class MLP cost predictors, fitted on ``device``."""
    predictor = AgentCostPredictor(max_features=48, device=device)
    predictor.fit(samples, epochs=300)
    return predictor


def build_specs(args, device, fit=fit_predictor) -> list:
    """The seeded workload: closed-loop sessions, or sampled agents whose
    costs come from ``fit(predictor_history(rng), device)`` (any object
    with ``.predict(cls, prompt)``)."""
    rng = np.random.default_rng(0)
    if args.closed_loop:
        cl_kw = {}
        if args.closed_loop_classes:
            cl_kw["classes"] = tuple(
                c.strip() for c in args.closed_loop_classes.split(",")
                if c.strip()
            )
        return specs_from_closed_loop(
            rng, args.n_agents, args.window_s, **cl_kw
        )
    print("training per-class MLP cost predictors...")
    predictor = fit(predictor_history(rng), device)
    return specs_from_classes(
        rng, args.n_agents, args.window_s, predictor=predictor
    )


def fault_plan(args) -> tuple:
    """``--chaos``'s seeded plan (one crash in the middle half of the
    window; printed) and the watchdog timeout, each ``None`` where unset."""
    plan = None
    watchdog = args.watchdog_timeout
    if args.chaos is not None:
        lo, hi = 0.25 * args.window_s, 0.75 * args.window_s
        plan = FaultPlan.seeded(
            args.chaos, args.replicas, crash_window=(lo, hi)
        )
        if watchdog is None:
            watchdog = max(0.02 * args.window_s, 0.25)
        for f in plan.faults:
            print(f"chaos: replica {f.replica} {f.kind} at "
                  f"t={f.start:.1f}s (watchdog {watchdog:.2f}s)")
    return plan, watchdog


def service_kwargs(args, plan, watchdog) -> dict:
    """The ``service_for_backend`` arguments that the flags set."""
    return dict(
        replicas=args.replicas, router=args.router,
        stream=args.stream, prefix_cache=args.prefix_cache,
        fused_prefill=args.fused_prefill,
        fault_plan=plan, watchdog_timeout=watchdog,
        watchdog_retries=args.watchdog_retries,
        watchdog_backoff=args.watchdog_backoff,
        admission_watermark=(
            tuple(args.admission_watermark)
            if args.admission_watermark is not None else None
        ),
        suspend_retention=args.suspend_retention,
        fleet_workers=args.fleet_workers,
        steal_threshold=args.steal_threshold,
        steal_interval=args.steal_interval,
    )


def build_service(args, device):
    """The service the flags ask for (the engine's model on ``device``)."""
    arch = args.arch or (
        "granite-3-2b" if args.fused_prefill else "h2o-danube-1.8b"
    )
    plan, watchdog = fault_plan(args)
    return service_for_backend(
        args.backend, args.scheduler, arch=arch, pool_tokens=4096,
        device=device, **service_kwargs(args, plan, watchdog),
    )


def serve(args, service, specs):
    """Stream ``specs`` into ``service`` with the printing hooks, drain it
    and print the result; returns the drained result."""
    fleet = (f" x{args.replicas} replicas via {args.router}"
             if args.replicas > 1 else "")
    print(f"streaming {args.n_agents} agents into the {args.backend} "
          f"backend{fleet} ({args.scheduler} scheduler, online arrivals "
          f"over {args.window_s:.0f}s)...")
    # engine token counts are engine-scale: convert to workload scale so
    # the printed tok/s is comparable across backends (the sim has no
    # token_scale and streams full-scale counts)
    children = getattr(service.backend, "children", [service.backend])
    token_scale = getattr(children[0], "token_scale", 1)

    t0 = time.time()
    # TTFT/tok-s come straight off the service's MetricsRecorder, the same
    # fields latency_stats()/slo_stats() aggregate
    rec = service.recorder
    hit_tok: dict[int, list] = {}

    def on_prefix_hit(ev):
        hit_tok.setdefault(ev.agent_id, []).append((ev.cached, ev.prefill))

    def on_complete(ev):
        line = (
            f"  t={ev.time:7.1f}s agent {ev.agent_id} done "
            f"(jct {ev.jct:.1f}s"
            + (f", replica {ev.replica}" if ev.replica is not None else "")
        )
        if args.prefix_cache and ev.agent_id in hit_tok:
            cached = sum(c for c, _ in hit_tok[ev.agent_id])
            line += f", {cached} cached prefill tokens"
        if args.stream and ev.agent_id in rec.first_token:
            handle = service.handles[ev.agent_id]
            ttft = rec.first_token[ev.agent_id] - rec.arrival.get(
                ev.agent_id, handle.arrival
            )
            span = max(ev.time - rec.first_token[ev.agent_id], 1e-9)
            line += (f", ttft {ttft:.2f}s, "
                     f"{handle.token_count * token_scale / span:.1f} "
                     f"tok/s")
        print(line + ")")

    def on_requeued(ev):
        print(f"  t={ev.time:7.1f}s agent {ev.agent_id} requeued "
              f"(replica {ev.from_replica} -> {ev.replica})")

    hooks = AgentHooks(
        on_complete=on_complete,
        on_prefix_hit=on_prefix_hit if args.prefix_cache else None,
        on_requeued=on_requeued if args.chaos is not None else None,
    )
    for spec in specs:
        service.submit(spec, hooks=hooks)
    result = service.drain()
    wall = time.time() - t0

    print(f"served {args.n_agents} agents on backend={result.backend} "
          f"in {wall:.1f}s wall")
    print("jct:", result.stats.row())
    if args.stream and result.latency is not None:
        print("latency:", result.latency.row())
    print("events:", result.event_counts)
    print("backend metrics:", result.metrics)
    for r, stats in result.per_replica.items():
        print(f"replica {r}: {stats.row()}")
    return result


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    specs = build_specs(args, device)
    service = build_service(args, device)
    return serve(args, service, specs)


if __name__ == "__main__":
    main()
