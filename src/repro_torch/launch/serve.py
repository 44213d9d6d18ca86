"""Serving launcher of the port: the unified ``AgentService`` API over
either backend (the PyTorch counterpart of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
        [--backend engine|sim] [--scheduler justitia] [--n-agents 6] \
        [--replicas 3] [--router memory_cost_aware] [--device cpu]

One workload spec (the paper's agent-class sampler + bursty arrivals) is
driven through :class:`repro_torch.api.AgentService`; ``--backend engine``
serves it on the port's continuous-batching engine (actual prefill/decode
on the device through the CUDA kernels, paged KV accounting,
swap-on-pressure), ``--backend sim`` on the calibrated discrete-event
cluster — same ``AgentSpec`` list, same scheduler policy objects, one flag
apart.  Scheduler names resolve through the plugin registry
(``repro_torch.core.registry``), so ``--scheduler`` accepts any registered
policy.  Agents arrive *online* at their sampled arrival times, not
upfront.

``--replicas N`` serves the same workload on an N-way
:class:`repro_torch.api.ReplicatedBackend` fleet (per-replica pools,
lockstep clocks, reconciled global virtual time); ``--router`` picks the
placement policy from the router registry
(``repro_torch.api.router_names()``).

The engine serves the reduced model variant, as the JAX launcher does, on
``--device`` (default: the CUDA card; ``--device cpu`` runs the kernels'
plain versions on the CPU).  With no device named and no CUDA device the
launcher raises.  The printed ``completions:`` equal the JAX launcher's for
the same flags: the engine clock counts iterations, which do not depend on
the device, the dtype or the sampled tokens.  Installed as the
``repro-serve-torch`` console entrypoint (see pyproject.toml).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.api import (
    router_names,
    service_for_backend,
    specs_from_classes,
)
from repro_torch.configs import ALL_ARCHS
from repro_torch.core import scheduler_names


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b", choices=ALL_ARCHS)
    ap.add_argument("--backend", default="engine", choices=("engine", "sim"))
    ap.add_argument("--scheduler", default="justitia",
                    choices=scheduler_names())
    ap.add_argument("--n-agents", type=int, default=6)
    ap.add_argument("--pool-tokens", type=int, default=4096)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--window-s", type=float, default=20.0,
                    help="arrival window (workload seconds)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serve on an N-way replicated fleet")
    ap.add_argument("--router", default="round_robin",
                    choices=router_names(),
                    help="fleet placement policy (with --replicas > 1)")
    ap.add_argument("--watchdog-timeout", type=float, default=None,
                    metavar="S",
                    help="(with --replicas > 1) suspect a busy replica "
                         "lagging the fleet clock by S seconds")
    ap.add_argument("--watchdog-retries", type=int, default=None,
                    help="suspect probes before declaring a replica dead "
                         "(fleet default: 3)")
    ap.add_argument("--watchdog-backoff", type=float, default=None,
                    help="multiplier between successive suspect probes "
                         "(fleet default: 2.0)")
    ap.add_argument("--admission-watermark", type=float, nargs=2,
                    default=None, metavar=("LOW", "HIGH"),
                    help="watermark admission control: defer admissions "
                         "below LOW free-pool fraction, resume above HIGH")
    ap.add_argument("--suspend-retention", default=None,
                    choices=("hold", "spill", "drop"),
                    help="KV retention for agents suspended through "
                         "tool-call think time (closed-loop workloads)")
    ap.add_argument("--fleet-workers", type=int, default=None, metavar="N",
                    help="(with --replicas > 1) advance the fleet's "
                         "children concurrently on an N-thread pool — "
                         "bit-identical to the sequential lockstep loop")
    ap.add_argument("--steal-threshold", type=float, default=None,
                    metavar="X",
                    help="(with --replicas > 1) migrate queued, "
                         "never-admitted agents off a replica whose "
                         "capacity-normalized backlog exceeds X times the "
                         "fleet mean (X > 1; the X-to-mean gap is the "
                         "hysteresis band)")
    ap.add_argument("--steal-interval", type=float, default=None,
                    metavar="S",
                    help="workload seconds between stealing passes "
                         "(fleet default: 1.0)")
    ap.add_argument("--device", default=None,
                    help="device of the engine's model (default: the CUDA "
                         "card; 'cpu' runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    if args.watchdog_timeout is not None and args.replicas <= 1:
        ap.error("--watchdog-timeout requires --replicas > 1")
    if args.fleet_workers is not None and args.replicas <= 1:
        ap.error("--fleet-workers requires --replicas > 1")
    if args.steal_threshold is not None and args.replicas <= 1:
        ap.error("--steal-threshold requires --replicas > 1")
    if args.steal_interval is not None and args.steal_threshold is None:
        ap.error("--steal-interval requires --steal-threshold")

    rng = np.random.default_rng(0)
    specs = specs_from_classes(rng, args.n_agents, args.window_s)
    service = service_for_backend(
        args.backend, args.scheduler,
        arch=args.arch, pool_tokens=args.pool_tokens,
        max_batch=args.max_batch,
        replicas=args.replicas, router=args.router,
        watchdog_timeout=args.watchdog_timeout,
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
        device=args.device,
    )

    t0 = time.time()
    service.submit_many(specs)
    result = service.drain()
    print(f"backend={result.backend} scheduler={args.scheduler} "
          f"agents={args.n_agents} wall={time.time() - t0:.1f}s")
    print("jct:", result.stats.row())
    print("completions:",
          {k: round(v, 1) for k, v in sorted(result.finish.items())})
    print("events:", result.event_counts)
    print("metrics:", result.metrics)
    if result.per_replica:
        for r, stats in result.per_replica.items():
            print(f"replica {r}: {stats.row()}")


if __name__ == "__main__":
    main()
