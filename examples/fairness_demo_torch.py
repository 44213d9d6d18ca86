"""Starvation-avoidance demo (paper Fig. 9) via the port's unified
AgentService (the PyTorch package's counterpart of
``examples/fairness_demo.py``).

    PYTHONPATH=src python examples/fairness_demo_torch.py

An "elephant" agent arrives first; "mice" keep arriving.  Under SRJF the
elephant's completion grows without bound as mice multiply; under Justitia
it plateaus: once the GPS virtual time passes the elephant's virtual finish
time, later mice queue BEHIND it regardless of their size.  The workload is
expressed once as backend-agnostic ``AgentSpec``s and served through
``AgentService.sim``, which runs on the host and takes no device (swap
``.sim`` for ``.engine(model, params, ...)`` to replay it on the port's
engine).  The table equals the JAX example's.
"""

from repro_torch.api import AgentService, AgentSpec
from repro_torch.core import InferenceSpec

M = 1000.0


def workload(n_mice):
    es = [InferenceSpec(300, 400)] * 6
    specs = [AgentSpec(stages=[es], arrival=0.0, name="elephant")]
    for i in range(n_mice):
        s = [InferenceSpec(250, 150)]
        specs.append(
            AgentSpec(stages=[s], arrival=1.0 + i * 2.5, name="mouse")
        )
    return specs


def main():
    print(f"{'mice':>6s} {'SRJF elephant JCT':>18s} "
          f"{'Justitia elephant JCT':>22s}")
    for n in (30, 60, 120, 240, 480):
        row = []
        for name in ("srjf", "justitia"):
            service = AgentService.sim(name, total_kv=M, decode_rate=30.0)
            handles = service.submit_many(workload(n))
            service.drain()
            row.append(handles[0].jct)   # the elephant
        print(f"{n:6d} {row[0]:17.0f}s {row[1]:21.0f}s")
    print("\nSRJF grows unboundedly; Justitia is bounded "
          "(Theorem B.1: delay <= 2c_max + C_max/M).")


if __name__ == "__main__":
    main()
