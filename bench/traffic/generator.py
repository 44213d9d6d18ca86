"""The one traffic generator: reads a mix's data file
(``bench/traffic/<mix>.json``) and draws the agents a run offers.

A mix names its ``kind``, the module ``bench/traffic/<kind>.py`` that
decides when agents are offered (``open_agents``: at bursty due times,
whether or not earlier ones have finished; ``closed_agents``: a fixed
number of clients, each submitting its next agent when its last one
completed).  A kind module holds ``pool_size(mix, seconds)`` and a
``Source(mix, seed, seconds, vocab)`` with ``longest`` (the longest
prompt it may offer), ``offer(run, now)`` (submit through ``run.submit(agent, due)``
what is due by ``now``; false once the window is over for it) and
``next_due(run)`` (when it next offers one, on ``run``'s clock).

A mix's ``classes`` are names of the paper's classes, which the frozen
sampler draws (``agents.py``), or classes stated in the file itself::

    {"name": "MRSmap", "keywords": ["summarize", "chunk"],
     "complexity_spread": 0.0,
     "stages": [{"n_parallel": [2, 6],
                 "prefill": {"skew_normal": [2600, 600, 2.5],
                             "clip": [1024, 3584]},
                 "decode": {"uniform": [8, 48]}}]}

Every seed offers the same work in another order.  The agents (classes
cycled in ``classes`` order), their arrival times and the predictor's
training set come from the mix's ``pool_seed``; ``--seed`` permutes which
agent arrives when and draws the prompts' token ids.  Drawing the agents
from ``--seed`` too would make a run's mean JCT depend on which sizes a
seed happened to draw, which would swamp every change a PR makes.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path

import numpy as np

from traffic.agents import (AgentClass, SampledAgent, _synth_prompt,
                            agent_cost, sample_agent, skew_normal)

TRAFFIC_DIR = Path(__file__).resolve().parent


@dataclasses.dataclass
class Agent:
    """One agent of a run: its class, the (prefill, decode) tokens of each
    inference of each stage, its synthetic prompt text (what the cost
    predictor reads), its true memory-centric cost, and the token ids of
    each inference's prompt."""

    index: int                       # position in the mix's pool
    cls: str
    stages: list[list[tuple[int, int]]]
    text: str
    true_cost: float
    prompts: list[list[np.ndarray]]

    @property
    def inferences(self) -> list[tuple[int, int]]:
        return [s for stage in self.stages for s in stage]


def kind_of(mix: dict):
    """The module of the mix's kind, ``traffic/<kind>.py``."""
    kind = str(mix.get("kind"))
    if not (TRAFFIC_DIR / f"{kind}.py").is_file():
        raise ValueError(f"no traffic kind {kind!r}: bench/traffic/{kind}.py "
                         "is missing")
    return importlib.import_module(f"traffic.{kind}")


def load(name: str) -> dict:
    """The mix's parameters, by name."""
    mix = json.loads((TRAFFIC_DIR / f"{name}.json").read_text())
    kind_of(mix)
    return mix


def class_name(cls) -> str:
    return cls if isinstance(cls, str) else cls["name"]


def _draw(rng: np.random.Generator, dist: dict) -> float:
    """One length from a stated distribution: ``skew_normal`` (loc, scale,
    alpha) or ``uniform`` (lo, hi, both included), then ``clip``."""
    if "uniform" in dist:
        lo, hi = dist["uniform"]
        x = float(rng.integers(int(lo), int(hi) + 1))
    else:
        x = float(skew_normal(rng, *dist["skew_normal"]))
    if "clip" in dist:
        x = float(np.clip(x, *dist["clip"]))
    return x


def sample_stated(rng: np.random.Generator, cls: dict) -> SampledAgent:
    """An agent of a class stated in the mix's file, drawn as the frozen
    sampler draws the paper's: a latent complexity that scales the decode
    lengths, then each stage's parallel inferences."""
    spread = float(cls.get("complexity_spread", 0.35))
    complexity = float(np.clip(np.exp(rng.normal(0.0, spread)), 0.4, 3.0))
    stages, prev_outputs, total_prefill = [], 0.0, 0
    for st in cls["stages"]:
        lo, hi = st["n_parallel"]
        n = int(rng.integers(int(lo), int(hi) + 1))
        specs = []
        for _ in range(n):
            p = float(st.get("prefill_from_prev_outputs", 0.0)) * (
                prev_outputs / max(1, n))
            p += _draw(rng, st["prefill"])
            d = complexity * _draw(rng, st["decode"])
            specs.append((int(p), max(1, int(d))))
        prev_outputs = float(sum(d for _, d in specs))
        total_prefill += int(sum(p for p, _ in specs))
        stages.append(specs)
    meta = AgentClass(cls["name"], cls.get("size", "stated"), (),
                      tuple(cls["keywords"]), spread)
    return SampledAgent(cls=meta, stages=stages,
                        prompt=_synth_prompt(rng, meta, complexity,
                                             total_prefill),
                        true_cost=agent_cost([s for st in stages
                                              for s in st]))


def sample(rng: np.random.Generator, cls) -> SampledAgent:
    if isinstance(cls, str):
        return sample_agent(rng, cls)
    return sample_stated(rng, cls)


def pool_rng(mix: dict, stream: int) -> np.random.Generator:
    """A generator of the mix's fixed draws (streams 1 and 2 are the
    predictor's history and the pool of agents)."""
    return np.random.default_rng([int(mix["pool_seed"]), stream])


def predictor_history(mix: dict) -> dict:
    """The cost predictor's training set: ``history_per_class`` sampled
    agents of each class, class -> (prompt texts, true costs)."""
    rng = pool_rng(mix, 1)
    out = {}
    for cls in mix["classes"]:
        hist = [sample(rng, cls)
                for _ in range(int(mix["predictor"]["history_per_class"]))]
        out[class_name(cls)] = ([a.prompt for a in hist],
                                [a.true_cost for a in hist])
    return out


def agent_pool(mix: dict, seconds: float) -> list:
    """The mix's agents in pool order (classes cycled), before any seed."""
    rng = pool_rng(mix, 2)
    classes = mix["classes"]
    return [sample(rng, classes[i % len(classes)])
            for i in range(kind_of(mix).pool_size(mix, seconds))]


def order(n: int, seed: int) -> np.ndarray:
    """The seed's permutation of a pool of ``n`` agents."""
    return np.random.default_rng([int(seed), 3]).permutation(n)


def agent(sampled, index: int, seed: int, vocab: int) -> Agent:
    """The pool's agent ``index`` with the seed's prompt token ids."""
    rng = np.random.default_rng([int(seed), 7, index])
    prompts = [[rng.integers(0, vocab, size=p, dtype=np.int64)
                .astype(np.int32) for p, _ in stage]
               for stage in sampled.stages]
    return Agent(index=index, cls=sampled.name,
                 stages=[list(s) for s in sampled.stages],
                 text=sampled.prompt, true_cost=sampled.true_cost,
                 prompts=prompts)


def source(mix: dict, seed: int, seconds: float, vocab: int):
    """What offers the run's agents: the mix's kind's ``Source``."""
    return kind_of(mix).Source(mix, seed, seconds, vocab)
