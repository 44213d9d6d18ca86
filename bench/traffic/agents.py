"""The agent sampler of the benchmark, frozen.

A copy of the port's ``repro_torch/workloads/agents.py`` sampler
(``AGENT_CLASSES``, ``skew_normal``, ``_synth_prompt``, ``sample_agent``)
and of the dense KV token-time of ``repro_torch/core/cost.py``, kept here
so that a change to the program cannot change the traffic it is measured
on.  The numbers drawn are the port's for the same generator state; the
only departure is that an inference is a plain ``(prefill, decode)``
tuple rather than the program's ``InferenceSpec``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


def skew_normal(rng: np.random.Generator, loc: float, scale: float,
                alpha: float, size=None):
    """Azzalini skew-normal sampler (scipy-free)."""
    delta = alpha / math.sqrt(1.0 + alpha * alpha)
    z0 = np.abs(rng.standard_normal(size))
    z1 = rng.standard_normal(size)
    x = delta * z0 + math.sqrt(1.0 - delta * delta) * z1
    return loc + scale * x


@dataclasses.dataclass(frozen=True)
class StageTemplate:
    """One stage of an agent's task graph."""

    n_parallel: tuple[int, int]          # [lo, hi] parallel inferences
    prefill: tuple[float, float, float]  # skew-normal (loc, scale, alpha)
    decode: tuple[float, float, float]
    # prefill of this stage scales with outputs of the previous stage
    prefill_from_prev_outputs: float = 0.0


@dataclasses.dataclass(frozen=True)
class AgentClass:
    name: str
    size: str                            # small / medium / large
    stages: tuple[StageTemplate, ...]
    keywords: tuple[str, ...]
    # latent complexity multiplies decode lengths; the prompt encodes it
    complexity_spread: float = 0.35


@dataclasses.dataclass
class SampledAgent:
    cls: AgentClass
    stages: list[list[tuple[int, int]]]   # stage -> [(prefill, decode)]
    prompt: str
    true_cost: float

    @property
    def name(self) -> str:
        return self.cls.name


#: the paper's nine classes (§5.1), as the port samples them
AGENT_CLASSES: dict[str, AgentClass] = {
    "EV": AgentClass(
        "EV", "small",
        (StageTemplate((2, 4), (180, 40, 2.0), (60, 20, 2.0)),),
        ("equation", "verify", "algebra", "derivation", "lhs", "rhs"),
    ),
    "FV": AgentClass(
        "FV", "small",
        (
            StageTemplate((1, 1), (350, 15, 1.0), (90, 25, 2.0)),
            StageTemplate((2, 5), (260, 60, 2.0), (80, 25, 2.0)),
        ),
        ("fact", "claim", "evidence", "source", "citation", "react"),
    ),
    "CC": AgentClass(
        "CC", "small",
        (StageTemplate((2, 6), (420, 90, 2.5), (110, 35, 2.0)),),
        ("code", "lint", "bug", "unittest", "stacktrace", "patch"),
    ),
    "ALFWI": AgentClass(
        "ALFWI", "small",
        (
            StageTemplate((1, 2), (240, 50, 1.5), (50, 15, 1.5)),
            StageTemplate((1, 3), (280, 50, 1.5), (60, 15, 1.5)),
        ),
        ("household", "navigate", "pickup", "drawer", "goal", "action"),
    ),
    "KBQAV": AgentClass(
        "KBQAV", "small",
        (StageTemplate((2, 5), (300, 70, 2.0), (70, 20, 2.0)),),
        ("knowledge", "entity", "triple", "sparql", "answer", "wikidata"),
    ),
    "PE": AgentClass(
        "PE", "medium",
        (
            StageTemplate((1, 1), (500, 100, 2.0), (250, 60, 2.0)),
            StageTemplate((3, 8), (450, 120, 2.0), (450, 140, 2.5)),
            StageTemplate((1, 1), (300, 60, 1.0), (200, 60, 2.0),
                          prefill_from_prev_outputs=1.0),
        ),
        ("plan", "subtask", "tool", "execute", "huggingface", "schedule"),
    ),
    "SC": AgentClass(
        "SC", "medium",
        (StageTemplate((8, 16), (380, 80, 2.0), (620, 180, 2.5)),),
        ("reasoning", "chain", "math", "vote", "consistency", "solution"),
    ),
    "DM": AgentClass(
        "DM", "large",
        (
            StageTemplate((6, 12), (2400, 500, 2.5), (700, 180, 2.0)),
            StageTemplate((6, 12), (900, 200, 2.0), (120, 40, 2.0)),
            StageTemplate((1, 2), (1200, 250, 2.0), (800, 200, 2.0),
                          prefill_from_prev_outputs=0.5),
        ),
        ("document", "merge", "paragraph", "outline", "dedupe", "graph"),
    ),
    "MRS": AgentClass(
        "MRS", "large",
        (
            StageTemplate((16, 40), (2600, 600, 2.5), (380, 100, 2.0)),
            StageTemplate((1, 1), (500, 100, 1.0), (900, 220, 2.0),
                          prefill_from_prev_outputs=1.0),
        ),
        ("summarize", "chunk", "mapreduce", "section", "digest", "corpus"),
    ),
}

_FILLER = (
    "the of and to in that it for with as on be at this by from or an are "
    "was but not have had they you his her its which will one all would "
    "there what about out up into than them can only other time new some"
).split()


def kv_token_time(prefill: int, decode: int) -> float:
    """Paper Eq. (1), exact discrete form: sum_{i=1..d} (p+i)."""
    p, d = float(prefill), float(decode)
    return p * d + d * (d + 1.0) / 2.0


def agent_cost(inferences) -> float:
    """Paper §4.1: the sum of the dense KV token-time of the inferences."""
    return float(sum(kv_token_time(p, d) for p, d in inferences))


def _synth_prompt(rng: np.random.Generator, cls: AgentClass,
                  complexity: float, total_prefill: int) -> str:
    """Prompt whose statistics encode the latent demand: its length tracks
    the total prefill, the per-class keyword counts the complexity."""
    n_words = max(12, int(total_prefill / 14))
    n_kw = max(2, int(6 * complexity))
    words = list(rng.choice(_FILLER, size=n_words))
    for _ in range(n_kw):
        words.insert(int(rng.integers(0, len(words))),
                     str(rng.choice(cls.keywords)))
    return " ".join(words)


def sample_agent(rng: np.random.Generator, cls_name: str) -> SampledAgent:
    cls = AGENT_CLASSES[cls_name]
    complexity = float(
        np.clip(np.exp(rng.normal(0.0, cls.complexity_spread)), 0.4, 3.0)
    )
    stages: list[list[tuple[int, int]]] = []
    prev_outputs = 0.0
    total_prefill = 0
    for st in cls.stages:
        n = int(rng.integers(st.n_parallel[0], st.n_parallel[1] + 1))
        specs = []
        for _ in range(n):
            p = st.prefill_from_prev_outputs * prev_outputs / max(1, n)
            p += float(np.clip(skew_normal(rng, *st.prefill), 16, 65536))
            p = min(p, 4096.0)  # context-window clamp (single inference)
            d = complexity * float(
                np.clip(skew_normal(rng, *st.decode), 4, 8192))
            specs.append((int(p), max(1, int(d))))
        prev_outputs = float(sum(d for _, d in specs))
        total_prefill += int(sum(p for p, _ in specs))
        stages.append(specs)
    cost = agent_cost([s for st in stages for s in st])
    prompt = _synth_prompt(rng, cls, complexity, total_prefill)
    return SampledAgent(cls=cls, stages=stages, prompt=prompt,
                        true_cost=cost)
