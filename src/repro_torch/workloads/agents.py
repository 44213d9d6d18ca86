"""The paper's 9-class agent workload suite (§5.1 Workloads).

Classes: (a) MapReduce Summarization (MRS), (b) Plan-and-Execution (PE),
(c) Code Checking (CC), (d) KBQA Verification (KBQAV), (e) Equation
Verification (EV), (f) Fact Verification (FV), (g) ALFWorld Interaction
(ALFWI), (h) Document Merging (DM), (i) Self Consistency (SC).

Sampling probabilities follow the paper: small 72%, medium 26%, large 2%
(small = EV, FV, CC, ALFWI, KBQAV; medium = PE, SC; large = DM, MRS — the
paper's "CG" in the medium list is its own enumeration's CC).

Per Appendix A, each inference stage of an agent class has a *stable*
demand distribution across trial runs, modeled as a skew-normal over
prefill/decode token lengths.  Each sampled agent also carries a synthetic
prompt whose token statistics encode the latent demand (length and keyword
counts correlate with cost), which is what makes the per-class TF-IDF→MLP
predictor learnable exactly as the paper exploits.
"""

from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Callable, Optional

import numpy as np

from repro_torch.core.cost import InferenceSpec, MemoryFamily, agent_cost
from repro_torch.sim.metrics import SloTier


def skew_normal(
    rng: np.random.Generator, loc: float, scale: float, alpha: float, size=None
):
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
    # (e.g. MapReduce's reduce step reads all the map summaries)
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
    stages: list[list[InferenceSpec]]
    prompt: str
    true_cost: float
    family: MemoryFamily = MemoryFamily.DENSE

    @property
    def name(self) -> str:
        return self.cls.name


# --------------------------------------------------------------------------
# The nine classes.  Token budgets chosen so that, at the simulator's default
# 30 tok/s/seq decode rate, solo JCTs land in the paper's buckets
# (small < 1 min, medium 1–10 min, large > 10 min).

AGENT_CLASSES: dict[str, AgentClass] = {
    "EV": AgentClass(
        "EV", "small",
        (StageTemplate((2, 4), (180, 40, 2.0), (60, 20, 2.0)),),
        ("equation", "verify", "algebra", "derivation", "lhs", "rhs"),
    ),
    "FV": AgentClass(
        "FV", "small",
        (
            StageTemplate((1, 1), (350, 15, 1.0), (90, 25, 2.0)),   # gen queries
            StageTemplate((2, 5), (260, 60, 2.0), (80, 25, 2.0)),   # verify claims
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
            StageTemplate((1, 1), (500, 100, 2.0), (250, 60, 2.0)),  # plan
            StageTemplate((3, 8), (450, 120, 2.0), (450, 140, 2.5)), # execute
            StageTemplate((1, 1), (300, 60, 1.0), (200, 60, 2.0),
                          prefill_from_prev_outputs=1.0),            # report
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
            StageTemplate((6, 12), (2400, 500, 2.5), (700, 180, 2.0)),  # merge
            StageTemplate((6, 12), (900, 200, 2.0), (120, 40, 2.0)),    # score
            StageTemplate((1, 2), (1200, 250, 2.0), (800, 200, 2.0),
                          prefill_from_prev_outputs=0.5),               # final
        ),
        ("document", "merge", "paragraph", "outline", "dedupe", "graph"),
    ),
    "MRS": AgentClass(
        "MRS", "large",
        (
            StageTemplate((16, 40), (2600, 600, 2.5), (380, 100, 2.0)),  # map
            StageTemplate((1, 1), (500, 100, 1.0), (900, 220, 2.0),
                          prefill_from_prev_outputs=1.0),                # reduce
        ),
        ("summarize", "chunk", "mapreduce", "section", "digest", "corpus"),
    ),
}

SIZE_BUCKETS = {
    "small": ["EV", "FV", "CC", "ALFWI", "KBQAV"],
    "medium": ["PE", "SC"],
    "large": ["DM", "MRS"],
}
SIZE_PROBS = {"small": 0.72, "medium": 0.26, "large": 0.02}

_FILLER = (
    "the of and to in that it for with as on be at this by from or an are "
    "was but not have had they you his her its which will one all would "
    "there what about out up into than them can only other time new some"
).split()


def _synth_prompt(
    rng: np.random.Generator, cls: AgentClass, complexity: float, total_prefill: int
) -> str:
    """Prompt whose statistics encode the latent demand.

    Length tracks total prefill; per-class keyword *counts* track the
    complexity multiplier, so TF-IDF features carry the cost signal.
    """
    n_words = max(12, int(total_prefill / 14))
    n_kw = max(2, int(6 * complexity))
    words = list(rng.choice(_FILLER, size=n_words))
    for _ in range(n_kw):
        words.insert(int(rng.integers(0, len(words))), str(rng.choice(cls.keywords)))
    return " ".join(words)


def sample_agent(
    rng: np.random.Generator,
    cls_name: str,
    family: MemoryFamily = MemoryFamily.DENSE,
) -> SampledAgent:
    cls = AGENT_CLASSES[cls_name]
    complexity = float(
        np.clip(np.exp(rng.normal(0.0, cls.complexity_spread)), 0.4, 3.0)
    )
    stages: list[list[InferenceSpec]] = []
    prev_outputs = 0.0
    total_prefill = 0
    for st in cls.stages:
        n = int(rng.integers(st.n_parallel[0], st.n_parallel[1] + 1))
        specs = []
        for _ in range(n):
            p = st.prefill_from_prev_outputs * prev_outputs / max(1, n)
            p += float(np.clip(skew_normal(rng, *st.prefill), 16, 65536))
            p = min(p, 4096.0)  # context-window clamp (single inference)
            d = complexity * float(np.clip(skew_normal(rng, *st.decode), 4, 8192))
            specs.append(InferenceSpec(prefill=int(p), decode=max(1, int(d))))
        prev_outputs = float(sum(s.decode for s in specs))
        total_prefill += int(sum(s.prefill for s in specs))
        stages.append(specs)
    flat = [s for st in stages for s in st]
    cost = agent_cost(flat, family)
    prompt = _synth_prompt(rng, cls, complexity, total_prefill)
    return SampledAgent(
        cls=cls, stages=stages, prompt=prompt, true_cost=cost, family=family
    )


def sample_mixed_suite(
    rng: np.random.Generator, n_agents: int
) -> list[SampledAgent]:
    """The paper's 300-agent mixed suite (72/26/2 small/medium/large)."""
    out = []
    sizes = rng.choice(
        list(SIZE_PROBS), size=n_agents, p=list(SIZE_PROBS.values())
    )
    for s in sizes:
        cls_name = str(rng.choice(SIZE_BUCKETS[str(s)]))
        out.append(sample_agent(rng, cls_name))
    return out


# --------------------------------------------------------------------------
# Closed-loop workload family: agents whose NEXT stage is only known once
# the previous stage finished — the interactive regime the paper's workload
# suite abstracts away (its task graphs are fixed at arrival).  Each session
# is a stateful callable compatible with ``repro.api.AgentSpec.next_stage``:
# the serving layer feeds it the completed stage's ``StageOutcome`` and it
# returns the next turn's InferenceSpecs (or None to end the session).
# Turn demands are sampled LAZILY from the session's own child RNG, so the
# spec sequence is deterministic per session and — because it depends only
# on the turn counter, never on backend-specific outcome fields — identical
# across sim/engine/replicated backends (what the cross-backend conformance
# suite pins).  ``StageOutcome.new_tokens``/``time`` are available to custom
# sessions that want genuinely reactive behaviour.


@dataclasses.dataclass(frozen=True)
class ClosedLoopClass:
    """One closed-loop session family."""

    name: str
    turns: tuple[int, int]               # [lo, hi] total turns
    prefill: tuple[float, float, float]  # fresh per-turn prompt (skew-normal)
    decode: tuple[float, float, float]
    #: fraction of the session's accumulated outputs re-read each turn
    #: (chat: the whole conversation history; react: the last observations)
    carry: float
    fanout: tuple[int, int] = (1, 1)     # parallel tool calls per turn
    stop_prob: float = 0.0               # per-turn early stop (react loops)
    #: shared system-prompt length (tokens) prepended to EVERY turn's
    #: prompt — identical across all sessions of the family, so a
    #: prefix-aware KV cache reuses it across agents (and across turns)
    sys_prefix: int = 0
    #: [lo, hi] tool-call think time (workload seconds) between turns —
    #: the wall-clock gap while the agent executes tools / awaits a human
    #: before its next stage submits.  (0, 0) disables suspension (the
    #: default: legacy families consume no extra RNG draws and stay
    #: bit-identical to their pre-suspension streams)
    think: tuple = (0.0, 0.0)


CLOSED_LOOP_CLASSES: dict[str, ClosedLoopClass] = {
    # multi-turn chat: one inference per turn, prompt grows with the full
    # conversation history behind a family-shared system prompt
    "chat": ClosedLoopClass(
        "chat", (3, 8), (140, 40, 1.5), (90, 30, 2.0), carry=1.0,
        sys_prefix=256,
    ),
    # tool-call react loop: thought -> 1-3 parallel tool calls, short
    # decodes, carries only the recent observations, may stop early;
    # the (larger) shared prefix models the tool-catalog preamble
    "react": ClosedLoopClass(
        "react", (2, 10), (240, 60, 2.0), (48, 16, 2.0), carry=0.35,
        fanout=(1, 3), stop_prob=0.2, sys_prefix=384,
    ),
    # --- SLO-tiered family (PR 7): the two classes below are served
    # TOGETHER — latency-sensitive chat-style sessions sharing the fleet
    # with long-prompt batch summarizers whose big prefills are exactly
    # the admission stalls fused prefill absorbs ---
    # interactive tier: short turns, human in the loop, tight TTFT/TBT
    "interactive": ClosedLoopClass(
        "interactive", (3, 8), (120, 30, 1.5), (64, 20, 2.0), carry=1.0,
        sys_prefix=256,
    ),
    # batch tier: few turns, very long fresh prompts (document chunks),
    # long decodes, loose targets — throughput-oriented
    "batch": ClosedLoopClass(
        "batch", (1, 3), (900, 200, 1.5), (320, 80, 1.5), carry=0.25,
        sys_prefix=256,
    ),
    # --- think-time-heavy family (PR 9): agentic tool use where each
    # turn's decode is short but the tool call between turns takes
    # seconds of wall clock — the agent holds no decode slot while it
    # thinks, and its KV falls under the backend's retention policy ---
    "tooluse": ClosedLoopClass(
        "tooluse", (3, 8), (220, 50, 2.0), (40, 12, 2.0), carry=0.3,
        fanout=(1, 2), sys_prefix=384, think=(4.0, 12.0),
    ),
}


#: the SLO family's class names, in submission-interleave order
SLO_CLASSES: tuple[str, ...] = ("interactive", "batch")

#: per-tier latency targets (workload seconds) for the SLO closed-loop
#: family.  Calibrated for the canonical serving configurations
#: (sim: decode_rate=30 tok/s; engine: time_scale mapping one iteration
#: to ``token_scale/decode_rate`` seconds — see benchmarks/perf_slo.py):
#: interactive agents expect a first token while a human is still
#: watching and a readable streaming cadence; batch agents only need to
#: start within the minute and keep moving.
SLO_TIERS: dict[str, "SloTier"] = {
    "interactive": SloTier("interactive", ttft=20.0, tbt=2.0),
    "batch": SloTier("batch", ttft=120.0, tbt=8.0),
}


def slo_tier_of(cls_name: str) -> "Optional[SloTier]":
    """The latency tier of a closed-loop class (None if untiered)."""
    return SLO_TIERS.get(cls_name)


#: canonical (workload-scale) token-id space for the deterministic prompt
#: streams; engine backends fold ids into their own vocab with ``%``
CANON_VOCAB = 1 << 20

_PREFIX_IDS: dict[str, np.ndarray] = {}


def family_prefix_ids(cls_name: str) -> np.ndarray:
    """The family's shared system-prompt token ids (deterministic).

    Seeded from a CRC of the family name — stable across processes and
    runs (unlike ``hash``), so every session of a family, in every
    backend and every benchmark process, sees the byte-identical prefix.
    """
    ids = _PREFIX_IDS.get(cls_name)
    if ids is None:
        cls = CLOSED_LOOP_CLASSES[cls_name]
        seed = zlib.crc32(f"sys-prefix:{cls_name}".encode())
        ids = np.random.default_rng(seed).integers(
            0, CANON_VOCAB, size=int(cls.sys_prefix)
        )
        _PREFIX_IDS[cls_name] = ids
    return ids


@dataclasses.dataclass
class ClosedLoopSession:
    """Stateful ``next_stage`` generator for one closed-loop agent.

    ``first_stage`` seeds ``AgentSpec.stages``; every later turn is drawn
    from ``_rng`` when the serving layer asks for it.  ``expected_cost``
    is the a-priori cost estimate (expected turns x expected per-turn
    demand through the cost model) — the honest analogue of the paper's
    predictor output, since a closed-loop agent's true cost is unknowable
    at arrival.
    """

    cls: ClosedLoopClass
    first_stage: list[InferenceSpec]
    expected_cost: float
    max_turns: int
    _rng: np.random.Generator
    _turn: int = 1
    _history: float = 0.0                # accumulated output tokens
    #: separate RNG for the session's canonical prompt token stream —
    #: decoupled from ``_rng`` so demand sampling is unaffected by how
    #: many prompt ids a turn consumes.  ``None``: no pinned prompts
    #: (manually built sessions), backends synthesize instead.
    _token_rng: Optional[np.random.Generator] = None
    _stream: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.int64)
    )
    _seen_prompt: int = 0                # longest prompt issued so far
    #: canonical prompt ids / expected cached-prefix lengths of the most
    #: recently sampled stage (what the serving layer forwards through
    #: ``Backend.submit_stage``)
    last_prompt_ids: Optional[list] = None
    last_cached_hints: Optional[list] = None
    #: think time preceding the most recently sampled stage (seconds) —
    #: the serving layer forwards it as ``submit_stage(resume_delay=...)``
    #: so the backend suspends the agent for that long first.  ``None``
    #: for think-free families (kept ``None`` without touching the RNG,
    #: preserving their pre-suspension demand streams bit-for-bit)
    last_resume_delay: Optional[float] = None

    def _prompt_for(self, p: int) -> np.ndarray:
        """Canonical ids for a ``p``-token prompt: the family's shared
        system prefix followed by this session's private stream.  Every
        prompt of a session is a prefix of every longer one — each turn
        literally re-sends the conversation so far, which is the reuse
        a prefix cache exploits."""
        base = family_prefix_ids(self.cls.name)
        if p <= len(base):
            return base[:p]
        need = p - len(base)
        while len(self._stream) < need:
            grow = max(1024, need - len(self._stream))
            self._stream = np.concatenate(
                [self._stream, self._token_rng.integers(0, CANON_VOCAB,
                                                        size=grow)]
            )
        return np.concatenate([base, self._stream[:need]])

    def _sample_stage(self) -> list[InferenceSpec]:
        c = self.cls
        n = int(self._rng.integers(c.fanout[0], c.fanout[1] + 1))
        specs = []
        prompt_ids: list[np.ndarray] = []
        hints: list[float] = []
        for _ in range(n):
            p = c.sys_prefix + c.carry * self._history / max(1, n)
            p += float(np.clip(skew_normal(self._rng, *c.prefill), 16, 65536))
            p = min(p, 4096.0)           # context-window clamp
            d = float(np.clip(skew_normal(self._rng, *c.decode), 4, 8192))
            specs.append(InferenceSpec(prefill=int(p), decode=max(1, int(d))))
            # the hint is what THIS session knows it already sent (turn 1
            # hints 0 even though the family prefix may be warm — the
            # sim's group seeding / the engine's allocator add that part)
            hints.append(float(min(int(p), self._seen_prompt)))
            if self._token_rng is not None:
                prompt_ids.append(self._prompt_for(int(p)))
            self._seen_prompt = max(self._seen_prompt, int(p))
        self._history += float(sum(s.decode for s in specs))
        self.last_prompt_ids = prompt_ids if self._token_rng is not None \
            else None
        self.last_cached_hints = hints
        return specs

    def __call__(self, outcome) -> Optional[list[InferenceSpec]]:
        if self._turn >= self.max_turns:
            return None
        if self.cls.stop_prob and self._rng.random() < self.cls.stop_prob:
            return None
        self._turn += 1
        lo, hi = self.cls.think
        if hi > 0.0:
            self.last_resume_delay = float(lo + (hi - lo) * self._rng.random())
        else:
            self.last_resume_delay = None
        return self._sample_stage()


def sample_closed_loop(
    rng: np.random.Generator, cls_name: str
) -> ClosedLoopSession:
    """Sample one closed-loop session (first turn eager, rest lazy)."""
    cls = CLOSED_LOOP_CLASSES[cls_name]
    child = np.random.default_rng(int(rng.integers(0, 2**63)))
    # the prompt-stream RNG is seeded by one dedicated draw so demand
    # sampling and token-id generation cannot perturb each other
    token_rng = np.random.default_rng(int(child.integers(0, 2**63)))
    max_turns = int(child.integers(cls.turns[0], cls.turns[1] + 1))
    session = ClosedLoopSession(
        cls=cls,
        first_stage=[],
        expected_cost=0.0,
        max_turns=max_turns,
        _rng=child,
        _token_rng=token_rng,
    )
    session.first_stage = session._sample_stage()

    # expected cost from the family's location parameters: E[turns] more
    # stages shaped like the mean turn, history growing by the mean decode
    exp_turns = 0.5 * (cls.turns[0] + cls.turns[1])
    if cls.stop_prob:
        exp_turns = min(exp_turns, 1.0 / max(cls.stop_prob, 1e-9))
    fan = 0.5 * (cls.fanout[0] + cls.fanout[1])
    est, hist = [], 0.0
    for _ in range(max(1, int(round(exp_turns)))):
        p = min(
            4096.0,
            cls.sys_prefix + cls.prefill[0] + cls.carry * hist / max(1.0, fan),
        )
        est.extend(
            [InferenceSpec(int(p), int(cls.decode[0]))]
            * max(1, int(round(fan)))
        )
        hist += fan * cls.decode[0]
    session.expected_cost = agent_cost(est)
    return session
