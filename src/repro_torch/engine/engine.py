"""Continuous-batching serving engine over the port's PyTorch model.

PyTorch counterpart of ``repro.engine.engine``: actual model prefill/decode
on the device, slot-based batched decoding, paged KV-block accounting,
agent-level scheduling via the SAME scheduler objects as the simulator,
vLLM's non-preemptive semantics (App. C):

  * waiting requests never preempt running inferences;
  * when the block pool cannot host a new decode token, the running
    inference with the WORST scheduler key is swapped out (its KV rows are
    copied to host memory and its blocks freed);
  * the swapped queue outranks the waiting queue for (re-)admission, and
    while it is non-empty no new request is admitted.

Time is measured in engine iterations (one batched decode step == 1
iteration; a prefill costs ceil(prompt / prefill_chunk) iterations),
matching the cost model's token-iteration units (service_rate=1).

Agents arrive *online*: ``submit_agent`` may be called at any point — before
the first ``step()``, between steps, or with ``arrival_iter`` in the future,
in which case the agent sits in a pending heap until the engine clock
reaches it.

An optional ``listener`` receives lifecycle callbacks (``on_arrival``,
``on_admit``, ``on_swap_out``, ``on_swap_in``, ``on_token``,
``on_stage_complete``, ``on_agent_complete``) — duck-typed so this module
stays independent of the API layer that consumes the events.

Every piece of host bookkeeping is the JAX engine's, line for line: the
admission pass and its consistent clock, the window sizer and its triggers,
watermark admission, suspension and held-KV escalation, the frozen-slot
rule.  What differs is the device side.  The JAX engine's six jitted
programs become PyTorch functions that update the cache in place:

* **Decode windows.**  K decode steps run as a Python loop of
  ``Model.decode`` + greedy argmax + masked slot advance on the device,
  with ONE device->host copy of the K x B sampled tokens per window.  A
  slot with no remaining budget freezes: it keeps rewriting row ``pos``.
* **Batched bucketed prefill.**  One admission pass runs ONE multi-sequence
  prefill (padded to the group's 64-token bucket and a power-of-two batch,
  lens-masked, through ``Model.prefill_chunked``) and copies every admitted
  slot's rows into the cache; padding rows are dropped.  The recurrent ssm
  family prefills one sequence at a time at its exact length instead, as
  the JAX engine does: padding would run through its state.
* **Slot-wise swaps + staging pool.**  Swap-out copies ONE slot's rows
  (K/V rows, or the recurrent state of every ssm layer) into a host staging
  buffer drawn from a free pool; swap-in copies them back.
* **Fused prefill-in-window** (``fused_prefill=True``, dense family).  Each
  window step also runs one ``prefill_chunk`` slice of the single admitted
  prompt through ``Model.prefill_slice`` (plain ``attention_any``, as in
  JAX), and the window still ends in ONE device->host copy of a (K, B+1)
  token matrix.  The prefilling slot rides the decode batch frozen with
  its ``pos`` chasing the slice start, so its decode garbage lands on the
  rows the same step's slice overwrites (see ``_fused_window``).

``prefix_cache=True`` needs no device program of its own: the unfused
admission prefills the whole prompt as before and charges only the
uncached suffix; fused admission writes a hit's head through
``_prefill_write`` and streams the rest as slices.

The engine serves the families the JAX engine serves: dense, MoE, VLM
(token prompts, as the dense path) and ssm.  The hybrid and
encoder-decoder families are served through ``Model.prefill`` /
``Model.decode`` only; the engine refuses them at construction
(``check_servable``) where the JAX engine fails at the first prefill.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.cost import InferenceSpec, kv_token_time
from repro_torch.core.queueing import OrderedQueue
from repro_torch.core.schedulers import AgentScheduler, Request
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import kernel_library
from repro_torch.kvcache.allocator import BlockAllocator
from repro_torch.kvcache.prefix import PrefixAwareAllocator
from repro_torch.models import Model


#: the families the JAX engine cannot serve: kind -> its limit
UNSERVED_KINDS = {
    "hybrid": (
        "the JAX engine's slot scatter and gather (_prefill_write_jit and "
        "_gather_slot_jit, src/repro/engine/engine.py:221,232) take every "
        "cache leaf's batch on axis 1, and the hybrid's mamba_h and "
        "mamba_conv are (n_super, attn_every, B, ...), so its first "
        "prefill fails"
    ),
    "encdec": (
        "the JAX engine never passes the audio frames (batch['embeds']) "
        "that Model.prefill of the encoder-decoder needs, so its first "
        "prefill fails with KeyError: 'embeds'"
    ),
}


def check_servable(cfg) -> None:
    """Raise ``NotImplementedError`` for a family the JAX engine cannot
    serve (``UNSERVED_KINDS``): the port's engine follows the reference
    and serves those through ``Model.prefill`` / ``Model.decode`` only."""
    limit = UNSERVED_KINDS.get(cfg.kind)
    if limit is not None:
        raise NotImplementedError(
            f"the serving engine does not serve the {cfg.kind} family "
            f"({cfg.name}): {limit}; run it through Model.prefill and "
            "Model.decode"
        )


# --------------------------------------------------------------------------
# Device programs: the JAX engine's jitted hot path as PyTorch functions
# that update the cache in place.
# --------------------------------------------------------------------------


def _decode_step(model, params, cache, state):
    """One decode iteration: model.decode + greedy argmax + masked slot
    advance.  ``state`` is the stacked (3, B) int32 slot tensor
    [last_tok; pos; remaining]; a slot with no remaining budget freezes
    (it keeps rewriting row ``pos``).  Returns the sampled tokens and the
    new state."""
    last_tok, pos, rem = state
    logits, cache = model.decode(params, cache, last_tok[:, None], pos)
    nxt = torch.argmax(logits[:, 0, :], dim=-1).to(torch.int32)
    live = rem > 0
    return nxt, torch.stack([
        torch.where(live, nxt, last_tok),
        torch.where(live, pos + 1, pos),
        rem - live.to(rem.dtype),
    ])


def _decode_window(model, k: int, params, cache, state):
    """K decode iterations looped on the device.  A slot whose remaining
    budget runs out mid-window freezes in place, so a window may span
    final completions.  Returns the new state and the K x B sampled
    tokens, still on the device."""
    toks = []
    for _ in range(k):
        nxt, state = _decode_step(model, params, cache, state)
        toks.append(nxt)
    return state, torch.stack(toks)


def _fused_window(model, k: int, chunk: int, params, cache, state,
                  pf_tokens, slot: int, start0: int, total: int):
    """K fused decode+prefill iterations: each step advances all B decode
    slots one token (``_decode_step``) AND runs one bounded lens-masked
    prefill slice of the single prefilling slot through
    ``Model.prefill_slice``.

    ``pf_tokens``: (K, chunk) int32 prompt slices (zero-padded) on the
    device; ``slot``, ``start0`` and ``total`` (host ints): the prefilling
    cache row, the first slice's absolute write offset and the full prompt
    length.  The prefilling slot rides the decode batch frozen (its ``rem``
    row is 0) but its ``pos`` row is overridden to chase the next slice
    start: step i's frozen-slot decode garbage lands at ``start0 +
    i*chunk`` — exactly the rows the same step's slice overwrites — and the
    carried-out ``pos`` equals the next window's ``start0``.  No host sync
    inside the loop.

    Returns the new state and the (K, B+1) token matrix, still on the
    device: columns 0..B-1 are the decode samples, column B is the prefill
    slot's argmax at the prompt's final position — valid only at the step
    whose slice exhausts the prompt (the request's first token)."""
    is_pf = torch.arange(state.shape[1], device=state.device) == slot
    toks = []
    for i in range(k):
        nxt, state = _decode_step(model, params, cache, state)
        state[1] = torch.where(is_pf, start0 + (i + 1) * chunk, state[1])
        pf_logits, cache = model.prefill_slice(
            params, cache, pf_tokens[i], slot, start0 + i * chunk, total
        )
        pf_tok = torch.argmax(pf_logits, dim=-1).to(torch.int32)
        toks.append(torch.cat([nxt, pf_tok[None]]))
    return state, torch.stack(toks)


def _clear_slot_kvpos(cache, slot: int) -> None:
    """Invalidate one slot's attention rows (``kv_pos = -1``) ahead of a
    fused prefill: the slices only write the prompt's own positions, so a
    reused slot's stale-but-valid rows from its previous occupant must be
    masked out first (``_prefill_write`` instead overwrites the whole slot,
    lens-masked)."""
    cache["kv_pos"][:, slot] = -1


def _prefill_write(model, cache_len: int, chunk: int, params, cache,
                   tokens, lens, slots):
    """Batched (chunked) prefill + first-token argmax + copy of every
    admitted slot's rows into the cache.  ``slots`` (host ints) may hold
    out-of-range padding entries (the batch is padded to a power of two);
    their rows are dropped.  Returns the first sampled tokens (device)."""
    logits, small = model.prefill_chunked(
        params, {"tokens": tokens, "lens": lens},
        cache_len=cache_len, chunk=chunk,
    )
    # every cache leaf is (layers, slots, ...): attention K/V or recurrent
    # state alike
    n_slots = next(iter(cache.values())).shape[1]
    rows = [i for i, slot in enumerate(slots) if 0 <= slot < n_slots]
    if rows:
        dev = tokens.device
        src = torch.tensor(rows, device=dev)
        dst = torch.tensor([int(slots[i]) for i in rows], device=dev)
        for key, big in cache.items():
            big[:, dst] = small[key][:, src].to(big.dtype)
    return torch.argmax(logits[:, 0, :], dim=-1).to(torch.int32)


def _gather_slot(cache, slot):
    """One slot's cache rows (the swap-out unit), as device views."""
    return {key: big[:, slot] for key, big in cache.items()}


def _to_host(rows) -> dict:
    """Owned host copies of gathered slot rows."""
    return {key: t.to("cpu", copy=True) for key, t in rows.items()}


def _scatter_slot(cache, small, slot) -> None:
    """Write one slot's staged rows back into the cache (in place)."""
    for key, big in cache.items():
        big[:, slot].copy_(small[key])


@dataclasses.dataclass
class EngineRequest:
    """One inference task: prompt tokens + a decode budget."""

    agent_id: int
    rid: int
    prompt: np.ndarray             # (p,) int32
    max_new_tokens: int
    submit_iter: int = 0
    #: expected cached-prefix length (engine-scale tokens) from workload
    #: metadata — a STATIC scheduler hint (locality_fair reads it through
    #: ``Request.cached_prefix``); keys must not query the live allocator
    cached_hint: float = 0.0
    # runtime
    slot: int = -1
    generated: int = 0
    done: bool = False
    #: measured prefix-cache hit at admission (engine-scale tokens)
    cached_tokens: int = 0
    swapped_kv: Any = None         # host copy when swapped out
    _last_tok: int = 0
    _sched_req: Optional[Request] = dataclasses.field(
        default=None, repr=False
    )

    @property
    def spec(self) -> InferenceSpec:
        return InferenceSpec(len(self.prompt), self.max_new_tokens)

    def to_sched_request(self) -> Request:
        """Scheduler view of this request — built ONCE and cached.

        Every field the built-in policies read (spec, submit time,
        predicted cost) is immutable after submission, and ``kv_token_time``
        is the expensive part; caching makes a key evaluation a couple of
        attribute loads instead of a dataclass + cost-model allocation.
        """
        if self._sched_req is None:
            self._sched_req = Request(
                agent_id=self.agent_id,
                rid=self.rid,
                spec=self.spec,
                submit_time=float(self.submit_iter),
                pred_cost=kv_token_time(len(self.prompt), self.max_new_tokens),
                cached_prefix=float(self.cached_hint),
            )
        return self._sched_req


@dataclasses.dataclass
class _FusedPrefill:
    """The single in-flight fused prefill (``fused_prefill=True`` only).

    The request holds a slot and its blocks (all allocated at admission)
    but is NOT in ``slot_req`` or the running queue until its last slice
    lands — it cannot decode, be a swap victim, or complete while
    prefilling.  ``written`` counts K/V rows already resident (starts at
    the prefix-cache hit); the remaining slices cover
    ``[written, total)``.
    """

    req: EngineRequest
    slot: int
    total: int          # len(prompt)
    written: int        # rows already written (prefix hit + done slices)


@dataclasses.dataclass
class EngineAgent:
    agent_id: int
    arrival_iter: int
    stages: list[list[tuple[np.ndarray, int]]]  # stage -> [(prompt, d)]
    predicted_cost: float
    #: closed-loop client: a listener callback may append stages at any
    #: stage boundary (``append_stage``), so fused decode windows must end
    #: at EVERY stage completion of this agent — the window sizer cannot
    #: prove a "final" completion schedules nothing when a callback can
    #: still submit work there
    closed_loop: bool = False
    #: optional per-stage expected cached-prefix hints (engine-scale
    #: tokens), aligned with ``stages``; entries may be None
    hints: Optional[list] = None
    #: per-stage think-time delays in ITERATIONS (PR 9), aligned with
    #: ``stages``: a positive entry suspends the agent that long before
    #: the stage submits (``None``: never)
    resume_delays: Optional[list] = None
    # runtime
    next_stage: int = 0
    live: int = 0
    finish_iter: int = -1


class EngineStalledError(RuntimeError):
    """``run_until_idle`` hit ``max_iters`` before draining.

    Carries the partial results so callers can post-mortem the stall:
    ``completions`` and ``metrics`` are snapshots of the engine state at the
    moment it gave up; the message itself describes queue depths, pool
    occupancy, and per-agent live inference counts.
    """

    def __init__(self, msg: str, completions: dict[int, int], metrics: dict):
        super().__init__(msg)
        self.completions = completions
        self.metrics = metrics


class ServeEngine:
    def __init__(
        self,
        model: Model,
        params,
        scheduler: AgentScheduler,
        *,
        pool_tokens: int = 4096,
        block_size: int = 16,
        max_batch: int = 8,
        cache_len: int = 512,
        prefill_chunk: int = 512,
        max_window: int = 32,
        listener: Any = None,
        prefix_cache: bool = False,
        fused_prefill: bool = False,
        admission_watermark: Any = None,
        suspend_retention: str = "hold",
        device: Any = None,
    ):
        check_servable(model.cfg)
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(
                f"model lives on {model.device}, engine on {self.device}"
            )
        self.model = model
        self.params = params
        self.sched = scheduler
        self.listener = listener
        #: prefix-aware KV reuse (PR 6): admission looks up each prompt's
        #: cached full-block prefix, charges only the uncached suffix to
        #: prefill clock cost + scheduler service, and keeps released
        #: prompt blocks matchable until evicted.  Off (the default) the
        #: engine builds the plain allocator and is bit-identical to the
        #: pre-cache behaviour.
        self.prefix_cache = bool(prefix_cache)
        #: fused prefill-in-window: admission claims a slot and its
        #: blocks at ZERO clock cost, then the prompt's uncached suffix is
        #: prefilled one bounded ``prefill_chunk`` slice per iteration
        #: INSIDE the decode windows (``_fused_window``), so running
        #: decoders keep producing tokens while a prompt streams in instead
        #: of stalling ``ceil(suffix/chunk)-1`` iterations at every
        #: admission.  One fused prefill is in flight at a time; windows
        #: end exactly at slice exhaustion (the ``_window_size`` trigger —
        #: that is the first instant admission can become possible again).
        #: Off (the default) no fused code path runs.
        self.fused_prefill = bool(fused_prefill)
        if self.fused_prefill:
            ring = bool(model.cfg.sliding_window) and min(
                cache_len, model.cfg.sliding_window
            ) < cache_len
            if model.cfg.kind not in ("dense", "moe", "vlm") or ring:
                raise ValueError(
                    "fused_prefill=True needs a full-cache attention "
                    f"family (dense/moe/vlm, no ring buffer); got "
                    f"kind={model.cfg.kind!r} ring={ring}"
                )
        self._pf: Optional[_FusedPrefill] = None
        alloc_cls = PrefixAwareAllocator if prefix_cache else BlockAllocator
        self.alloc = alloc_cls(pool_tokens, block_size)
        #: watermark admission control (PR 8): ``(low_frac, high_frac)``
        #: of the block pool.  While anything occupies a slot (or a fused
        #: prefill is in flight), a NEW admission that would lift block
        #: usage above the high watermark is deferred, and once gated the
        #: gate stays shut until usage drains to the low watermark
        #: (hysteresis) — the pool never enters the recurring swap-thrash
        #: regime just to squeeze one more prompt in.  Swapped
        #: re-admissions are never gated (their blocks hold paged state),
        #: and an idle pool bypasses the gate (progress guarantee).
        #: Strictly flag-gated: ``None`` leaves every admission path
        #: bit-identical to the frozen reference engine.
        if admission_watermark is not None:
            low, high = admission_watermark
            if not (0.0 < low <= high <= 1.0):
                raise ValueError(
                    f"admission_watermark must satisfy 0 < low <= high <= 1,"
                    f" got {admission_watermark!r}"
                )
            nb = self.alloc.n_blocks
            self._wm = (low * nb, high * nb)
        else:
            self._wm = None
        self._wm_gated = False
        self._wm_emitted: set[int] = set()
        #: suspended-agent KV retention (PR 9): a closed-loop stage
        #: appended with ``resume_delay`` iterations of think time does
        #: not submit at its stage boundary — the agent suspends, holding
        #: no decode slot, and the completed stage's final request falls
        #: under this policy: ``hold`` keeps its blocks allocated (with
        #: the prefix cache they stay pinned in the radix index, so the
        #: next turn's prompt is a guaranteed match), ``spill`` copies
        #: the slot's rows to a host staging buffer and releases the
        #: blocks, ``drop`` releases outright (still matchable under the
        #: prefix-aware allocator until evicted).  Under memory pressure
        #: held blocks are released (``_escalate_held``) BEFORE any
        #: running sequence is swapped out.  Strictly flag-gated: with no
        #: suspensions every path is bit-identical to the frozen
        #: reference engine.
        if suspend_retention not in ("hold", "spill", "drop"):
            raise ValueError(
                f"suspend_retention must be 'hold', 'spill' or 'drop',"
                f" got {suspend_retention!r}"
            )
        self.suspend_retention = suspend_retention
        # scheduled resumes: (resume_iter, seq, EngineAgent) min-heap;
        # _held maps a suspended agent to the rid whose blocks it pins
        # (insertion order == suspension order, the escalation order)
        self._resumes: list[tuple[int, int, EngineAgent]] = []
        self._rseq = 0
        self._held: dict[int, int] = {}
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.prefill_chunk = prefill_chunk
        self.max_window = max(1, int(max_window))

        self.cache = model.init_cache(params, max_batch, cache_len)
        self.slot_free = list(range(max_batch))
        self.slot_req: dict[int, EngineRequest] = {}
        # host mirrors of the device-resident slot tensors: authoritative
        # for bookkeeping (swap-out snapshots, stall reports) and the
        # source for rebuilding the device copies when occupancy changes
        self.slot_last_tok = np.zeros(max_batch, np.int32)
        self.slot_pos = np.zeros(max_batch, np.int32)
        self._d_state = torch.zeros((3, max_batch), dtype=torch.int32,
                                    device=self.device)
        self._slots_stale = True   # device copy needs a rebuild

        # waiting/swapped/running share the OrderedQueue (repro.core.
        # queueing): static-key policies keep them sorted by construction;
        # agent-keyed dynamic policies (VTC/SRJF) get grouped invalidation
        # (only the freshly-serviced agents' requests reposition per
        # admission pass); other dynamic policies re-sort lazily when the
        # scheduler's version counter moves.  The running queue orders the
        # in-flight requests by the same key so the swap victim (WORST key)
        # is its tail — O(log n) per eviction instead of an O(n) max scan.
        self._grouped = scheduler.dynamic and getattr(
            scheduler, "agent_keyed", False
        )
        self._dirty_agents: set[int] = set()
        _gf = (lambda req: req.agent_id) if self._grouped else None
        self.waiting: OrderedQueue = OrderedQueue(
            self._key, dynamic=scheduler.dynamic, group_fn=_gf
        )
        self.swapped: OrderedQueue = OrderedQueue(
            self._key, dynamic=scheduler.dynamic, group_fn=_gf
        )
        self.running: OrderedQueue = OrderedQueue(
            self._key, dynamic=scheduler.dynamic, group_fn=_gf
        )
        self._swapped_rids: set[int] = set()
        self._staging: list[Any] = []   # free host KV slot buffers
        self.agents: dict[int, EngineAgent] = {}
        # future arrivals: (arrival_iter, submit order, agent) min-heap
        self.pending: list[tuple[int, int, EngineAgent]] = []
        self.now = 0               # iteration counter
        self.completions: dict[int, int] = {}   # agent -> finish iter
        # re-entrancy guards (listener rule): _in_run covers the drivers,
        # _in_step catches a callback re-entering step() itself
        self._in_run = False
        self._in_step = False
        self._rid = 0
        self._submit_seq = 0
        self.metrics = {"prefills": 0, "decode_steps": 0, "swaps": 0,
                        "tokens": 0, "sorts": 0, "key_evals": 0,
                        "host_syncs": 0, "windows": 0,
                        "prefill_tokens_saved": 0, "prefix_hits": 0,
                        "fused_slices": 0, "admission_deferrals": 0,
                        "suspensions": 0, "resumes": 0,
                        "suspend_spills": 0}
        # per-agent prefix-cache accounting (engine-scale tokens)
        self.agent_prefill_tokens: dict[int, int] = {}
        self.agent_hit_tokens: dict[int, int] = {}

    # -------------------------------------------------------------- warmup

    def warmup(self) -> None:
        """Build the CUDA kernels (all three, in parallel) before serving
        so the first admission does not stall on the compiler (a no-op on
        the CPU, where the plain versions run).  PyTorch runs eagerly:
        nothing else compiles."""
        if self.slot_req or self.busy:
            raise RuntimeError("warmup must run on an idle engine")
        if self.device.type == "cuda":
            kernel_library()

    # ------------------------------------------------------------- events

    def hit_fractions(self) -> dict[int, float]:
        """Per-agent prefix-cache hit fraction: cached / total prefill
        tokens over every admission of the agent's requests (0.0 without
        hits; empty with the cache off and no admissions)."""
        return {
            aid: self.agent_hit_tokens.get(aid, 0) / tot
            for aid, tot in self.agent_prefill_tokens.items()
            if tot > 0
        }

    def _emit(self, event: str, *args) -> None:
        if self.listener is not None:
            fn = getattr(self.listener, event, None)
            if fn is not None:
                fn(*args)

    # ------------------------------------------------------------- submit

    def submit_agent(self, agent: EngineAgent) -> None:
        """Register an agent with the engine.

        If ``agent.arrival_iter`` lies in the future the agent is parked in
        the pending heap and released by ``step()`` when the clock reaches
        it — this is how online (non-upfront) arrivals are driven.  An
        arrival at or before ``self.now`` takes effect immediately, which
        matches the old submit-everything-upfront behaviour.
        """
        self._validate_stages(agent)
        if agent.arrival_iter > self.now:
            heapq.heappush(
                self.pending, (agent.arrival_iter, self._submit_seq, agent)
            )
            self._submit_seq += 1
            return
        self._arrive(agent)

    def _validate_stages(self, agent: EngineAgent) -> None:
        for stage in agent.stages:
            for prompt, d in stage:
                if len(prompt) + int(d) + 1 > self.cache_len:
                    raise ValueError(
                        f"request p={len(prompt)} d={d} exceeds cache_len "
                        f"{self.cache_len}"
                    )

    def _arrive(self, agent: EngineAgent) -> None:
        agent.arrival_iter = self.now
        self.agents[agent.agent_id] = agent
        self.sched.on_agent_arrival(
            agent.agent_id, float(self.now), agent.predicted_cost
        )
        self._emit("on_arrival", agent.agent_id, float(self.now))
        self._submit_stage(agent)

    def _release_arrivals(self) -> None:
        while self.pending and self.pending[0][0] <= self.now:
            _, _, agent = heapq.heappop(self.pending)
            self._arrive(agent)

    def _release_resumes(self) -> None:
        """Wake suspended agents whose think time has elapsed (PR 9)."""
        while self._resumes and self._resumes[0][0] <= self.now:
            _, _, agent = heapq.heappop(self._resumes)
            aid = agent.agent_id
            rid = self._held.pop(aid, None)
            if rid is not None:
                # hold retention: the pinned stage KV served its purpose
                # (the prefix cache re-matches it during admission of the
                # next stage) — release it so admission sees the blocks
                self.alloc.release(rid)
            self.metrics["resumes"] += 1
            self.sched.on_agent_resume(aid, float(self.now))
            self._emit("on_resume", aid, float(self.now))
            self._submit_stage(agent)

    def append_stage(
        self, agent_id: int, stage: list[tuple[np.ndarray, int]],
        hints: Optional[list[float]] = None,
        resume_delay: Optional[int] = None,
    ) -> None:
        """Append one follow-up stage to a live agent (closed-loop).

        May be called from inside an ``on_stage_complete`` listener
        callback — the engine emits it BEFORE the stage-exhaustion check
        in ``_complete``, so the appended stage keeps the agent alive and
        its requests enter the waiting queue in the same iteration.  The
        callback must not re-enter ``run``/``run_until_idle``/``step``.

        Requires ``agent.closed_loop`` (set automatically by the
        ``EngineBackend`` for specs with a ``next_stage`` callback): the
        window sizer only ends fused decode windows at stage boundaries
        of closed-loop agents, so appending to an agent submitted without
        the flag would let a window span its "final" completion and defer
        the appended stage by up to the window width — silently breaking
        the same-iteration cadence this method promises.
        """
        agent = self.agents.get(agent_id)
        if agent is None or agent.finish_iter >= 0:
            raise ValueError(f"agent {agent_id} is not live")
        if not agent.closed_loop:
            raise ValueError(
                f"agent {agent_id} was submitted without closed_loop=True; "
                "fused decode windows do not end at its stage boundaries, "
                "so appended stages would miss the same-iteration cadence"
            )
        for prompt, d in stage:
            if len(prompt) + int(d) + 1 > self.cache_len:
                raise ValueError(
                    f"request p={len(prompt)} d={d} exceeds cache_len "
                    f"{self.cache_len}"
                )
        if resume_delay is not None and int(resume_delay) > 0:
            # think time (PR 9): suspend the agent ``resume_delay``
            # iterations before this stage submits
            if agent.resume_delays is None:
                agent.resume_delays = [None] * len(agent.stages)
            while len(agent.resume_delays) < len(agent.stages):
                agent.resume_delays.append(None)
            agent.resume_delays.append(int(resume_delay))
        agent.stages.append(
            [(np.asarray(p, np.int32), int(d)) for p, d in stage]
        )
        if hints is not None:
            if agent.hints is None:
                agent.hints = [None] * (len(agent.stages) - 1)
            while len(agent.hints) < len(agent.stages) - 1:
                agent.hints.append(None)
            agent.hints.append(list(hints))

    def cancel(self, agent_id: int) -> bool:
        """Withdraw a never-admitted agent (fleet work stealing, PR 10).

        Mirrors ``ClusterSim.cancel``: legal only while the agent's whole
        opening stage still sits in the waiting queue (or its arrival is
        still pending) — a request that was ever admitted, swapped,
        mid-prefill, or suspended makes the agent ineligible and the call
        returns False without touching engine state.  Silent: no events,
        no completion entry; the fleet re-submits the agent elsewhere and
        emits the migration itself.
        """
        for i, (_, _, a) in enumerate(self.pending):
            if a.agent_id == agent_id:
                self.pending.pop(i)
                heapq.heapify(self.pending)
                return True
        agent = self.agents.get(agent_id)
        if agent is None or agent.finish_iter >= 0:
            return False
        if agent.next_stage != 1:
            return False
        if agent_id in self._held or any(
            a.agent_id == agent_id for _, _, a in self._resumes
        ):
            return False
        if any(
            req.agent_id == agent_id for req in self.slot_req.values()
        ) or any(req.agent_id == agent_id for req in self.swapped):
            return False
        if agent.live != len(agent.stages[0]):
            return False         # some opening request already ran
        reqs = [req for req in self.waiting if req.agent_id == agent_id]
        if len(reqs) != agent.live:
            return False         # a request is admitted / mid-prefill
        for req in reqs:
            self.waiting.remove(req)
        del self.agents[agent_id]
        self.sched.on_agent_cancel(agent_id, float(self.now))
        return True

    def _submit_stage(self, agent: EngineAgent) -> None:
        stage = agent.stages[agent.next_stage]
        hints = None
        if agent.hints is not None and agent.next_stage < len(agent.hints):
            hints = agent.hints[agent.next_stage]
        agent.next_stage += 1
        agent.live += len(stage)
        for i, (prompt, d) in enumerate(stage):
            self.waiting.push(
                EngineRequest(
                    agent_id=agent.agent_id,
                    rid=self._rid,
                    prompt=np.asarray(prompt, np.int32),
                    max_new_tokens=int(d),
                    submit_iter=self.now,
                    cached_hint=(
                        float(hints[i])
                        if hints is not None and i < len(hints) else 0.0
                    ),
                )
            )
            self._rid += 1

    # ----------------------------------------------------------- stepping

    def step(self, limit: Optional[int] = None) -> int:
        """Advance the engine: release arrivals, admit, decode.

        Returns the number of iterations consumed (>= 1): when the next K
        iterations are provably event-free the decode runs as one fused
        K-step window (see module doc) and the clock advances by K.
        ``limit`` caps the advance (``run`` passes ``until - now``).
        """
        if self._in_step:
            raise RuntimeError("re-entrant step() from a listener callback")
        self._in_step = True
        try:
            start = self.now
            self._release_arrivals()
            self._release_resumes()
            self._admit()
            if limit is not None:
                # the admission pass may itself advance the clock (chunked
                # prefill cost); shrink the decode budget so a fused window
                # never runs past the caller's `until` horizon
                limit = max(1, int(limit) - (self.now - start))
            k = self._decode_once(limit)
            self.now += 1
            return k
        finally:
            self._in_step = False

    @property
    def busy(self) -> bool:
        """Work is queued or running.  Pending future arrivals and
        scheduled resumes are excluded: both are future clock targets the
        run drivers jump to in O(1), not work the engine can advance."""
        return bool(
            self.waiting or self.swapped or self.slot_req
            or self._pf is not None
        )

    def _next_wake(self, default: int) -> int:
        """Earliest scheduled clock target: pending arrival or
        suspended-agent resume, else ``default`` (both heaps empty)."""
        cands = []
        if self.pending:
            cands.append(self.pending[0][0])
        if self._resumes:
            cands.append(self._resumes[0][0])
        return min(cands) if cands else default

    def run(self, until: int) -> None:
        """Advance the engine clock to iteration ``until`` (re-entrant).

        Idle stretches (nothing queued and no pending arrival due) are
        skipped in O(1) rather than stepped through, so a driver can submit
        agents with sparse future ``arrival_iter``s and simply ``run`` past
        them.
        """
        if self._in_run:
            raise RuntimeError("re-entrant run() from a listener callback")
        self._in_run = True
        try:
            while self.now < until:
                if not self.busy:
                    nxt = self._next_wake(until)
                    if nxt > self.now:
                        self.now = min(int(nxt), until)
                        if self.now >= until:
                            break
                        continue
                self.step(until - self.now)
        finally:
            self._in_run = False

    def run_until_idle(self, max_iters: int = 200_000) -> dict[int, int]:
        """Drain every queue (including pending future arrivals).

        ``max_iters`` budgets *executed* iterations (fused decode windows
        count their full width), not wall steps — idle gaps before
        scheduled arrivals are jumped in O(1) and don't count.
        """
        if self._in_run:
            raise RuntimeError(
                "re-entrant run_until_idle() from a listener callback"
            )
        self._in_run = True
        try:
            steps = 0
            while self.busy or self.pending or self._resumes:
                if steps >= max_iters:
                    raise EngineStalledError(
                        self._stall_report(max_iters),
                        dict(self.completions),
                        dict(self.metrics),
                    )
                if not self.busy:
                    # idle gap before the next scheduled arrival or
                    # suspended-agent resume: jump the clock
                    self.now = max(
                        self.now, int(self._next_wake(self.now))
                    )
                steps += self.step()
        finally:
            self._in_run = False
        return dict(self.completions)

    def _stall_report(self, max_iters: int) -> str:
        live = {
            aid: a.live
            for aid, a in sorted(self.agents.items())
            if a.finish_iter < 0
        }
        return (
            f"engine did not drain (step budget max_iters={max_iters} "
            f"exhausted at iteration "
            f"{self.now}): waiting={len(self.waiting)} "
            f"swapped={len(self.swapped)} running={len(self.slot_req)} "
            f"pending_arrivals={len(self.pending)} "
            f"suspended={len(self._resumes)} held_rids={len(self._held)} "
            f"fused_prefill_in_flight={self._pf is not None} "
            f"free_slots={len(self.slot_free)}/{self.max_batch} "
            f"free_blocks={self.alloc.free_blocks}/{self.alloc.n_blocks} "
            f"completed_agents={len(self.completions)}/{len(self.agents)} "
            f"live_per_agent={live}"
        )

    # ----------------------------------------------------------- admission

    def _key(self, req: EngineRequest):
        # NB: the clock argument is the PASS-consistent `now` — scheduler
        # keys must not read it (see repro.core.queueing module doc); it is
        # passed only to satisfy the policy signature.
        return self.sched.request_key(req.to_sched_request(), float(self.now))

    def _apply_dirty(self) -> None:
        """Propagate freshly-serviced agents to all grouped queues."""
        if self._grouped and self._dirty_agents:
            self.waiting.mark_dirty_many(self._dirty_agents)
            self.swapped.mark_dirty_many(self._dirty_agents)
            self.running.mark_dirty_many(self._dirty_agents)
            self._dirty_agents.clear()

    def _admit(self) -> None:
        # swapped queue has absolute priority and blocks the waiting queue.
        # refresh() is a no-op for static-key policies (sorted-by-
        # construction), a grouped repositioning for agent-keyed dynamic
        # ones, and a lazy version-gated re-sort otherwise.
        version = getattr(self.sched, "version", None)
        self._apply_dirty()
        self.swapped.refresh(version)
        while self.swapped and self.slot_free:
            req = self.swapped.peek()
            if not self.alloc.swap_in(req.rid):
                if self._escalate_held():
                    continue
                break
            self.swapped.popleft()
            self._swapped_rids.discard(req.rid)
            self._restore_slot(req)
        if self.swapped:
            self._sync_queue_metrics()
            return
        self.waiting.refresh(version)
        if self.fused_prefill:
            self._admit_fused()
            self._sync_queue_metrics()
            return
        batch: list[EngineRequest] = []
        while self.waiting and len(self.slot_free) > len(batch):
            req = self.waiting.peek()
            if self._wm is not None and self._wm_gate(req, in_pass=batch):
                break
            if self.prefix_cache:
                if not self.alloc.can_admit_prefix(req.prompt):
                    if self._escalate_held():
                        continue
                    break
                self.waiting.popleft()
                _, hit = self.alloc.admit_prefix(req.rid, req.prompt)
                req.cached_tokens = int(hit)
            else:
                if not self.alloc.can_admit(len(req.prompt) + 1):
                    if self._escalate_held():
                        continue
                    break
                self.waiting.popleft()
                self.alloc.admit(req.rid, len(req.prompt))
            batch.append(req)
        if batch:
            self._prefill_batch(batch)
        self._sync_queue_metrics()

    def _admit_fused(self) -> None:
        """Fused-mode admission: claim ONE waiting request at zero clock.

        The slot and every prompt block are allocated now, the scheduler
        service deal and ``on_admit`` are stamped now (at an unmoved
        ``now``), but the uncached suffix's K/V is produced one slice per
        iteration inside the following fused decode windows — running
        decoders never stall.  A prefix-cache hit's head is written
        immediately by the batched prefill program (its KV is presumed
        resident — the same zero-iteration assumption the unfused path
        makes); a fully-cached prompt therefore becomes a decoder with no
        fused slices at all, preserving the shortened-TTFT semantics.
        """
        if self._pf is not None or not self.slot_free or not self.waiting:
            return
        req = self.waiting.peek()
        if self._wm is not None and self._wm_gate(req):
            return
        if self.prefix_cache:
            while not self.alloc.can_admit_prefix(req.prompt):
                if not self._escalate_held():
                    return
            self.waiting.popleft()
            _, hit = self.alloc.admit_prefix(req.rid, req.prompt)
            req.cached_tokens = int(hit)
        else:
            while not self.alloc.can_admit(len(req.prompt) + 1):
                if not self._escalate_held():
                    return
            self.waiting.popleft()
            self.alloc.admit(req.rid, len(req.prompt))
        p = len(req.prompt)
        hit = req.cached_tokens
        slot = self.slot_free.pop()
        req.slot = slot
        self.metrics["prefills"] += 1
        self.sched.on_service(
            req.agent_id, prefill_tokens=float(p - hit)
        )
        if self._grouped:
            self._dirty_agents.add(req.agent_id)
        self._emit("on_admit", req.agent_id, req.rid, float(self.now))
        self.agent_prefill_tokens[req.agent_id] = (
            self.agent_prefill_tokens.get(req.agent_id, 0) + p
        )
        if hit:
            self.agent_hit_tokens[req.agent_id] = (
                self.agent_hit_tokens.get(req.agent_id, 0) + hit
            )
            self.metrics["prefill_tokens_saved"] += hit
            self.metrics["prefix_hits"] += 1
            self._emit(
                "on_prefix_hit", req.agent_id, req.rid,
                int(hit), int(p), float(self.now),
            )
        if hit >= p:
            # whole prompt cached: one batched write of the resident head
            # also samples the first token — zero fused slices, zero extra
            # iterations, exactly the unfused full-hit cost
            nxt = self._write_prefix_head(req, p, fetch_tok=True)
            self._fused_to_decoder(req, nxt)
            return
        if hit > 0:
            self._write_prefix_head(req, hit, fetch_tok=False)
        else:
            # slices only write the prompt's own rows: mask out the slot's
            # stale rows from its previous occupant first
            _clear_slot_kvpos(self.cache, slot)
        self._pf = _FusedPrefill(req=req, slot=slot, total=p, written=hit)
        self._slots_stale = True

    def _write_prefix_head(self, req: EngineRequest, n: int,
                           fetch_tok: bool):
        """Write the first ``n`` prompt tokens' K/V into the request's slot
        via the batched prefill program (single row, 64-token bucket)."""
        bucket = -(-max(n, 1) // 64) * 64
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :n] = req.prompt[:n]
        dev = self.device
        nxt = _prefill_write(
            self.model, self.cache_len, self.prefill_chunk,
            self.params, self.cache, torch.from_numpy(toks).to(dev),
            torch.tensor([n], dtype=torch.int32, device=dev), [req.slot],
        )
        if fetch_tok:
            self.metrics["host_syncs"] += 1
            return int(nxt.cpu()[0])
        return None

    def _fused_to_decoder(self, req: EngineRequest, first_tok: int) -> None:
        """Promote a finished fused prefill to a running decoder: its first
        decode step — the request's first emitted token — runs in the next
        window."""
        slot = req.slot
        self.slot_req[slot] = req
        self.slot_last_tok[slot] = first_tok
        self.slot_pos[slot] = len(req.prompt)
        self.running.push(req)
        self._slots_stale = True

    def _sync_queue_metrics(self) -> None:
        self.metrics["sorts"] = (
            self.waiting.sorts + self.swapped.sorts + self.running.sorts
        )
        self.metrics["key_evals"] = (
            self.waiting.key_evals
            + self.swapped.key_evals
            + self.running.key_evals
        )

    # ------------------------------------------------------------- prefill

    def _prefill_batch(self, batch: list[EngineRequest]) -> None:
        """Prefill every admitted request of this pass.

        Attention-cache families run as ONE bucketed multi-sequence prefill
        (padded to the group's 64-token bucket and to a power-of-two batch,
        as the JAX engine pads them; the lens mask keeps logits exact and
        invalid cache slots unattendable, out-of-bounds padding slots are
        dropped).  Recurrent families (ssm/hybrid/encdec) prefill one
        sequence at a time — padding would pollute their recurrent state.
        The iteration cost of the pass,
        sum(ceil(p/prefill_chunk) - 1), is applied to the clock ONCE at the
        end so every admission decision and event stamp of the pass sees a
        consistent ``now``.
        """
        now0 = self.now
        batched_ok = self.model.cfg.kind in ("dense", "moe", "vlm")
        groups = [batch] if batched_ok else [[r] for r in batch]
        for group in groups:
            k = len(group)
            for req in group:
                req.slot = self.slot_free.pop()
                self.slot_req[req.slot] = req
            plens = [len(req.prompt) for req in group]
            if batched_ok:
                # bucket prompt lengths to multiples of 64 and the batch to
                # a power of two, as the JAX engine does to bound its
                # compilations; padding rows cost only a little compute
                bucket = max(-(-max(p, 1) // 64) * 64 for p in plens)
                k_pad = 1 << (k - 1).bit_length() if k > 1 else 1
            else:
                bucket = max(max(p, 1) for p in plens)
                k_pad = 1
            toks = np.zeros((k_pad, bucket), np.int32)
            lens = np.ones(k_pad, np.int32)              # dummy rows: 1 tok
            slots = np.full(k_pad, self.max_batch, np.int32)   # OOB: dropped
            for i, req in enumerate(group):
                toks[i, : plens[i]] = req.prompt
                lens[i] = plens[i]
                slots[i] = req.slot
            dev = self.device
            nxt = _prefill_write(
                self.model, self.cache_len, self.prefill_chunk,
                self.params, self.cache,
                torch.from_numpy(toks).to(dev),
                torch.from_numpy(lens).to(dev), slots,
            )
            nxt_host = nxt.cpu().numpy()[:k]
            self.metrics["host_syncs"] += 1
            for req, p, tok in zip(group, plens, nxt_host):
                self.slot_last_tok[req.slot] = tok
                self.slot_pos[req.slot] = p
                self.running.push(req)
                self.metrics["prefills"] += 1
                # a prefix-cache hit skips the cached chunk: only the
                # uncached suffix is charged to the scheduler's service
                # deal (cached_tokens is 0 with the cache off, so the
                # expression — and the off path — is unchanged)
                self.sched.on_service(
                    req.agent_id,
                    prefill_tokens=float(p - req.cached_tokens),
                )
                if self._grouped:
                    self._dirty_agents.add(req.agent_id)
                self._emit("on_admit", req.agent_id, req.rid, float(now0))
                self.agent_prefill_tokens[req.agent_id] = (
                    self.agent_prefill_tokens.get(req.agent_id, 0) + p
                )
                if req.cached_tokens:
                    self.agent_hit_tokens[req.agent_id] = (
                        self.agent_hit_tokens.get(req.agent_id, 0)
                        + req.cached_tokens
                    )
                    self.metrics["prefill_tokens_saved"] += req.cached_tokens
                    self.metrics["prefix_hits"] += 1
                    self._emit(
                        "on_prefix_hit", req.agent_id, req.rid,
                        int(req.cached_tokens), int(p), float(now0),
                    )
        self._slots_stale = True
        # prefill costs ceil(p / prefill_chunk) iterations of engine time
        # per request — with the prefix cache on, only the uncached suffix
        # is charged (a full hit costs 0 extra iterations); the accounting
        # stays serial-equivalent (sum, exactly as the reference engine
        # charged it) but lands after the pass
        self.now = now0 + sum(
            max(1, -(-p // self.prefill_chunk)) - 1
            for p in (
                len(r.prompt) - r.cached_tokens for r in batch
            )
        )

    # --------------------------------------------------------------- swaps

    def _stage_out(self, req: EngineRequest, slot: int) -> None:
        """Copy slot ``slot``'s cache rows into a host staging buffer."""
        dev = _gather_slot(self.cache, slot)
        self.metrics["host_syncs"] += 1
        if self._staging:
            buf = self._staging.pop()
            for key, dst in buf.items():
                dst.copy_(dev[key])
            req.swapped_kv = buf
        else:
            # owned copies: on the CPU the gathered rows are views of the
            # cache, and the staging pool recycles its buffers
            req.swapped_kv = _to_host(dev)

    def _restore_slot(self, req: EngineRequest) -> None:
        slot = self.slot_free.pop()
        req.slot = slot
        self.slot_req[slot] = req
        _scatter_slot(self.cache, req.swapped_kv, slot)
        self.metrics["host_syncs"] += 1
        # recycling the staged buffer is safe: a copy from pageable host
        # memory has read its source by the time copy_ returns
        if len(self._staging) < 2 * self.max_batch:
            self._staging.append(req.swapped_kv)
        req.swapped_kv = None
        self.slot_last_tok[slot] = req._last_tok
        self.slot_pos[slot] = len(req.prompt) + req.generated
        self.running.push(req)
        self._slots_stale = True
        self.metrics["swaps"] += 1
        self._emit("on_swap_in", req.agent_id, req.rid, float(self.now))

    def _swap_out_worst(self) -> bool:
        """Evict the running request with the WORST scheduler key —
        after victimizing suspended agents' held KV first (PR 9): a
        thinker's retained blocks are always cheaper to give up than a
        running decoder's progress."""
        if self._escalate_held():
            return True
        if len(self.slot_req) <= 1:
            return False
        self._apply_dirty()
        self.running.refresh(getattr(self.sched, "version", None))
        req = self.running.pop_right()
        slot = req.slot
        self._stage_out(req, slot)
        req._last_tok = int(self.slot_last_tok[slot])
        self.alloc.swap_out(req.rid)
        self.slot_req.pop(slot)
        self.slot_free.append(slot)
        req.slot = -1
        self.swapped.push(req)
        self._swapped_rids.add(req.rid)
        self._slots_stale = True
        self._emit("on_swap_out", req.agent_id, req.rid, float(self.now))
        return True

    # -------------------------------------------------------------- decode

    def _refresh_device_slots(self) -> None:
        """Rebuild the device slot tensor from the host mirrors (only
        after slot occupancy changed: admit/swap/complete) — one upload."""
        state = np.zeros((3, self.max_batch), np.int32)
        state[0] = self.slot_last_tok
        state[1] = self.slot_pos
        for slot, req in self.slot_req.items():
            state[2, slot] = req.max_new_tokens - req.generated
        if self._pf is not None:
            # the prefilling slot rides the window frozen (rem 0) with its
            # pos at the next slice start — the fused program's choreography
            # relies on it (see _fused_window)
            state[1, self._pf.slot] = self._pf.written
            state[2, self._pf.slot] = 0
        self._d_state = torch.from_numpy(state).to(self.device)
        self._slots_stale = False
        self.metrics["host_syncs"] += 1

    def _queued_admittable(self) -> bool:
        """Could ANY queued request be (re-)admitted right now?

        Evaluated after the current step's token growth: its swap-outs may
        have freed more blocks than the growth consumed, making a request
        that failed this pass's ``_admit`` fit again (the reference engine
        would then admit it at the NEXT iteration — so a fused window must
        not span it).  Free blocks and slots only shrink inside a window,
        hence a False answer stays False for every step the window covers.
        Static policies check only the HEAD — ``_admit`` never looks past
        it and the order is frozen, so this is exact; dynamic policies may
        promote any item by the next pass, so the whole queue is scanned
        (long backlogs return a conservative True rather than pay an O(W)
        scan per window).
        """
        if not self.slot_free:
            return False          # both admission paths need a free slot
        free = self.alloc.free_blocks
        # prefix cache: a swapped sequence whose cached chain survived may
        # need 0 fresh blocks, so zero free is not conclusive there
        if free == 0 and not self.prefix_cache:
            return False
        if self._held and (
            self.swapped or (self.waiting and self._pf is None)
        ):
            # held-KV escalation can free blocks at the very next admit
            # pass, so a failed fit now is not conclusive (PR 9)
            return True
        static = not self.sched.dynamic
        if self.swapped:
            # a non-empty swapped queue blocks the waiting queue entirely
            if static:
                return self._swap_in_fits(self.swapped.peek(), free)
            if len(self.swapped) > 64:
                return True
            return any(
                self._swap_in_fits(req, free) for req in self.swapped
            )
        if self.waiting:
            if self._pf is not None:
                # fused mode runs ONE prefill at a time: while it is in
                # flight the waiting queue is blocked, and the window is
                # separately capped at slice exhaustion — the first
                # instant admission can become possible again
                return False
            if static:
                return self._admit_fits(self.waiting.peek(), free)
            if len(self.waiting) > 64:
                return True
            return any(
                self._admit_fits(req, free) for req in self.waiting
            )
        return False

    def _swap_in_fits(self, req: EngineRequest, free: int) -> bool:
        """Would ``swap_in`` succeed for this request right now?

        Prefix cache: fresh-block need shrinks by the surviving cached
        chain.  Within a window matches only disappear (eviction) and free
        blocks only shrink, so a False answer stays False — the
        monotonicity `_queued_admittable` relies on.
        """
        if self.prefix_cache:
            return self.alloc.can_swap_in(req.rid)
        s = self.alloc.seq(req.rid)
        return self.alloc.blocks_for(max(1, s.n_tokens)) <= free

    def _admit_fits(self, req: EngineRequest, free: int) -> bool:
        if self._wm is not None and self._wm_defers(req):
            return False
        if self.prefix_cache:
            return self.alloc.can_admit_prefix(req.prompt)
        return self.alloc.blocks_for(len(req.prompt) + 1) <= free

    # ------------------------------------------------- watermark admission

    def _wm_gate(self, req: EngineRequest, in_pass=()) -> bool:
        """Watermark verdict for the waiting head DURING an admission pass
        (updates the hysteresis gate and emits the deferral; ``in_pass``
        is the pass's already-admitted batch, so the idle-pool bypass only
        applies to a genuinely empty pool)."""
        if not (self.slot_req or self._pf is not None or in_pass):
            return False                       # idle-pool bypass
        low_b, high_b = self._wm
        used = self.alloc.n_blocks - self.alloc.free_blocks
        if self._wm_gated and used <= low_b:
            self._wm_gated = False
        need = self.alloc.blocks_for(len(req.prompt) + 1)
        if self._wm_gated or used + need > high_b:
            self._wm_gated = True
            if req.rid not in self._wm_emitted:
                self._wm_emitted.add(req.rid)
                self.metrics["admission_deferrals"] += 1
                self._emit(
                    "on_admission_deferred", req.agent_id, req.rid,
                    float(self.now),
                )
            return True
        return False

    def _wm_defers(self, req: EngineRequest) -> bool:
        """Pure watermark verdict (no gate mutation, no emission) — used
        by ``_queued_admittable`` via ``_admit_fits`` so window sizing and
        the next admission pass agree.  Monotone within a fused window:
        block usage only grows and the gate state only moves inside
        ``_admit``, so a True verdict stays True for every covered step.
        """
        if not (self.slot_req or self._pf is not None):
            return False
        low_b, high_b = self._wm
        used = self.alloc.n_blocks - self.alloc.free_blocks
        if self._wm_gated and used > low_b:
            return True
        return used + self.alloc.blocks_for(len(req.prompt) + 1) > high_b

    def _window_size(self, limit: Optional[int]) -> int:
        """Largest provably scheduling-free decode window (pow2 capped).

        A window of K iterations is safe iff within it (after the current
        step's token growth has already been committed):

        * no pending arrival comes due (K <= next arrival - now);
        * no queued request could be admitted with the current pool state
          (``_queued_admittable`` — free blocks/slots only shrink inside a
          window, so the check holds for every covered step);
        * every sequence's remaining token appends fit the block pool (so
          swap-outs cannot trigger and the queues stay untouched);
        * no completion that would SCHEDULE anything happens before the
          window's last step.  With the queues empty a final-stage
          completion schedules nothing — the freed slot cannot be refilled
          and the device row freezes exactly like the reference engine's
          stale freed slot — so the window may span it; a completion that
          finishes a STAGE with a successor submits new work and bounds
          the window instead.  With a backlog queued, every completion
          frees a slot an admission could take, so the window ends at the
          first one;
        * (fused prefill only) the in-flight prefill's slices do not run
          out before the window's last step (K <= remaining slices): its
          last slice completing turns the slot into a decoder AND unblocks
          waiting-queue admission, both scheduling actions — the window
          ends exactly there.
        """
        cap = self.max_window if limit is None else min(
            self.max_window, max(1, int(limit))
        )
        if self.pending:
            cap = min(cap, int(self.pending[0][0]) - self.now)
        if self._resumes:
            # a suspended agent's resume submits new work (PR 9) — any
            # mid-run scheduling trigger must bound the window
            cap = min(cap, int(self._resumes[0][0]) - self.now)
        if self._pf is not None:
            chunk = self.prefill_chunk
            cap = min(cap, -(-(self._pf.total - self._pf.written) // chunk))
        if cap <= 1:
            return 1
        if self.waiting or self.swapped:
            if self._queued_admittable():
                return 1
            # backlog: a completion frees a slot -> window ends at the
            # first one
            for req in self.slot_req.values():
                cap = min(cap, req.max_new_tokens - req.generated)
        elif self.slot_req:
            # empty queues: only stage-submitting completions schedule.
            # An agent's stage completes when its LAST live request does
            # (queues empty => all its live requests are running here;
            # a fused prefill's request is NOT — its stage cannot complete
            # within the window, so it binds nothing).
            last_done: dict[int, int] = {}
            for req in self.slot_req.values():
                rem = req.max_new_tokens - req.generated
                aid = req.agent_id
                last_done[aid] = max(last_done.get(aid, 0), rem)
            # never run past the final live completion — the reference
            # idles there, so extra frozen steps would inflate the clock.
            # With a fused prefill in flight the engine is NOT idle after
            # the last decoder completes: the slice-exhaustion cap above
            # already bounds the window, so the decoder bound is only
            # applied when it is the binding one
            if self._pf is None:
                cap = min(cap, max(last_done.values()))
            for aid, t_stage in last_done.items():
                agent = self.agents[aid]
                # closed-loop agents: a callback may append a stage at ANY
                # completion, so every stage boundary bounds the window
                if agent.closed_loop or agent.next_stage < len(agent.stages):
                    cap = min(cap, t_stage)
        if cap <= 1:
            return 1
        bs = self.alloc.block_size
        free = self.alloc.free_blocks
        slack = []
        for req in self.slot_req.values():
            s = self.alloc.seq(req.rid)
            slack.append(s.n_blocks * bs - s.n_tokens)

        def blocks_needed(m: int) -> int:
            return sum(max(0, -(-(m - sl) // bs)) for sl in slack)

        while cap > 1 and blocks_needed(cap - 1) > free:
            cap -= 1
        if cap <= 1:
            return 1
        # pow2 bucket, as the JAX engine sizes its windows: the windows,
        # and so the window and host-sync counters, stay identical to it
        return 1 << (cap.bit_length() - 1)

    def _decode_once(self, limit: Optional[int] = None) -> int:
        if not self.slot_req and self._pf is None:
            return 1
        # grow each running sequence by one token (may trigger swaps)
        for slot in sorted(self.slot_req):
            req = self.slot_req.get(slot)
            if req is None:
                continue
            while not self.alloc.append_token(req.rid):
                if not self._swap_out_worst():
                    break
                if req.rid not in self._swapped_rids:
                    continue
                break
            # note: if req itself was swapped out it no longer decodes
        active = sorted(self.slot_req)
        if not active and self._pf is None:
            return 1
        k = self._window_size(limit)
        snapshot = [(slot, self.slot_req[slot]) for slot in active]
        if k > 1:
            # commit the window's remaining token growth up front (the
            # step-1 append already ran above; a request completing at
            # window step r appends exactly r tokens, like the reference's
            # per-step growth loop) — _window_size proved it all fits, so
            # no swap decision is being skipped
            for slot, req in snapshot:
                extra = min(k, req.max_new_tokens - req.generated) - 1
                if extra and not self.alloc.append_tokens(req.rid, extra):
                    raise AssertionError("window over-committed the pool")
        if self._slots_stale:
            self._refresh_device_slots()
        pf = self._pf
        if pf is not None:
            # slice the next k prompt chunks host-side; the fused program
            # advances one per step alongside the decoders
            chunk = self.prefill_chunk
            sl = np.zeros((k, chunk), np.int32)
            for j in range(k):
                seg = pf.req.prompt[pf.written + j * chunk:
                                    pf.written + (j + 1) * chunk]
                sl[j, :len(seg)] = seg
            self._d_state, toks_dev = _fused_window(
                self.model, k, chunk, self.params, self.cache,
                self._d_state, torch.from_numpy(sl).to(self.device),
                pf.slot, pf.written, pf.total,
            )
            out = toks_dev.cpu().numpy()     # (k, B+1): THE per-window sync
            toks, pf_toks = out[:, :-1], out[:, -1]
            self.metrics["fused_slices"] += k
        else:
            self._d_state, toks_dev = _decode_window(
                self.model, k, self.params, self.cache, self._d_state
            )
            toks = toks_dev.cpu().numpy()    # (k, B): THE per-window sync
        self.metrics["host_syncs"] += 1
        self.metrics["decode_steps"] += k
        self.metrics["windows"] += 1

        # replay the per-token bookkeeping host-side in exact step order;
        # a request whose budget ran out at an earlier window step is
        # frozen (mirrors the device-side rem mask)
        rem0 = {slot: req.max_new_tokens - req.generated
                for slot, req in snapshot}
        for i in range(k):
            if i:
                self.now += 1
            for slot, req in snapshot:
                if i >= rem0[slot]:
                    continue
                req.generated += 1
                self.metrics["tokens"] += 1
                self._emit(
                    "on_token", req.agent_id, req.rid, int(toks[i, slot]),
                    float(self.now),
                )
                self.slot_last_tok[slot] = toks[i, slot]
                self.slot_pos[slot] += 1
                occ = len(req.prompt) + req.generated
                self.sched.on_service(
                    req.agent_id, kv_token_time=float(occ), decode_tokens=1.0
                )
                if self._grouped:
                    self._dirty_agents.add(req.agent_id)
                if req.generated >= req.max_new_tokens:
                    self._complete(slot, req)
        if pf is not None:
            pf.written += k * self.prefill_chunk
            if pf.written >= pf.total:
                # slice exhaustion — the window's last step (the sizer
                # capped K at exactly this): the final slice's argmax is
                # the request's first token; it decodes from the next
                # iteration on
                self._pf = None
                self._fused_to_decoder(pf.req, int(pf_toks[k - 1]))
        return k

    def _complete(self, slot: int, req: EngineRequest) -> None:
        req.done = True
        self.slot_req.pop(slot)
        self.slot_free.append(slot)
        self.running.remove(req)
        self._slots_stale = True
        agent = self.agents[req.agent_id]
        agent.live -= 1
        if agent.live > 0:
            self.alloc.release(req.rid)
            return
        # the stage-complete callback may append a follow-up stage WITH a
        # resume delay, so the KV release decision (hold retention keeps
        # the final rid pinned through think time) must wait for the emit
        self._emit(
            "on_stage_complete", agent.agent_id, agent.next_stage - 1,
            float(self.now),
        )
        if agent.next_stage < len(agent.stages):
            delay = self._stage_delay(agent)
            if delay > 0:
                self._suspend(agent, req, slot, delay)
                return
            self.alloc.release(req.rid)
            self._submit_stage(agent)
        else:
            self.alloc.release(req.rid)
            agent.finish_iter = self.now
            self.completions[agent.agent_id] = self.now
            self.sched.on_agent_complete(agent.agent_id, float(self.now))
            self._emit(
                "on_agent_complete", agent.agent_id, float(self.now)
            )

    def _stage_delay(self, agent: EngineAgent) -> int:
        """Resume delay (iterations) attached to the agent's NEXT stage."""
        delays = agent.resume_delays
        if delays is None or agent.next_stage >= len(delays):
            return 0
        d = delays[agent.next_stage]
        return int(d) if d is not None else 0

    def _suspend(
        self, agent: EngineAgent, req: EngineRequest, slot: int, delay: int
    ) -> None:
        """Park a closed-loop agent through tool-call think time (PR 9).

        The agent holds NO decode slot while suspended (it was freed by
        ``_complete`` before this call).  Its finished stage's KV falls
        under the retention policy:

        * ``hold``  — the final rid stays allocated (pinned blocks); the
          next stage re-matches it byte-for-byte via the prefix cache.
          ``_escalate_held`` releases it under memory pressure.
        * ``spill`` — the slot's cache rows are gathered to a host
          staging buffer (counted as a host sync) and the blocks are
          released; the radix index may still serve the prefix until
          eviction.
        * ``drop``  — blocks released outright; with the prefix cache on,
          reprefill is cheap while the chain survives in the radix index.
        """
        aid = agent.agent_id
        if self.suspend_retention == "hold":
            self._held[aid] = req.rid
        else:
            if self.suspend_retention == "spill":
                dev = _gather_slot(self.cache, slot)
                self.metrics["host_syncs"] += 1
                if len(self._staging) < 2 * self.max_batch:
                    self._staging.append(_to_host(dev))
                self.metrics["suspend_spills"] += 1
            self.alloc.release(req.rid)
        until = self.now + int(delay)
        self._rseq += 1
        heapq.heappush(self._resumes, (until, self._rseq, agent))
        self.metrics["suspensions"] += 1
        self.sched.on_agent_suspend(aid, float(self.now))
        self._emit(
            "on_suspend", aid, agent.next_stage - 1, float(until),
            float(self.now),
        )

    def _escalate_held(self) -> bool:
        """Release the oldest suspended agent's pinned KV (hold -> drop).

        Called when admission, swap-in, or victim selection cannot make
        progress: suspended agents are victimized BEFORE running ones.
        With the prefix cache on, the released blocks stay matchable in
        the radix index until evicted, so escalation degrades hold into
        an effective drop rather than wedging the pool.
        """
        if not self._held:
            return False
        aid = next(iter(self._held))
        rid = self._held.pop(aid)
        self.alloc.release(rid)
        self.metrics["suspend_spills"] += 1
        return True
