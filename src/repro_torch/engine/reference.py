"""Frozen pre-rewrite serving engine: the behavioural oracle and perf
baseline of the port.

PyTorch counterpart of ``repro.engine.reference``: the ``ServeEngine`` hot
path as it stood before the device-resident rewrite, kept so that

  * the port's ``ServeEngine`` can be PROVEN behaviour-preserving on the
    card without the JAX package — both engines must produce identical
    completion dicts, clocks, swap/prefill/token counts and event streams
    (``tests/test_torch_engine_reference.py``, ``chip_smoke.py`` phase 12);
  * the rewrite's speedup can be measured against the very code it
    replaced.

The host logic is the JAX oracle's line for line: admission, ``_key``, the
three queues, the ``max()`` victim scan, ``_complete``, stall reports,
events and metrics.  Only the device side differs: ``Model.prefill`` and
``Model.decode`` (which run under ``torch.no_grad()``) are called directly
(PyTorch runs eagerly: there is no compile step), slot writes go in place
into the cache's rows, and a swapped-out slot's rows are OWNED host copies
(``big[:, slot]`` is a view; without the copy a CPU engine's swapped KV
would alias the slot that the next occupant overwrites).

Like ``repro_torch.sim.reference``, this core is deliberately FROZEN:
semantic changes to the engine must patch ``repro_torch.engine.engine``
and, if they are meant to change behaviour, retire the corresponding
oracle assertions — never edit this file to make a mismatch go away.

Known per-iteration costs retained here (what the rewrite removed): host
round trips for decode tokens and slot positions every step, whole-row
cache writes on every prefill and swap, one-at-a-time prefill admission,
and O(running) ``max()`` swap-victim scans.  It decodes EVERY slot, free
ones included, at their stale ``slot_pos`` (the rows are discarded).
"""

from __future__ import annotations

import heapq
from typing import Any

import numpy as np
import torch

from repro_torch.core.queueing import OrderedQueue
from repro_torch.core.schedulers import AgentScheduler
from repro_torch.device import resolve_device
from repro_torch.engine.engine import (
    EngineAgent,
    EngineRequest,
    EngineStalledError,
    check_servable,
)
from repro_torch.kvcache.allocator import BlockAllocator
from repro_torch.models import Model


class ReferenceServeEngine:
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
        listener: Any = None,
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
        self.alloc = BlockAllocator(pool_tokens, block_size)
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.prefill_chunk = prefill_chunk

        self.cache = model.init_cache(params, max_batch, cache_len)
        self.slot_free = list(range(max_batch))
        self.slot_req: dict[int, EngineRequest] = {}
        self.slot_last_tok = np.zeros(max_batch, np.int32)
        self.slot_pos = np.zeros(max_batch, np.int32)

        # waiting/swapped are the shared OrderedQueue (core.queueing):
        # static-key policies keep them sorted by construction; agent-keyed
        # dynamic policies (VTC/SRJF) get grouped invalidation (only the
        # freshly-serviced agents' requests reposition per admission pass);
        # other dynamic policies re-sort lazily when the scheduler's
        # version counter moves
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
        self.agents: dict[int, EngineAgent] = {}
        # future arrivals: (arrival_iter, submit order, agent) min-heap
        self.pending: list[tuple[int, int, EngineAgent]] = []
        self.now = 0               # iteration counter
        self.completions: dict[int, int] = {}   # agent -> finish iter
        self._rid = 0
        self._submit_seq = 0
        self.metrics = {"prefills": 0, "decode_steps": 0, "swaps": 0,
                        "tokens": 0, "sorts": 0, "key_evals": 0}

    # ------------------------------------------------------------- events

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

    def _submit_stage(self, agent: EngineAgent) -> None:
        stage = agent.stages[agent.next_stage]
        agent.next_stage += 1
        agent.live += len(stage)
        for prompt, d in stage:
            self.waiting.push(
                EngineRequest(
                    agent_id=agent.agent_id,
                    rid=self._rid,
                    prompt=np.asarray(prompt, np.int32),
                    max_new_tokens=int(d),
                    submit_iter=self.now,
                )
            )
            self._rid += 1

    # ----------------------------------------------------------- stepping

    def step(self) -> None:
        """One engine iteration: release arrivals, admit, one decode step."""
        self._release_arrivals()
        self._admit()
        self._decode_once()
        self.now += 1

    @property
    def busy(self) -> bool:
        """Work is queued or running (pending future arrivals excluded)."""
        return bool(self.waiting or self.swapped or self.slot_req)

    def run(self, until: int) -> None:
        """Advance the engine clock to iteration ``until`` (re-entrant).

        Idle stretches (nothing queued and no pending arrival due) are
        skipped in O(1) rather than stepped through, so a driver can submit
        agents with sparse future ``arrival_iter``s and simply ``run`` past
        them.
        """
        while self.now < until:
            if not self.busy:
                nxt = self.pending[0][0] if self.pending else until
                if nxt > self.now:
                    self.now = min(int(nxt), until)
                    if self.now >= until:
                        break
                    continue
            self.step()

    def run_until_idle(self, max_iters: int = 200_000) -> dict[int, int]:
        """Drain every queue (including pending future arrivals).

        ``max_iters`` budgets *executed* steps, not the clock value — idle
        gaps before scheduled arrivals are jumped in O(1) and don't count.
        """
        steps = 0
        while self.busy or self.pending:
            if steps >= max_iters:
                raise EngineStalledError(
                    self._stall_report(max_iters),
                    dict(self.completions),
                    dict(self.metrics),
                )
            if not self.busy:
                # idle gap before the next scheduled arrival: jump the clock
                self.now = max(self.now, int(self.pending[0][0]))
            self.step()
            steps += 1
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
            f"free_slots={len(self.slot_free)}/{self.max_batch} "
            f"free_blocks={self.alloc.free_blocks}/{self.alloc.n_blocks} "
            f"completed_agents={len(self.completions)}/{len(self.agents)} "
            f"live_per_agent={live}"
        )

    # ----------------------------------------------------------- admission

    def _key(self, req: EngineRequest):
        return self.sched.request_key(req.to_sched_request(), float(self.now))

    def _admit(self) -> None:
        # swapped queue has absolute priority and blocks the waiting queue.
        # refresh() is a no-op for static-key policies (sorted-by-
        # construction), a grouped repositioning for agent-keyed dynamic
        # ones, and a lazy version-gated re-sort otherwise.
        version = getattr(self.sched, "version", None)
        if self._grouped and self._dirty_agents:
            self.waiting.mark_dirty_many(self._dirty_agents)
            self.swapped.mark_dirty_many(self._dirty_agents)
            self._dirty_agents.clear()
        self.swapped.refresh(version)
        while self.swapped and self.slot_free:
            req = self.swapped.peek()
            if not self.alloc.swap_in(req.rid):
                break
            self.swapped.popleft()
            self._restore_slot(req)
        if self.swapped:
            self._sync_queue_metrics()
            return
        self.waiting.refresh(version)
        while self.waiting and self.slot_free:
            req = self.waiting.peek()
            if not self.alloc.can_admit(len(req.prompt) + 1):
                break
            self.waiting.popleft()
            self.alloc.admit(req.rid, len(req.prompt))
            self._prefill_into_slot(req)
            self._emit("on_admit", req.agent_id, req.rid, float(self.now))
        self._sync_queue_metrics()

    def _sync_queue_metrics(self) -> None:
        self.metrics["sorts"] = self.waiting.sorts + self.swapped.sorts
        self.metrics["key_evals"] = (
            self.waiting.key_evals + self.swapped.key_evals
        )

    # ------------------------------------------------------------- prefill

    def _prefill_into_slot(self, req: EngineRequest) -> None:
        slot = self.slot_free.pop()
        req.slot = slot
        self.slot_req[slot] = req
        p = len(req.prompt)
        prompt = req.prompt
        if self.model.cfg.kind in ("dense", "moe", "vlm"):
            # bucket prompt lengths to multiples of 64 to bound the number
            # of prefill compilations; the lens mask keeps logits exact
            bucket = -(-max(p, 1) // 64) * 64
            prompt = np.pad(prompt, (0, bucket - p))
        toks = torch.as_tensor(prompt[None, :], dtype=torch.int32,
                               device=self.device)
        logits, small_cache = self.model.prefill(
            self.params,
            {"tokens": toks,
             "lens": torch.tensor([p], dtype=torch.int32,
                                  device=self.device)},
            cache_len=self.cache_len,
        )
        self._write_cache_slot(slot, small_cache)
        nxt = int(torch.argmax(logits[0, -1]))
        self.slot_last_tok[slot] = nxt
        self.slot_pos[slot] = p
        # prefill costs ceil(p / prefill_chunk) iterations of engine time
        self.now += max(1, -(-p // self.prefill_chunk)) - 1
        self.metrics["prefills"] += 1
        self.sched.on_service(req.agent_id, prefill_tokens=float(p))
        if self._grouped:
            self._dirty_agents.add(req.agent_id)

    def _write_cache_slot(self, slot: int, small_cache: dict) -> None:
        """Copy a B=1 prefill cache into row ``slot`` of the engine cache
        (in place)."""
        for key, big in self.cache.items():
            small = small_cache[key]
            if big.ndim >= 2 and small.shape[0] == big.shape[0]:
                # layer-stacked tensors: (L, B, ...)
                big[:, slot:slot + small.shape[1]] = small.to(big.dtype)

    def _restore_slot(self, req: EngineRequest) -> None:
        slot = self.slot_free.pop()
        req.slot = slot
        self.slot_req[slot] = req
        for key, big in self.cache.items():
            big[:, slot].copy_(req.swapped_kv[key])
        req.swapped_kv = None
        self.slot_last_tok[slot] = req._last_tok
        self.slot_pos[slot] = len(req.prompt) + req.generated
        self.metrics["swaps"] += 1
        self._emit("on_swap_in", req.agent_id, req.rid, float(self.now))

    def _swap_out_worst(self) -> bool:
        """Evict the running request with the WORST scheduler key."""
        if len(self.slot_req) <= 1:
            return False
        slot, req = max(
            self.slot_req.items(), key=lambda kv: self._key(kv[1])
        )
        # an owned host copy: ``big[:, slot]`` is a view of the slot
        req.swapped_kv = {
            key: big[:, slot].to("cpu", copy=True)
            for key, big in self.cache.items()
        }
        req._last_tok = int(self.slot_last_tok[slot])
        self.alloc.swap_out(req.rid)
        self.slot_req.pop(slot)
        self.slot_free.append(slot)
        req.slot = -1
        self.swapped.push(req)
        self._emit("on_swap_out", req.agent_id, req.rid, float(self.now))
        return True

    # -------------------------------------------------------------- decode

    def _decode_once(self) -> None:
        if not self.slot_req:
            return
        # grow each running sequence by one token (may trigger swaps)
        for slot in sorted(self.slot_req):
            req = self.slot_req.get(slot)
            if req is None:
                continue
            while not self.alloc.append_token(req.rid):
                if not self._swap_out_worst():
                    break
                if not any(r.rid == req.rid for r in self.swapped):
                    continue
                break
            # note: if req itself was swapped out it no longer decodes
        active = sorted(self.slot_req)
        if not active:
            return
        toks = torch.as_tensor(self.slot_last_tok[:, None],
                               dtype=torch.int32, device=self.device)
        pos = torch.as_tensor(self.slot_pos, dtype=torch.int32,
                              device=self.device)
        logits, self.cache = self.model.decode(
            self.params, self.cache, toks, pos
        )
        nxt = torch.argmax(logits[:, 0, :], dim=-1).cpu().numpy().astype(
            np.int32
        )
        self.metrics["decode_steps"] += 1

        for slot in list(active):
            req = self.slot_req.get(slot)
            if req is None:
                continue
            req.generated += 1
            self.metrics["tokens"] += 1
            self._emit(
                "on_token", req.agent_id, req.rid, int(nxt[slot]),
                float(self.now),
            )
            self.slot_last_tok[slot] = nxt[slot]
            self.slot_pos[slot] += 1
            occ = len(req.prompt) + req.generated
            self.sched.on_service(
                req.agent_id, kv_token_time=float(occ), decode_tokens=1.0
            )
            if self._grouped:
                self._dirty_agents.add(req.agent_id)
            if req.generated >= req.max_new_tokens:
                self._complete(slot, req)

    def _complete(self, slot: int, req: EngineRequest) -> None:
        req.done = True
        self.alloc.release(req.rid)
        self.slot_req.pop(slot)
        self.slot_free.append(slot)
        agent = self.agents[req.agent_id]
        agent.live -= 1
        if agent.live == 0:
            self._emit(
                "on_stage_complete", agent.agent_id, agent.next_stage - 1,
                float(self.now),
            )
            if agent.next_stage < len(agent.stages):
                self._submit_stage(agent)
            else:
                agent.finish_iter = self.now
                self.completions[agent.agent_id] = self.now
                self.sched.on_agent_complete(agent.agent_id, float(self.now))
                self._emit(
                    "on_agent_complete", agent.agent_id, float(self.now)
                )
