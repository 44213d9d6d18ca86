#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --baseline DIR   # another tree's port, see below

Phases, each of which fails the run (exit code 1) on error:

1. device: the card's name and power limit (``nvidia-smi``); TF32 is
   switched off for float32 matrix products and convolutions, so float32
   comparisons are float32;
2. build: compiles the five CUDA sources of
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` each, in parallel) into
   ``build/torch_kernels`` and prints the build time, each kernel's
   register and shared-memory use and, where ``cuobjdump`` exists, the
   tensor-core instructions (HGMMA, HMMA) in each kernel's SASS; a
   tensor-core kernel (flash's, chunked prefill's, the mLSTM's two passes)
   without HGMMA fails the run, and so does a missing or HGMMA-free hd-80
   instantiation of flash's or chunked prefill's (``TC_HD80``);
3. kernels: every kernel against its plain PyTorch version on the same
   inputs on the card (max |d| <= 2e-5 at float32, <= 3e-2 at bfloat16, the
   tolerances of tests/test_kernels.py; flash prefill logs the path,
   tensor_core or cuda_core, that each case takes, and its bf16 cases at hd
   80 (a single tile, qpk 1, 2 and 4, a window of 100 that cuts a tile)
   must take tensor_core; paged decode logs its split;
   the chunkwise mLSTM on its output and its final state, from the empty
   and from a given state, at any length, each case on the path its rule
   gives and, where that is tensor_core, on the cuda_core kernel too; its
   float32 final state within 1e-4 where h is bfloat16); at the serving
   shapes (granite-3-2b for attention, xlstm-350m's prefill for the mLSTM,
   at 512 and 256 tokens), the median device time of the kernel, of its
   plain version and, for attention, of one
   ``scaled_dot_product_attention`` call (a yardstick the port never
   calls), timed in turns, beside the least time the card needs for the
   work; for the mLSTM also the launch floor of both passes' grids (the
   kernel of ``scripts/launch_floor.cu``, which does nothing, launched with
   their blocks, threads and shared memory), for paged decode also the
   slot caches of 100 and 97 tokens, in the pages ``Model.decode`` views
   them in; then paged decode and flash prefill at the shapes of the
   decoder-only zoo's full-width archs (``ZOO_SHAPES``: llama2-7b's qpk 1,
   llama3.2-3b's qpk 3, starcoder2-7b's qpk 9 at hd 128, h2o-danube-1.8b's
   hd 80, mixtral-8x7b's window, at B 8 and 512 tokens) and flash at
   h2o-danube's windowed prefill past the window (``H2O_PREFILL``), all
   within ``TOL``, and the kernel, plain, SDPA and bound at llama2-7b's
   decode and prefill, at that windowed prefill and at h2o-danube's decode
   over phase 13's 4 slots of 512 tokens; then both at the last
   three families' full-width shapes (``FAMILY_SHAPES``: llava-next-34b's
   qpk 7 at hd 128, B 2 x S 3,136, zamba2-2.7b's MHA at hd 80, B 4 x S
   1,024, whisper-tiny's 6/6 at hd 64), within ``TOL``, with kernel, plain,
   SDPA and bound at each; then chunked prefill's attention kernel
   (``ops.chunk_attention``) against ``attention_any`` on the same card
   tensors (bf16 within ``TOL`` over the queries that attend a key, each
   query that attends none 0, float32 logged): a padding row of length 1,
   a cache of 198 rows whose ``kv_pos`` rows are off 16-byte boundaries, a
   window that cuts tiles, hd 32 and 128, and ``CHUNK_SHAPES`` (the
   benchmark cells' chunk passes: granite-3-2b B 16 x 512 at offsets 0,
   512 and 1,536 of 2,048 rows, h2o-danube-1.8b B 32 x 512 at 0 and 512
   of 1,024), with kernel, plain chain, SDPA with a boolean mask and the
   bound by bytes and by operations at each; then the decode block's glue
   (``csrc/decode_glue.cu``) at granite-3-2b's and h2o-danube-1.8b's
   decode shapes (``GLUE_ARCHS``) at B 64 and 256: each kernel against
   the composition it replaces on the card (the cache and ``kv_pos``
   writes, the residual sum and the rotation bitwise, the norms and
   SiLU-and-multiply within ``GLUE_ULPS`` bf16 ulps; the norms also
   logged at float32, where a variance one bit off shows), its device
   time beside the plain chain's and its bound by bytes, and a
   full-width decode step of each model at its benchmark cell's slots
   (norm scales of 1 +- 0.1), composed and fused: the device operations a
   step and a layer from a profiled step (fused at most
   ``GLUE_MAX_OPS_PER_LAYER`` a layer), the host's enqueue and wall a
   step, each wrapper's launches (n_layers x steps fused, 0 composed;
   paged decode n_layers x steps on both), and the logits bitwise equal;
   and each wrapper (the glue's four included) refuses an input that
   requires grad while grad mode is on (no kernel has a backward) and
   launches under ``torch.no_grad()``; last, ``CHUNK_PREFILL``:
   full-width h2o-danube-1.8b through ``Model.prefill_chunked`` of B 32
   ragged prompts of up to 1,024 tokens in chunks of 512 (the closed
   cell's pass), ``chunk_attention`` launched n_layers x 2 times a pass,
   ``kv_pos`` equal to the one-shot ``Model.prefill``'s, its logits and
   valid K rows within bf16 ``TOL`` of that pass's and every row's argmax
   the same, and the pass's device ms; then that model through
   ``ServeEngine`` at the closed cell's cache of 1,024 and chunk of 512
   (``CHUNK_SERVE``: prompts of 256-900 tokens), the counts zeroed just
   before the run: ``chunk_attention`` n_layers x the chunks of its
   chunked passes, flash n_layers x its one-shot passes, paged decode
   n_layers x its steps;
4. reduced engines: reduced granite-3-2b and reduced xlstm-350m at float32
   served on the GPU (the kernels) and on the CPU (the plain versions)
   under three schedulers with a pool small enough to force swaps;
   completions, clock and counters must be equal, and for xlstm the
   sampled tokens too; then reduced granite with ``prefix_cache`` and
   ``fused_prefill`` on for agents that share prompt heads, a pool of 192
   and a cache of 96 tokens, in 16-token slices under justitia and in
   80-token slices under vtc (each slice after a hit runs past the cache
   end): completions, clock, counters and every sampled token equal, the
   cache hitting, slices running and the pool swapping; then the zoo
   (``reduced_zoo``): reduced mixtral-8x7b over its ring, and with its
   full-width window over a full cache with fused prefill off and on,
   and reduced h2o-danube-1.8b at ``cache_len`` 160 for prompts longer
   than its window of 64, every sampled token equal; then reduced
   llava-next-34b's engine under the three schedulers as granite's, and
   the last three families (``reduced_families``: llava with image
   embeddings, zamba2, whisper with frames, ragged lens) through
   ``Model.prefill`` and 16 greedy ``Model.decode`` steps, every token
   equal and the logits within 1e-4;
5. full width, granite-3-2b at bfloat16 (40 layers, d_model 2048, random
   weights from a seed) served by ``ServeEngine`` (max_batch 8, cache_len
   512, pool 4096 tokens, justitia) for seeded agents; every agent
   completes with its token budget, paged decode launched 40 times per
   decode step and flash prefill launched at all; a profiled decode step
   and a profiled prefill pass (B 8 at the largest bucket the agents
   reach) that splits the flash kernel's device time from the rest;
6. full width, xlstm-350m at bfloat16 (12 mLSTM/sLSTM pairs, d_model 1024,
   4 heads of 256) served the same way; every agent completes with its
   token budget and the mLSTM kernel is launched 12 times per prefill; a
   profiled decode step and a profiled prefill that splits the mLSTM
   kernel's time from the sLSTM loop's;
7. the serving API: (a) phase 5's full-width model served through
   ``repro_torch.api.AgentService.engine`` in the seven runs of
   ``API_RUNS`` (open workload, the same on a 2-replica fleet advanced by
   2 worker threads, closed-loop sessions that swap, tool-use sessions
   that suspend and spill, the closed-loop sessions with the prefix
   cache, the open workload with fused prefill, the tool-use sessions
   with both); each run's finish and JCT per agent, engine counters and
   every agent's event sequence must equal the JAX engine's record
   (``tests/torch_api_jax_runs.json``, made on the CPU at reduced width:
   the engine clock counts iterations, which depend neither on width nor
   dtype nor token values), paged decode must launch n_layers x decode
   steps times (a fused step is one) and flash n_layers x batched prefill
   passes times, a run with the prefix cache must hit and one with fused
   prefill must run slices, every token must be in range; then one fused
   step at the serving shape is timed and profiled beside a decode step
   and its slice alone; (b) ``python -m repro_torch.launch.serve
   --backend engine`` at each of ``LAUNCHER_ARCHS``, as users start it (on
   the card), whose ``jct:`` and ``completions:`` lines must equal the JAX
   launcher's; (c) one prefill
   and one decode step of reduced granite-3-2b at bfloat16 on the card
   against the CPU, logged: the logits' max |d| and the argmax agreement;
8. the decoder-only zoo at full width, bf16, random weights from a seed,
   each model freed before the next: (a) llama2-7b (all 32 layers) and
   (b) mixtral-8x7b (d_model 4096, 8 experts of d_ff 14336, top-2,
   window 4096; cut to 16 of 32 layers, ``ZOO_CUTS``) in
   the ``open`` and ``fused`` runs of ``API_RUNS``, held to the JAX
   record as in phase 7 (no run's record depends on the arch), then a
   profiled decode step at B 8 and, for mixtral, the MoE layers' share of
   it; (c) ``RING_RUN``: h2o-danube-1.8b (all 24 layers) over a 4096-row
   ring, held to the JAX engine's record of the same lengths, paged decode
   launched 0 times and flash n_layers x prefill passes, each past the
   window; (d) llama3.2-3b and starcoder2-7b (all layers) serving phase
   5's agents, every budget complete;
9. the last three families at full width, bf16, random weights from a
   seed, each model freed before the next: (a) llava-next-34b (60 layers,
   d_model 7168, 56/8 heads) in the ``open`` and ``fused`` runs held to the
   JAX record as in phase 8 (the engine passes token prompts, as the JAX
   engine does), then ``Model.prefill`` of B 2 x (2,880 seeded image
   embeddings + 256 text tokens) at ``cache_len`` 4,096 and 32 greedy
   decode steps (flash n_layers times, paged n_layers x 32), a profiled
   decode step and the peak memory; (b) zamba2-2.7b (9 super blocks of 6
   Mamba2 layers, one shared attention block) through ``Model``: prefill
   of B 4 x 1,024 tokens and 64 greedy steps (flash 9 times, paged 9 x
   64), a prefill split into Mamba2 and attention, a profiled decode step;
   (c) whisper-tiny (4 + 4 layers, 1,500 frames): B 4 x 1,500 seeded
   frames and a 32-token prompt, 64 greedy steps, at float32 on the card
   and on the CPU (every token equal), then at bf16 on the card (flash 4
   times and paged 4 x 64 in each card run).  The engine does not serve
   the hybrid and the encoder-decoder, as the JAX engine cannot;
10. the agent cost predictor and training: (a) ``AgentCostPredictor`` fitted
   on the card in Table 1's MLP-row setting (EV and SC, 100 training and
   40 held-out agents each, 64 features), each class's held-out relative
   error under 120 %, its fit time and the median latency of
   ``predict(cls, prompt)``, its costs against a CPU fit logged (Adam's
   eps magnifies ulps, so they are not gated), one ``_adam_step`` card
   against CPU within 1e-5, and the heavy pooled baseline trained on the
   card with finite costs; (b) reduced granite-3-2b at float32: one
   ``make_train_step`` step card against CPU (loss, grad norm and every
   parameter within 1e-4, but for the elements whose gradient is nonzero
   and below 1e-6, which Adam's first step normalises by |g| + 1e-8: held
   to 2 lr), ``tests/test_training.py``'s 80-step learning check (the least
   of the last 5 losses under 0.75 ln 128), and a checkpoint written on
   the card restored on the CPU, every leaf equal; (c) full-width
   granite-3-2b at bf16 through ``repro_torch.launch.train``'s code path
   (``TRAIN_FULL_ARGS``: ``--no-reduced``, batch 8, seq 512, 10 steps):
   every loss and grad norm finite and no kernel launched (training runs
   the plain attention, as the JAX package), the loss curve, the seconds
   per step and the peak memory logged;
11. the distribution layer on the card: (a) an NCCL process group of one
   rank and a 1x1 ("data", "model") ``DeviceMesh``; full-width
   granite-3-2b at bf16 (phase 5's model) through the sharded plans of
   ``repro_torch.launch.specs`` on real DTensors: the prefill plan for B 8
   x 448-token prompts at ``cache_len`` 512, then 32 greedy steps of the
   decode plan, the kernels run on local shards (``local_map``); every
   greedy token equal to the unsharded ``Model``'s on the same parameters
   and prompts, the logits within ``SHARDED_LOGIT_TOL``, flash launched
   40 times and paged decode 40 x 32; (b) ``repro_torch.launch.train``
   with ``--mesh debug --mesh-shape 1,1`` on that group
   (``SHARDED_TRAIN_ARGS``: full-width granite-3-2b at bf16, batch 8 x
   512, 3 steps), each step's loss and grad norm within
   ``SHARDED_TRAIN_TOL`` of the unsharded launcher's from the same
   parameters and batches, no kernel launched, the seconds per step and
   the peak memory logged; the group is destroyed after; (c) in a
   subprocess started before (a) (host work only, so it runs beside (a)
   and (b)), ``launch/dryrun.py``'s ``run_pair`` for every assigned arch
   at ``DRYRUN_ROWS`` (train_4k and decode_32k) on the 16x16 fake mesh at
   full width, every pair ``ok``; per pair its per-device FLOPs,
   collective bytes and argument bytes;
12. the frozen engine at full width, bf16, random weights from a seed,
   each model freed before the next: ``repro_torch.engine.
   ReferenceServeEngine`` (the pre-rewrite engine: one B 1 prefill per
   admission, a host round trip per decode step) serves phase 5's agents
   (max_batch 8, cache_len 512, justitia) for (a) granite-3-2b at pool
   4096 and at pool 1024, which must swap (``FROZEN_RUNS``), and (b)
   xlstm-350m at pool 4096; every agent completes its budget, flash
   launches n_layers x prefills and paged decode n_layers x decode steps
   (the mLSTM 12 x prefills at xlstm); then ``ServeEngine`` serves the
   same agents at the same pool, and its completions, clock, counters
   (``FROZEN_COUNTERS``) and event rows without token values must equal
   the frozen engine's; the wall seconds of both runs and their ratio are
   logged beside the card, with the share of equal sampled tokens (bf16,
   not gated);
13. the four examples (``examples/*_torch.py``), held to the JAX examples'
   record (``tests/torch_examples_jax_runs.json``, ``EXAMPLES_RECORD``):
   (a) every run of ``example_commands`` in a subprocess as users start
   it (no ``--device``: the card), all at once: fairness_demo's table,
   quickstart's completions and engine counters and serve_agents'
   closed-loop flag sets (every line but the wall's and the metrics of
   ``metrics_subset``) must equal the record; the sets that fit the
   predictor on the card are logged line by line against it (the port's
   MLPs start from torch's draws), and so are the card's costs against
   JAX's; train_small's 200 steps must end under ln 512 and its
   checkpoint must restore the trained parameters; the sim set with the
   record's costs must equal the record; (b) serve_agents' default and
   ``chaos`` sets through the example's own functions on full-width
   h2o-danube-1.8b (24 layers, d_model 2560, 32/8 heads, hd 80, window
   4096 over a 512-token cache, so paged decode at qpk 4 and flash on the
   tensor cores) at bf16, each agent's predicted cost from the record:
   every line, the gated metrics and every event row must equal the
   record, paged decode must launch n_layers x decode steps and flash
   n_layers x batched prefill passes, each on the tensor-core path; (c)
   the ``fleet`` set so, with ``--fleet-workers 2`` and without, two
   rounds each in turns: all four identical, their walls and ratio
   logged.

Phase 3's serving run is the only one whose passes outgrow its chunk:
every later run holds flash to n_layers x its passes, which a chunked
pass would not meet.  Each full-width phase and each phase-7, phase-8, phase-9,
phase-12 and phase-13 run zeroes the launch counts just before it serves and reads them
just after, and holds the decode glue's four wrappers to paged decode's
count (``check_glue_counts``: once each a fused layer and step, which is
every paged call of a RoPE model on plain tensors; no ``silu_mul`` in the
MoE; none on a sharded plan's DTensors or without RoPE); each phase's
wall time is logged when the next starts.  The
last lines are the card's name and power limit, one ``{"kernels": ...}``
JSON line (launches summed over phases 5, 6, 8, 9, 11 (a), 12 and 13,
phase 13's also logged on their own, ``chunk_attention``'s those of
phase 3's serving run; phases 10 and 11 (b) launch none;
max |d| the larger
of the granite and llama2-7b shapes' in bfloat16) and, last, ``{"ok": true,
"device": {...}}``.  Without a CUDA device, or without the repository
beside it, the script exits non-zero and prints no result.

``--baseline DIR`` builds the kernels of the port under DIR (an earlier
commit unpacked beside this one), times its three kernels by the method
of phase 3 (at granite-3-2b's shapes, the zoo's and the families', hd
80 included), profiles its granite prefill pass and a decode step after it
as phase 5 does, times its ``CHUNK_PREFILL`` pass and profiles its
xlstm-350m prefill as phase 6 does, so that one
chip call can hold a change against its parent; it prints no result
line.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
#: published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
#: the mLSTM's final (C, n, m), float32 whatever h's type: about 100x the
#: error measured on an H100 (1e-6), well below a typical |C| of 1e-2
STATE_TOL = {"float32": 2e-5, "bfloat16": 1e-4}
#: the check-only source of the launch-floor timing
LAUNCH_FLOOR_SOURCE = ROOT / "scripts" / "launch_floor.cu"
#: GPU clock cycles each timed call waits behind (about 1 ms), longer than
#: the host takes to enqueue any function timed here
SLEEP_CYCLES = 2_000_000
GRANITE = dict(n_layers=40, nh=32, n_kv=8, hd=64)
#: the decode glue's checks: arch -> (cache rows, the slots of its
#: benchmark cell); each kernel is checked at B 64 and 256
GLUE_ARCHS = {"granite-3-2b": (2048, 64), "h2o-danube-1.8b": (1024, 256)}
GLUE_BATCHES = (64, 256)
#: the decode glue's wrappers, each launched once a fused layer and step
GLUE = ("fused_rms_norm", "fused_add_rms_norm", "rope_kv_write", "silu_mul")
#: the most bf16 ulps a glue output may differ from its composition: the
#: rotation and the writes round as it does, step for step; the norms add
#: their squares in PyTorch's order, SiLU calls PyTorch's expf
GLUE_ULPS = {"rms_norm": 1, "add_rms_norm": 1, "rope_q": 0, "silu_mul": 1}
#: the most device operations a fused full-width decode layer may issue
GLUE_MAX_OPS_PER_LAYER = 20
#: decode steps of the full-width glue check
GLUE_STEPS = 3
GLUE_SOURCE = "src/repro_torch/kernels/csrc/decode_glue.cu"
#: kernel functions that must hold tensor-core (HGMMA) instructions
TENSOR_CORE_KERNELS = ("flash_tc_kernel", "chunk_tc_kernel",
                       "mlstm_chunk_states_kernel",
                       "mlstm_chunk_outputs_kernel")
#: flash's hd-80 instantiations (q heads per block 1 and 2), which must be
#: in the SASS with HGMMA
FLASH_TC_HD80 = tuple(f"flash_tc_kernel<80, {wg}>" for wg in (1, 2))
#: the same of chunked prefill's attention kernel, by library
TC_HD80 = {"flash_attention": FLASH_TC_HD80,
           "chunk_attention": tuple(f"chunk_tc_kernel<80, {wg}>"
                                    for wg in (1, 2))}
#: phase 3's chunked-prefill attention at the benchmark cells' chunk passes
#: (heads as ``GRANITE`` and ``ZOO_SHAPES``): arch -> B, a chunk of S
#: queries at each offset of a cache of T rows, and the window
CHUNK_SHAPES = {
    "granite-3-2b": dict(b=16, s=512, t=2048, offsets=(0, 512, 1536),
                         window=0),
    "h2o-danube-1.8b": dict(b=32, s=512, t=1024, offsets=(0, 512),
                            window=4096),
}
#: phase 3's chunked prefill through ``Model``: the closed cell's model,
#: cache and chunk, B 32 prompts of up to 1,024 tokens
CHUNK_PREFILL = dict(arch="h2o-danube-1.8b", b=32, s=1024, cache_len=1024,
                     chunk=512)
#: phase 3's serving run on that model: seeded agents of 1-2 stages of 1-2
#: inferences, prompts of 256-900 tokens (so passes both one-shot and
#: chunked), 8-32 new tokens each
CHUNK_SERVE = dict(seed=34, n=8, prompt=(256, 901), decode=(8, 33))
#: xlstm-350m's prefill of one prompt at the longest cache
XLSTM = dict(b=1, nh=4, s=512, hd=256)
#: phase 3's shapes of the decoder-only zoo's full-width archs: name ->
#: (q heads, kv heads, head dim, window) at batch 8 and 512 tokens
ZOO_SHAPES = {
    "llama2-7b": (32, 32, 128, 0),        # MHA, qpk 1
    "llama3.2-3b": (24, 8, 128, 0),       # qpk 3
    "starcoder2-7b": (36, 4, 128, 0),     # qpk 9
    "h2o-danube-1.8b": (32, 8, 80, 4096),  # hd 80
    "mixtral-8x7b": (32, 8, 128, 4096),
}
#: h2o-danube-1.8b's windowed prefill: B, S (past the window), window
H2O_PREFILL = dict(b=2, s=4608, window=4096)
#: the JAX engine's runs that phase 7 is held to, made on the CPU at
#: reduced width by scripts/record_jax_api_runs.py (tests/test_torch_api.py
#: regenerates it and requires it unchanged)
API_RECORD = ROOT / "tests" / "torch_api_jax_runs.json"
#: the ``AgentService.engine`` arguments every phase-7 run shares
API_SERVE = dict(time_scale=1.0, seed=0, cache_len=512, token_scale=8,
                 max_batch=4)
#: phase 7's runs: the seeded workload, the pool per engine and the
#: service's own arguments (justitia throughout)
API_RUNS = {
    "open": dict(workload="open", seed=0, n_agents=6, pool_tokens=4096),
    "fleet": dict(workload="open", seed=0, n_agents=6, pool_tokens=4096,
                  service=dict(replicas=2, router="round_robin",
                               fleet_workers=2)),
    "closed": dict(workload="closed", seed=20260731, n_agents=5,
                   pool_tokens=512),
    "tooluse": dict(workload="closed", seed=20260731, n_agents=5,
                    pool_tokens=512, classes=("chat", "react", "tooluse"),
                    service=dict(suspend_retention="spill")),
    "prefix": dict(workload="closed", seed=20260731, n_agents=5,
                   pool_tokens=512, service=dict(prefix_cache=True)),
    "fused": dict(workload="open", seed=0, n_agents=6, pool_tokens=4096,
                  service=dict(fused_prefill=True)),
    "fused_prefix": dict(workload="closed", seed=20260731, n_agents=5,
                         pool_tokens=512,
                         classes=("chat", "react", "tooluse"),
                         service=dict(suspend_retention="spill",
                                      prefix_cache=True,
                                      fused_prefill=True)),
}
#: arrival window of every phase-7 workload (workload seconds)
API_WINDOW_S = 20.0
#: the engine counters a run's record holds, one set per engine
API_COUNTERS = ("tokens", "prefills", "swaps", "decode_steps",
                "suspensions", "resumes", "suspend_spills", "prefix_hits",
                "prefill_tokens_saved", "fused_slices")
#: the launcher runs of the record: ``--backend engine`` at each arch
#: (the paper's llama2-7b, mixtral-8x7b: the MoE over a ring cache at the
#: launcher's reduced width, window 64 in 512 tokens, and llava-next-34b:
#: the VLM's token prompts)
LAUNCHER_ARCHS = ("granite-3-2b", "xlstm-350m", "llama2-7b", "mixtral-8x7b",
                  "llava-next-34b")
LAUNCHER_TIMEOUT_S = 300
#: phase 8's ring run: h2o-danube-1.8b at its own window of 4096 in a
#: 6144-token cache (a 4096-row ring) under justitia, for seeded agents of
#: one stage of 1-2 inferences, prompts of 4,200-5,600 tokens and 64-256
#: new tokens each; the record's script serves it on the JAX engine at
#: reduced width with the window kept (the clock does not depend on width)
RING_RUN = dict(arch="h2o-danube-1.8b", seed=2028, n_agents=4,
                p_range=(4200, 5601), d_range=(64, 257), max_batch=4,
                cache_len=6144, pool_tokens=16384)
#: the engine counters the ring run's record holds
RING_COUNTERS = ("tokens", "prefills", "swaps", "decode_steps")
#: phase 8's runs of ``API_RUNS`` at llama2-7b and mixtral-8x7b
ZOO_API_RUNS = ("open", "fused")
#: phase 8's and phase 9's depth cuts: arch -> (layers served, why)
ZOO_CUTS = {"mixtral-8x7b": (16, "32 layers are 93 GB at bf16, more than "
                                 "the card's 80 GB")}
#: the last three families at full width: name -> (B, q heads, kv heads,
#: head dim, prefill S, decode cache rows), the shapes phase 9 gives the
#: kernels (phase 3 checks and times them there)
FAMILY_SHAPES = {
    # qpk 7; 2,880 anyres image embeddings + 256 text tokens
    "llava-next-34b": (2, 56, 8, 128, 3136, 4096),
    # MHA at hd 80 (flash's tensor-core kernel, one head a block); 1,024
    # tokens + 64 steps
    "zamba2-2.7b": (4, 32, 32, 80, 1024, 1152),
    # MHA; a 32-token decoder prompt, padded to flash's 64-token block
    "whisper-tiny": (4, 6, 6, 64, 64, 128),
}
#: phase 9's runs: llava-next-34b's image prefill (text tokens after the
#: config's 2,880 image embeddings), zamba2-2.7b's and whisper-tiny's
#: prompts; each then decodes ``steps`` greedy tokens
FAMILY_RUNS = {
    "llava-next-34b": dict(text=256, steps=32),
    "zamba2-2.7b": dict(s=1024, steps=64),
    "whisper-tiny": dict(s=32, steps=64),
}
#: phase 4's reduced families (f32, card against CPU): arch -> the
#: overrides that keep its q-per-kv ratio (zamba2: two super blocks)
REDUCED_FAMILIES = {
    "llava-next-34b": dict(n_heads=7, n_kv_heads=1),
    "zamba2-2.7b": dict(n_heads=4, n_kv_heads=4, n_layers=4),
    "whisper-tiny": dict(n_heads=4, n_kv_heads=4),
}
#: logits of phase 4's reduced families, card against CPU, at float32
FAMILY_LOGIT_TOL = 1e-4
#: phase 10's predictor setting: Table 1's MLP row (tests/test_predictor.py)
PREDICTOR_CLASSES = ("EV", "SC")
PREDICTOR_FEATURES = 64
PREDICTOR_ERR_BOUND = 120.0
#: phase 10's reduced train step, card against CPU, at float32
TRAIN_TOL = 1e-4
#: phase 10's full-width training run, through the launcher's flags
TRAIN_FULL_ARGS = ["--no-reduced", "--batch", "8", "--seq", "512",
                   "--steps", "10"]
#: phase 11 (a): the sharded serving run
SHARDED_SERVE = dict(b=8, s=448, cache_len=512, steps=32)
#: the logits of the sharded plans against the unsharded model's, bf16: on
#: a 1x1 mesh every local op is the unsharded one, so they should agree to
#: the last bit; the bound is one bf16 ulp at the logits' magnitude
SHARDED_LOGIT_TOL = 3e-2
#: phase 11 (b): the sharded launcher run (the unsharded run it is held to
#: drops the mesh flags)
SHARDED_TRAIN_ARGS = ["--no-reduced", "--batch", "8", "--seq", "512",
                      "--steps", "3"]
SHARDED_MESH_ARGS = ["--mesh", "debug", "--mesh-shape", "1,1"]
#: relative bound on each step's loss and grad norm, sharded against
#: unsharded: the sharded loss sums its rows per batch shard first, a
#: float32 reduction order apart
SHARDED_TRAIN_TOL = 1e-4
#: phase 11 (c): the dry-run's rows run on the card's host
DRYRUN_ROWS = ("train_4k", "decode_32k")
DRYRUN_TIMEOUT_S = 600
#: phase 12: the frozen engine's pools per arch (after the first, each
#: must swap: 1024 does, 5 times, for ``serving_agents``)
FROZEN_RUNS = {"granite-3-2b": (4096, 1024), "xlstm-350m": (4096,)}
FROZEN_COUNTERS = ("tokens", "prefills", "swaps", "decode_steps")
#: phase 13: the JAX examples' record, made on the CPU by
#: scripts/record_jax_examples.py (tests/test_torch_examples_record.py
#: regenerates it and requires it unchanged)
EXAMPLES_RECORD = ROOT / "tests" / "torch_examples_jax_runs.json"
#: serve_agents' flag sets of the record: name -> argv.  ``chaos`` takes
#: seed 3: its crash (replica 1 at t=11.1 s) lands while that replica
#: serves agent 2, long before the drain (the fleet declares no failure
#: at the example's defaults, at any seed: scripts/record_jax_examples.py)
EXAMPLE_SETS = {
    "default": [],
    "fused": ["--fused-prefill", "--closed-loop", "--prefix-cache",
              "--stream"],
    "chaos": ["--replicas", "2", "--chaos", "3"],
    "fleet": ["--replicas", "2", "--fleet-workers", "2",
              "--steal-threshold", "1.5"],
    "tooluse": ["--closed-loop", "--closed-loop-classes",
                "chat,react,tooluse", "--suspend-retention", "spill",
                "--admission-watermark", "0.2", "0.5"],
    "sim": ["--backend", "sim", "--stream"],
}
#: the flag sets whose record also holds every agent's events (phase 13
#: serves them in-process at full width)
EXAMPLE_EVENT_SETS = ("default", "chaos", "fleet")
#: the ``backend metrics:`` keys held to the record (an engine's own, and
#: each replica's ``child_`` ones): phase 7's counters and the engine's
#: scheduling counters, which equal the JAX engine's too
EXAMPLE_COUNTERS = API_COUNTERS + ("sorts", "key_evals", "host_syncs",
                                   "windows", "admission_deferrals")
#: the fleet's keys held to the record
FLEET_KEYS = ("replicas", "live_replicas", "replica_failures",
              "agents_requeued", "agents_stolen", "steals")
#: ``service_for_backend``'s engine arguments, which phase 13 gives the
#: full-width model
EXAMPLE_SERVE = dict(pool_tokens=4096, max_batch=4, cache_len=512,
                     token_scale=8, time_scale=1.0, seed=0)
#: the model serve_agents serves by default, at full width in phase 13
EXAMPLE_ARCH = "h2o-danube-1.8b"
EXAMPLE_TIMEOUT_S = 300


def log(msg: str) -> None:
    print(msg, flush=True)


class PhaseClock:
    """Logs each phase's header and, when the next starts, its wall
    time."""

    def __init__(self):
        self.t0 = self.at = time.perf_counter()
        self.name = None

    def start(self, name) -> None:
        now = time.perf_counter()
        if self.name is not None:
            log(f"  phase {self.name.split('.')[0]}: {now - self.at:.1f} s "
                f"(script at {now - self.t0:.1f} s)")
        self.name, self.at = name, now
        if name is not None:
            log(f"== {name}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_ms(fns: dict, inputs, iters: int = 30, warmup: int = 3) -> dict:
    """Median device time of each ``fn(*inputs[i % len(inputs)])``, the
    functions timed in turns (one call of each per round) by CUDA events.
    Each timed call waits on the stream behind ``torch.cuda._sleep``, so
    the host has enqueued it before the start event runs and the events
    bracket device work only, not the host's launch overhead.  Rotating
    over several input sets larger together than the 50 MB L2 cache keeps
    each call cold, as each layer's call is on the main path."""
    import torch

    for fn in fns.values():
        for i in range(warmup):
            fn(*inputs[i % len(inputs)])
    times = {name: [] for name in fns}
    for i in range(iters):
        args = inputs[i % len(inputs)]
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SLEEP_CYCLES)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return {name: statistics.median(t) for name, t in times.items()}


def bound_ms(n_bytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _sdpa(q, k, v, **kw):
    """One ``scaled_dot_product_attention`` call with grouped kv heads
    (a PyTorch without ``enable_gqa`` gets the kv heads repeated first)."""
    import torch
    import torch.nn.functional as F

    try:
        return F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)
    except TypeError:
        rep = q.shape[1] // k.shape[1]
        return F.scaled_dot_product_attention(
            q, torch.repeat_interleave(k, rep, dim=1),
            torch.repeat_interleave(v, rep, dim=1), **kw)


# ------------------------------------------------------------------ phase 3


def check_paged(ops, ref, torch, gen, split_plan, decode_page) -> dict:
    """Paged decode against its plain version; returns the max |d| in
    bfloat16 at each named shape (granite-3-2b's and ``ZOO_SHAPES``').  The
    case with a length of 0 is held against the plain version of the split
    walk, which floors l as the kernel and the Pallas kernel do (the plain
    attention gives NaN there).  The slot caches of 100 and 97 rows are
    viewed as ``Model.decode`` views them, in pages of ``decode_page(T)``
    tokens; the zoo's slot caches hold 512 tokens in 16-token pages."""
    cases = [  # generator, name, b, nh, n_kv, hd, page size, n_pages,
        #        max_pages, lengths
        (gen, "", 2, 4, 4, 64, 16, 16, 4, [1, 64]),          # MHA
        (gen, "", 4, 8, 2, 32, 16, 40, 6, [1, 16, 17, 96]),  # length edges
        (gen, "", 2, 8, 1, 128, 16, 16, 8, [16, 128]),       # MQA
        (gen, "granite-3-2b", 8, 32, 8, 64, 16, 256, 32, None),  # slot pages
        (gen, "", 3, 8, 2, 64, 16, 64, 20, "edges"),     # split edges, 0
    ]
    # the other cases draw from generators of their own, so that every
    # input above is what earlier trees' runs drew (comparable)
    own = torch.Generator(device="cuda").manual_seed(100)
    for t in (100, 97):   # granite's slots at cache lengths 16 does not divide
        bs = decode_page(t)
        cases.append((own, "", 8, 32, 8, 64, bs, 8 * t // bs, t // bs, None))
    zoo = torch.Generator(device="cuda").manual_seed(200)
    for arch, (nh, n_kv, hd, _) in ZOO_SHAPES.items():
        cases.append((zoo, arch, 8, nh, n_kv, hd, 16, 8 * 32, 32, None))
    fam = torch.Generator(device="cuda").manual_seed(203)
    for arch, (b, nh, n_kv, hd, _, t) in FAMILY_SHAPES.items():
        cases.append((fam, arch, b, nh, n_kv, hd, 16, b * t // 16, t // 16,
                      None))
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for gen_case, label, b, nh, n_kv, hd, bs, n_pages, mp, lengths in \
                cases:
            q = torch.randn(b, nh, hd, generator=gen_case,
                            device="cuda").to(dtype)
            kp, vp = (torch.randn(n_pages, bs, n_kv, hd, generator=gen_case,
                                  device="cuda").to(dtype) for _ in range(2))
            n_split, per = split_plan(mp, bs)
            if lengths == "edges":   # 0, and on and past a split boundary
                lengths = [0, per * bs, per * bs + 1]
            if lengths is None:   # the engine's slot-contiguous tables
                tables = torch.arange(b * mp, dtype=torch.int32,
                                      device="cuda").reshape(b, mp)
                lens = torch.randint(1, mp * bs + 1, (b,),
                                     generator=gen_case, device="cuda",
                                     dtype=torch.int32)
            else:
                tables = torch.randint(0, n_pages, (b, mp), generator=gen,
                                       device="cuda", dtype=torch.int32)
                lens = torch.tensor(lengths, dtype=torch.int32,
                                    device="cuda")
            got = ops.paged_gqa_decode(q, kp, vp, tables, lens,
                                       block_size=bs)
            qg = (q * hd ** -0.5).reshape(b, n_kv, nh // n_kv, hd)
            if lengths is not None and 0 in lengths:
                want = ref.paged_attention_split_ref(qg, kp, vp, tables,
                                                     lens, n_split)
            else:
                want = ref.paged_attention_ref(qg, kp, vp, tables, lens)
            want = want.reshape(b, nh, hd)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            name = str(dtype).split(".")[-1]
            log(f"  paged {name:8s} {label + ': ' if label else ''}b={b} "
                f"nh={nh} n_kv={n_kv} hd={hd} page={bs} split={n_split}x"
                f"{per} pages lengths={lens.tolist()} max|d|={err:.3g}")
            if not err <= TOL[name]:
                raise AssertionError(f"paged decode differs by {err}")
            if label and dtype == torch.bfloat16:
                errs[label] = err
    return errs


def check_grad_guard(ops, torch) -> None:
    """Each wrapper refuses, on the card, an input that requires grad while
    grad mode is on (no kernel has a backward), and launches under
    ``torch.no_grad()``."""
    def cuda(*shape, grad=False, dtype=torch.float32):
        return torch.zeros(*shape, device="cuda", dtype=dtype,
                           requires_grad=grad)

    pages = torch.arange(4, dtype=torch.int32, device="cuda")[None]
    calls = {
        "paged_gqa_decode": lambda q: ops.paged_gqa_decode(
            q[:, 0], cuda(4, 16, 2, 64), cuda(4, 16, 2, 64), pages,
            torch.tensor([40], dtype=torch.int32, device="cuda")),
        "flash_prefill": lambda q: ops.flash_prefill(
            q, cuda(1, 64, 2, 64), cuda(1, 64, 2, 64), block_q=64,
            block_k=64),
        "mlstm_chunk": lambda q: ops.mlstm_chunk(
            q.transpose(1, 2), q.transpose(1, 2), q.transpose(1, 2),
            cuda(1, 4, 64), cuda(1, 4, 64)),
        "fused_rms_norm": lambda q: ops.fused_rms_norm(
            q[:, :1, 0], cuda(64), 1e-5),
        "fused_add_rms_norm": lambda q: ops.fused_add_rms_norm(
            q[:, :1, 0], q[:, :1, 0], cuda(64), 1e-5),
        "rope_kv_write": lambda q: ops.rope_kv_write(
            q[:, :1], q[:, :1, :2], q[:, :1, :2], cuda(1, 32), cuda(1, 32),
            cuda(1, dtype=torch.int32), cuda(1, 8, 2, 64),
            cuda(1, 8, 2, 64), cuda(1, 8, dtype=torch.int32)),
        "silu_mul": lambda q: ops.silu_mul(q, q),
    }
    for name, call in calls.items():
        q = cuda(1, 64, 4, 64, grad=True)
        try:
            call(q)
        except RuntimeError as exc:
            if "no backward" not in str(exc):
                raise
            log(f"  {name} refuses an input that requires grad: {exc}")
        else:
            raise AssertionError(f"{name} launched on an input that "
                                 "requires grad")
        with torch.no_grad():
            call(q)
    torch.cuda.synchronize()


def check_flash(ops, ref, torch, gen, flash_path) -> dict:
    """Flash prefill against its plain version; returns the max |d| in
    bfloat16 at each named shape (granite-3-2b's largest bucket, and
    ``ZOO_SHAPES``' at B 8 and S 512 and ``H2O_PREFILL``, which draw from a
    generator of their own)."""
    cases = [  # generator, name, b, s, nh, n_kv, hd, window
        (gen, "", 1, 64, 4, 2, 32, 0),
        (gen, "", 8, 128, 8, 2, 64, 0),
        (gen, "", 1, 512, 4, 1, 128, 0),
        (gen, "", 8, 128, 4, 4, 64, 48),
        (gen, "", 1, 512, 32, 8, 64, 128),
        (gen, "granite-3-2b", 8, 512, 32, 8, 64, 0),   # the largest bucket
    ]
    zoo = torch.Generator(device="cuda").manual_seed(201)
    for arch, (nh, n_kv, hd, window) in ZOO_SHAPES.items():
        cases.append((zoo, arch, 8, 512, nh, n_kv, hd, window))
    h = H2O_PREFILL
    nh, n_kv, hd, _ = ZOO_SHAPES["h2o-danube-1.8b"]
    cases.append((zoo, "h2o-danube-1.8b past the window", h["b"], h["s"], nh,
                  n_kv, hd, h["window"]))
    fam = torch.Generator(device="cuda").manual_seed(204)
    for arch, (b, nh, n_kv, hd, s, _) in FAMILY_SHAPES.items():
        cases.append((fam, arch, b, s, nh, n_kv, hd, 0))
    # hd 80 on the tensor cores (a generator of their own, so every earlier
    # input stays the parent's): a single tile; qpk 4 with a window of 100
    # that cuts a tile; qpk 2; B 1 at qpk 1
    hd80 = torch.Generator(device="cuda").manual_seed(206)
    cases += [(hd80, "", 1, 64, 4, 1, 80, 0),
              (hd80, "", 2, 320, 8, 2, 80, 100),
              (hd80, "", 1, 192, 4, 2, 80, 0),
              (hd80, "", 1, 256, 4, 4, 80, 0)]
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for gen_case, label, b, s, nh, n_kv, hd, window in cases:
            q = torch.randn(b, s, nh, hd, generator=gen_case,
                            device="cuda").to(dtype)
            k, v = (torch.randn(b, s, n_kv, hd, generator=gen_case,
                                device="cuda").to(dtype) for _ in range(2))
            got = ops.flash_prefill(q, k, v, window=window, block_q=64,
                                    block_k=64)
            want = ref.flash_attention_ref(
                (q * hd ** -0.5).transpose(1, 2), k.transpose(1, 2),
                v.transpose(1, 2), window=window,
            ).transpose(1, 2)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            del want
            name = str(dtype).split(".")[-1]
            path = flash_path(dtype, hd, s)
            log(f"  flash {name:8s} {label + ': ' if label else ''}b={b} "
                f"S={s} nh={nh} n_kv={n_kv} hd={hd} window={window} "
                f"path={path} max|d|={err:.3g}")
            if not err <= TOL[name]:
                raise AssertionError(f"flash prefill differs by {err}")
            if hd == 80 and path != ("tensor_core" if dtype == torch.bfloat16
                                     else "cuda_core"):
                raise AssertionError(f"flash at hd 80 {name} took {path}")
            if label and dtype == torch.bfloat16:
                errs[label] = err
    q = torch.zeros((1, 100, 2, 64), device="cuda")
    try:
        ops.flash_prefill(q, q, q, block_q=64, block_k=64)
    except ValueError:
        log("  flash S=100 with 64-token blocks: ValueError, as the Pallas "
            "contract asks")
    else:
        raise AssertionError("flash prefill accepted a misaligned S")
    return errs


def time_paged(ops, ref, torch, gen, t_len: int = 512, bs: int = 16,
               shape=None):
    """Granite decode shape: B=8 slots of ``t_len`` tokens (512: 32 pages
    of ``bs`` = 16), bf16, every slot full, one layer's call; 40 distinct
    layer caches rotate to keep L2 cold.  ``shape``: another model's
    (B, nh, n_kv, hd, layers), at 512 tokens."""
    b, nh, n_kv, hd = 8, GRANITE["nh"], GRANITE["n_kv"], GRANITE["hd"]
    n_sets = GRANITE["n_layers"]
    if shape is not None:
        b, nh, n_kv, hd, n_sets = shape
    mp = t_len // bs
    dt = torch.bfloat16
    tables = torch.arange(b * mp, dtype=torch.int32,
                          device="cuda").reshape(b, mp)
    lens = torch.full((b,), mp * bs, dtype=torch.int32, device="cuda")
    sets = []
    for _ in range(n_sets):
        q = torch.randn(b, nh, hd, generator=gen, device="cuda").to(dt)
        kp, vp = (torch.randn(b * mp, bs, n_kv, hd, generator=gen,
                              device="cuda").to(dt) for _ in range(2))
        sets.append((q, kp, vp))
    def kernel(q, kp, vp):
        return ops.paged_gqa_decode(q, kp, vp, tables, lens, block_size=bs)

    def plain(q, kp, vp):
        qg = (q * hd ** -0.5).reshape(b, n_kv, nh // n_kv, hd)
        return ref.paged_attention_ref(qg, kp, vp, tables, lens)

    def library(q, kp, vp):
        k = kp.view(b, mp * bs, n_kv, hd).transpose(1, 2)
        v = vp.view(b, mp * bs, n_kv, hd).transpose(1, 2)
        return _sdpa(q[:, :, None], k, v)

    t = device_ms({"kernel": kernel, "plain": plain, "library": library},
                  sets)
    n_tok = int(lens.sum())
    n_bytes = (2 * n_tok * n_kv * hd * 2 + 2 * b * nh * hd * 2
               + tables.numel() * 4 + lens.numel() * 4)
    flops = 2 * 2 * n_tok * (nh // n_kv) * n_kv * hd
    bound, by = bound_ms(n_bytes, flops, "bfloat16")
    return dict(ms=t["kernel"], plain_ms=t["plain"],
                library_ms=t["library"], bound_ms=bound, bound_by=by,
                shape=f"B={b} nh={nh} n_kv={n_kv} hd={hd} len={t_len} "
                      f"page={bs} bf16")


def time_flash(ops, ref, torch, gen, shape=None, n_sets: int = 8):
    """Granite prefill shape: B=8, S=512 (the largest bucket), bf16, one
    layer's call; ``n_sets`` distinct input sets rotate to keep L2 cold.
    ``shape``: another (B, S, nh, n_kv, hd, window); with a window the
    library call takes it as a boolean mask."""
    b, s, nh, n_kv, hd = 8, 512, GRANITE["nh"], GRANITE["n_kv"], GRANITE["hd"]
    window = 0
    if shape is not None:
        b, s, nh, n_kv, hd, window = shape
    dt = torch.bfloat16
    sets = []
    for _ in range(n_sets):
        q = torch.randn(b, s, nh, hd, generator=gen, device="cuda").to(dt)
        k, v = (torch.randn(b, s, n_kv, hd, generator=gen,
                            device="cuda").to(dt) for _ in range(2))
        sets.append((q, k, v))
    def kernel(q, k, v):
        return ops.flash_prefill(q, k, v, window=window, block_q=64,
                                 block_k=64)

    def plain(q, k, v):
        return ref.flash_attention_ref((q * hd ** -0.5).transpose(1, 2),
                                       k.transpose(1, 2), v.transpose(1, 2),
                                       window=window)

    mask = None
    if window:
        i = torch.arange(s, device="cuda")
        mask = (i[None] <= i[:, None]) & (i[None] > i[:, None] - window)

    def library(q, k, v):
        if mask is None:
            return _sdpa(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), is_causal=True)
        return _sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                     attn_mask=mask)

    t = device_ms({"kernel": kernel, "plain": plain, "library": library},
                  sets, iters=20)
    n_bytes = 2 * (2 * b * s * nh * hd + 2 * b * s * n_kv * hd)
    # the (query, key) pairs the causal mask, and the window, leave
    pairs = sum(min(i + 1, window or s) for i in range(s))
    flops = 2 * 2 * b * nh * hd * pairs
    bound, by = bound_ms(n_bytes, flops, "bfloat16")
    return dict(ms=t["kernel"], plain_ms=t["plain"],
                library_ms=t["library"], bound_ms=bound, bound_by=by,
                shape=f"B={b} S={s} nh={nh} n_kv={n_kv} hd={hd} causal"
                      f"{f' window={window}' if window else ''} bf16")


def time_zoo(ops, ref, torch) -> dict:
    """Kernel, plain version, SDPA and bound at llama2-7b's serving shapes
    (paged decode over B 8 slots of 512 tokens, flash prefill at B 8, S
    512), flash at h2o-danube-1.8b's windowed prefill (``H2O_PREFILL``;
    SDPA with the window as a boolean mask) and paged decode at phase 13's
    h2o-danube-1.8b serving shape (B 4 slots of 512 tokens, qpk 4, hd
    80), bf16."""
    gen = torch.Generator(device="cuda").manual_seed(202)
    nh, n_kv, hd, _ = ZOO_SHAPES["llama2-7b"]
    out = {"paged llama2-7b": time_paged(ops, ref, torch, gen,
                                         shape=(8, nh, n_kv, hd, 32)),
           "flash llama2-7b": time_flash(ops, ref, torch, gen,
                                         shape=(8, 512, nh, n_kv, hd, 0))}
    h = H2O_PREFILL
    nh, n_kv, hd, _ = ZOO_SHAPES["h2o-danube-1.8b"]
    out["flash h2o-danube-1.8b"] = time_flash(
        ops, ref, torch, gen, shape=(h["b"], h["s"], nh, n_kv, hd,
                                     h["window"]), n_sets=2)
    out["paged h2o-danube-1.8b"] = time_paged(
        ops, ref, torch, gen, shape=(EXAMPLE_SERVE["max_batch"], nh, n_kv,
                                     hd, 24))
    return out


def time_families(ops, ref, torch) -> dict:
    """Kernel, plain version, SDPA and bound at the last three families'
    full-width shapes (``FAMILY_SHAPES``): paged decode over B slots full
    to the prefill's S tokens, and flash prefill at B x S, bf16."""
    gen = torch.Generator(device="cuda").manual_seed(205)
    out = {}
    for arch, (b, nh, n_kv, hd, s, _) in FAMILY_SHAPES.items():
        # enough input sets to keep L2 cold: at least 200 MB of K/V
        kv_mb = 2 * b * s * n_kv * hd * 2 / 1e6
        n_sets = max(2, min(16, int(200 / kv_mb) + 1))
        out[f"paged {arch}"] = time_paged(ops, ref, torch, gen, t_len=s,
                                          shape=(b, nh, n_kv, hd, n_sets))
        out[f"flash {arch}"] = time_flash(ops, ref, torch, gen,
                                          shape=(b, s, nh, n_kv, hd, 0),
                                          n_sets=min(n_sets, 8))
    return out


def chunk_inputs(torch, gen, b, s, t, offset, nh, n_kv, hd, lens, dtype):
    """One chunk step's attention inputs as ``Model.prefill_chunked``
    leaves them for the chunk at ``offset``: q (B, S, nh, hd) at positions
    offset + arange(S) in every row, K/V (B, T, n_kv, hd) drawn on every
    row (so that masking shows), and ``kv_pos`` holding j at each row j
    below offset + S and ``lens[b]``, -1 elsewhere.  ``kv_pos`` is the
    second layer of an (L, B, T) stack, as the model's cache hands it on
    (its rows need not start on 16-byte boundaries)."""
    q = torch.randn(b, s, nh, hd, generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn(b, t, n_kv, hd, generator=gen,
                        device="cuda").to(dtype) for _ in range(2))
    j = torch.arange(t, dtype=torch.int32, device="cuda")[None]
    lens = torch.as_tensor(lens, dtype=torch.int32, device="cuda")
    kv_pos = torch.full((2, b, t), -1, dtype=torch.int32, device="cuda")[1]
    kv_pos.copy_(torch.where((j < offset + s) & (j < lens[:, None]), j, -1))
    positions = torch.arange(offset, offset + s, device="cuda")[None].expand(
        b, s)
    return q, k, v, positions, kv_pos


def chunk_mask(torch, positions, kv_pos, window: int):
    """The (B, S, T) mask of the keys each query attends: valid, not after
    it, inside its window."""
    kp, qp = kv_pos[:, None, :], positions[:, :, None]
    mask = (kp >= 0) & (kp <= qp)
    if window:
        mask &= kp > qp - window
    return mask


def check_chunk_attention(ops, torch, attention_any) -> dict:
    """Chunked prefill's attention kernel against ``attention_any`` on the
    same card tensors; returns the max |d| in bfloat16 at each of
    ``CHUNK_SHAPES``.  Gated at bfloat16's ``TOL`` over the queries that
    attend a key; a query that attends none (a padding row of length 1
    past a window) is not part of the contract and must be 0.  The kernel's
    bf16 output is also logged against ``attention_any`` at float32 (the
    same inputs, upcast).  Edge cases first: a padding row of length 1, a
    cache length that 64 does not divide with ``kv_pos`` rows off 16-byte
    boundaries, a window that cuts tiles, hd 32 at qpk 1 and hd 128."""
    gen = torch.Generator(device="cuda").manual_seed(207)
    cases = [  # name, b, s, t, offset, nh, n_kv, hd, window, lens
        ("", 2, 64, 128, 0, 4, 2, 64, 0, [64, 1]),
        ("", 3, 128, 198, 64, 8, 2, 80, 0, [190, 70, 1]),
        ("", 2, 128, 512, 128, 8, 2, 80, 100, [256, 1]),
        ("", 1, 64, 192, 64, 2, 2, 32, 0, [128]),
        ("", 2, 128, 256, 0, 8, 2, 128, 0, [100, 128]),
    ]
    for arch, c in CHUNK_SHAPES.items():
        nh, n_kv, hd = ((GRANITE["nh"], GRANITE["n_kv"], GRANITE["hd"])
                        if arch == "granite-3-2b" else ZOO_SHAPES[arch][:3])
        for off in c["offsets"]:
            # a full row, a padding row of length 1, the rest drawn
            lens = torch.randint(1, off + c["s"] + 1, (c["b"],),
                                 generator=gen, device="cuda").tolist()
            lens[:2] = [off + c["s"], 1]
            cases.append((arch, c["b"], c["s"], c["t"], off, nh, n_kv, hd,
                          c["window"], lens))
    errs = {}
    for label, b, s, t, off, nh, n_kv, hd, window, lens in cases:
        q, k, v, positions, kv_pos = chunk_inputs(
            torch, gen, b, s, t, off, nh, n_kv, hd, lens, torch.bfloat16)
        got = ops.chunk_attention(q, k, v, positions, kv_pos, window=window)
        attends = chunk_mask(torch, positions, kv_pos, window).any(-1)
        outs = {}
        for name, dt in (("bfloat16", torch.bfloat16),
                         ("float32", torch.float32)):
            want = attention_any(q.to(dt), k.to(dt), v.to(dt), window=window,
                                 q_positions=positions, kv_positions=kv_pos,
                                 kv_valid=kv_pos >= 0)
            outs[name] = (got.float() - want.float()).abs()[attends].max()
        torch.cuda.synchronize()
        err, err32 = (outs[n].item() for n in ("bfloat16", "float32"))
        empty = int((~attends).sum())
        zero = empty == 0 or got[~attends].abs().max().item() == 0
        log(f"  chunk bfloat16 {label + ': ' if label else ''}b={b} S={s} "
            f"offset={off} T={t} nh={nh} n_kv={n_kv} hd={hd} "
            f"window={window} max|d|={err:.3g} (against float32 "
            f"{err32:.3g}); {empty} queries with no key, 0: {zero}")
        if not err <= TOL["bfloat16"] or not zero:
            raise AssertionError(f"chunk attention differs by {err} (queries"
                                 f" with no key all 0: {zero})")
        if label:
            errs[label] = max(errs.get(label, 0.0), err)
    return errs


def time_chunk(ops, torch, attention_any, arch: str, offset: int) -> dict:
    """Kernel, plain ``attention_any`` (the chain it replaces), one SDPA
    call with the mask as a boolean tensor (a yardstick the port never
    calls) and the bound at a ``CHUNK_SHAPES`` chunk at ``offset``, every
    row full (lens = offset + S); input sets rotate to keep L2 cold.  The
    bound counts q and out, the K/V and ``kv_pos`` rows up to the chunk's
    end once each, and the products over the attended pairs."""
    c = CHUNK_SHAPES[arch]
    b, s, t, window = c["b"], c["s"], c["t"], c["window"]
    nh, n_kv, hd = ((GRANITE["nh"], GRANITE["n_kv"], GRANITE["hd"])
                    if arch == "granite-3-2b" else ZOO_SHAPES[arch][:3])
    gen = torch.Generator(device="cuda").manual_seed(208)
    rows = min(t, offset + s)
    kv_mb = 2 * b * t * n_kv * hd * 2 / 1e6
    sets = [chunk_inputs(torch, gen, b, s, t, offset, nh, n_kv, hd,
                         [rows] * b, torch.bfloat16)
            for _ in range(max(2, min(8, int(200 / kv_mb) + 1)))]

    def kernel(q, k, v, positions, kv_pos):
        return ops.chunk_attention(q, k, v, positions, kv_pos, window=window)

    def plain(q, k, v, positions, kv_pos):
        return attention_any(q, k, v, window=window, q_positions=positions,
                             kv_positions=kv_pos, kv_valid=kv_pos >= 0)

    mask = chunk_mask(torch, sets[0][3], sets[0][4], window)[:, None]

    def library(q, k, v, positions, kv_pos):
        return _sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                     attn_mask=mask)

    tm = device_ms({"kernel": kernel, "plain": plain, "library": library},
                   sets, iters=20)
    n_bytes = (2 * b * s * nh * hd * 2 + 2 * b * rows * n_kv * hd * 2
               + b * rows * 4)
    pairs = sum(min(offset + i + 1, window or t) for i in range(s))
    flops = 2 * 2 * b * nh * hd * pairs
    bound, by = bound_ms(n_bytes, flops, "bfloat16")
    return dict(ms=tm["kernel"], plain_ms=tm["plain"],
                library_ms=tm["library"], bound_ms=bound, bound_by=by,
                bytes_ms=n_bytes / PEAK_BYTES_PER_S * 1e3,
                ops_ms=flops / PEAK_FLOPS["bfloat16"] * 1e3,
                shape=f"{arch} B={b} S={s} offset={offset} T={t} nh={nh} "
                      f"n_kv={n_kv} hd={hd}"
                      f"{f' window={window}' if window else ''} bf16")


def log_chunk_timing(t: dict) -> None:
    log_timing("chunk_attention", t)
    log(f"    bound by bytes {t['bytes_ms']:.4f} ms, by operations "
        f"{t['ops_ms']:.4f} ms; kernel {t['plain_ms'] / t['ms']:.1f}x "
        "faster than the plain chain")


def chunk_batch(torch, cfg) -> dict:
    """``CHUNK_PREFILL``'s seeded batch: B 32 prompts of up to 1,024
    tokens, a full row, a padding row of length 1 and the rest drawn."""
    c = CHUNK_PREFILL
    gen = torch.Generator(device="cuda").manual_seed(209)
    b, s = c["b"], c["s"]
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                           device="cuda")
    lens = torch.randint(1, s + 1, (b,), generator=gen, device="cuda",
                         dtype=torch.int32)
    lens[:2] = torch.tensor([s, 1], dtype=torch.int32)
    return {"tokens": tokens, "lens": lens}


def chunked_pass(torch, model, params, batch) -> tuple:
    """One ``Model.prefill_chunked`` pass at ``CHUNK_PREFILL``'s cache and
    chunk after a warm-up pass: (device ms by CUDA events, logits,
    cache)."""
    c = CHUNK_PREFILL
    model.prefill_chunked(params, batch, c["cache_len"], c["chunk"])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    logits, cache = model.prefill_chunked(params, batch, c["cache_len"],
                                          c["chunk"])
    end.record()
    end.synchronize()
    return start.elapsed_time(end), logits, cache


def profile_chunked_pass(torch, model, params, batch, top: int = 8):
    """The device operations of one ``CHUNK_PREFILL`` pass, from a
    ``torch.profiler`` trace of the card: logs the total and the ``top``
    kernels by device time (ms, calls)."""
    from torch.profiler import ProfilerActivity, profile

    c = CHUNK_PREFILL
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.prefill_chunked(params, batch, c["cache_len"], c["chunk"])
        torch.cuda.synchronize()
    rows = sorted(_device_rows(prof, 1), reverse=True)
    log(f"  a chunked pass's device time {sum(r[0] for r in rows) / 1e3:.3f}"
        f" ms in {sum(r[1] for r in rows)} kernel calls; the top {top}:")
    for us, calls, name in rows[:top]:
        log(f"    {us / 1e3:9.3f} ms {calls:5d} x {name[:110]}")


def chunked_prefill(torch, pkg, ops) -> int:
    """``CHUNK_PREFILL``: the closed cell's model at full width, bf16,
    through ``Model.prefill_chunked`` as its engine prefills a long pass
    (``chunk_batch``, chunks of 512, a cache of 1,024): ``chunk_attention``
    launched layers x 2 times a pass, ``kv_pos`` equal to the one-shot
    ``Model.prefill``'s (flash), its logits and valid K rows within bf16
    ``TOL`` of that pass's and every row's argmax the same; then
    ``serve_chunked`` on the same model.  Returns that run's
    ``chunk_attention`` launches."""
    c = CHUNK_PREFILL
    cfg = pkg["get_config"](c["arch"])
    model, params, _ = build_full_width(torch, pkg, cfg)
    batch = chunk_batch(torch, cfg)
    ops.reset_launch_counts()
    ms, logits, cache = chunked_pass(torch, model, params, batch)
    launches = ops.chunk_attention.launches
    want = 2 * cfg.n_layers * -(-c["s"] // c["chunk"])   # two passes
    one_logits, one_cache = model.prefill(params, batch, c["cache_len"])
    valid = one_cache["kv_pos"] >= 0
    d_logits = (logits.float() - one_logits.float()).abs().max().item()
    agree = (logits.argmax(-1) == one_logits.argmax(-1)).float().mean()
    agree = agree.item()
    d_k = (cache["k"].float() - one_cache["k"].float()).abs()[valid].max()
    d_k = d_k.item()
    same_pos = bool((cache["kv_pos"] == one_cache["kv_pos"]).all())
    lens = batch["lens"]
    profile_chunked_pass(torch, model, params, batch)
    log(f"  {cfg.name} prefill_chunked B={c['b']} S={c['s']} (lens "
        f"{int(lens.min())}-{int(lens.max())}) cache={c['cache_len']} "
        f"chunk={c['chunk']}: {ms:.3f} ms a pass on the device; "
        f"chunk_attention launched {launches} in two passes (layers x "
        f"chunks {want}); against the one-shot prefill: logits max|d| "
        f"{d_logits:.3g}, argmax agree {agree:.4f}, valid K rows "
        f"max|d| {d_k:.3g}, kv_pos equal {same_pos}")
    if launches != want or not same_pos:
        raise AssertionError(f"chunked prefill launched chunk_attention "
                             f"{launches} times, not {want}, or its kv_pos "
                             "differs from the one-shot prefill's")
    tol = TOL["bfloat16"]
    if d_logits > tol or d_k > tol or agree != 1.0:
        raise AssertionError(f"chunked prefill against the one-shot: logits "
                             f"max|d| {d_logits:.3g}, valid K rows max|d| "
                             f"{d_k:.3g} (tolerance {tol}), argmax agree "
                             f"{agree:.4f} (not 1)")
    del cache, one_cache, logits, one_logits
    served = serve_chunked(torch, pkg, ops, model, params)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return served


def serve_chunked(torch, pkg, ops, model, params) -> int:
    """``CHUNK_PREFILL``'s model through ``ServeEngine`` at the closed
    cell's ``cache_len`` and ``prefill_chunk`` (``CHUNK_SERVE``'s agents,
    prompts of 256-900 tokens): with the counts zeroed just before the run,
    ``chunk_attention`` must launch n_layers x chunks of the batched
    prefill passes longer than the chunk (at least one), flash n_layers x
    the others and paged decode n_layers x decode steps, and every agent
    must get its budget of tokens.  Returns ``chunk_attention``'s
    launches."""
    from repro_torch.engine import engine as engine_mod

    c, cfg = CHUNK_PREFILL, model.cfg
    toks = EventLog()
    eng = pkg["ServeEngine"](
        model, params, pkg["make_scheduler"]("justitia", 16384.0),
        pool_tokens=16384, max_batch=8, cache_len=c["cache_len"],
        prefill_chunk=c["chunk"], listener=toks,
    )
    eng.warmup()
    agents, budgets = seeded_agents(
        pkg["EngineAgent"], pkg["InferenceSpec"], pkg["agent_cost"],
        CHUNK_SERVE["seed"], CHUNK_SERVE["n"], CHUNK_SERVE["prompt"],
        CHUNK_SERVE["decode"], cfg.vocab)
    for a in agents:
        eng.submit_agent(a)
    buckets = []         # one entry per batched prefill pass
    write = engine_mod._prefill_write

    def counted_write(model, cache_len, chunk, params, cache, tokens, *rest):
        buckets.append(tokens.shape[1])
        return write(model, cache_len, chunk, params, cache, tokens, *rest)

    engine_mod._prefill_write = counted_write
    try:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        done = eng.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        engine_mod._prefill_write = write
    got = {"chunk_attention": ops.chunk_attention.launches,
           "flash_attention": ops.flash_prefill.launches,
           "paged_attention": ops.paged_gqa_decode.launches}
    chunked = [s for s in buckets if s > c["chunk"]]
    m, n = eng.metrics, cfg.n_layers
    want = {"chunk_attention": n * sum(-(-s // c["chunk"]) for s in chunked),
            "flash_attention": n * (len(buckets) - len(chunked)),
            "paged_attention": n * m["decode_steps"]}
    log(f"  {cfg.name} through ServeEngine (cache_len {c['cache_len']}, "
        f"prefill_chunk {c['chunk']}): agents={len(agents)} "
        f"completed={len(done)} prefill passes {len(buckets)} (buckets "
        f"{sorted(buckets)}, {len(chunked)} chunked) decode_steps="
        f"{m['decode_steps']} tokens={m['tokens']} in {wall:.3f} s; "
        f"launches {got} (n_layers x chunks, passes and steps {want}: "
        f"{got == want})")
    if not chunked:
        raise AssertionError("no prefill pass of the serving run chunked")
    if got != want:
        raise AssertionError(f"serving run launched {got}, not {want}")
    check_glue_counts(ops, cfg, got["paged_attention"], "chunked serving")
    if set(done) != set(budgets):
        raise AssertionError(f"agents {set(budgets) - set(done)} did not "
                             "complete")
    for aid, budget in budgets.items():
        out = toks.tokens.get(aid, [])
        if len(out) != budget or not all(0 <= t < cfg.vocab for t in out):
            raise AssertionError(f"agent {aid}: {len(out)} tokens, budget "
                                 f"{budget}, or a token id out of range")
    del eng
    return got["chunk_attention"]


def glue_counts(ops) -> dict:
    """The decode glue wrappers' launch counts."""
    return {name: getattr(ops, name).launches for name in GLUE}


def want_glue(cfg, paged: int, plain: bool = True) -> dict:
    """The glue wrappers' launches beside ``paged`` launches of paged
    decode in the same run: every paged call of a RoPE model on plain
    tensors is a fused decode layer and step, which launches each wrapper
    once (the MoE keeps its own MLP: no ``silu_mul``); a sharded plan's
    DTensors (``plain=False``) and a model without RoPE launch none."""
    fused = plain and cfg.use_rope
    return {name: paged if fused and not (name == "silu_mul" and cfg.is_moe)
            else 0 for name in GLUE}


def check_glue_counts(ops, cfg, paged: int, label: str,
                      plain: bool = True) -> dict:
    """Holds the glue wrappers' counts to ``want_glue``; returns them."""
    got, want = glue_counts(ops), want_glue(cfg, paged, plain)
    log(f"  {label}: decode glue launches {got} (one each a fused layer "
        f"and decode step: {got == want})")
    if got != want:
        raise AssertionError(f"{label}: decode glue launched {got}, not "
                             f"{want}")
    return got


def _ulps(torch, a, b) -> tuple:
    """Largest gap in ulps between two tensors of one float dtype (their
    bit patterns as ordered integers) and the share of equal elements."""
    bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[a.dtype]
    low = torch.iinfo(bits).min

    def ordered(t):
        i = t.contiguous().view(bits).to(torch.int64)
        return torch.where(i < 0, low - i, i)

    d = (ordered(a) - ordered(b)).abs()
    return int(d.max()), float((d == 0).float().mean())


def glue_inputs(torch, cfg, b: int, t: int, gen, dtype) -> dict:
    """One decode token's inputs to the glue at ``cfg``'s widths: x and a
    residual, a norm scale of 1 +- 0.1, q/k/v, positions over a T-row
    cache with its first row, its last two and one past it (written at
    row T-1), empty caches, and the MLP's two projections."""
    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    nh, n_kv, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    pos = torch.randint(0, t + 4, (b,), generator=gen, device="cuda",
                        dtype=torch.int32)
    pos[:4] = torch.tensor([0, t - 2, t - 1, t + 3], dtype=torch.int32)
    return dict(
        x=randn(b, 1, d, scale=4.0), r=randn(b, 1, d, scale=2.0),
        w=1 + 0.1 * torch.randn(d, generator=gen, device="cuda"),
        q=randn(b, 1, nh, hd), k=randn(b, 1, n_kv, hd),
        v=randn(b, 1, n_kv, hd), pos=pos,
        k_cache=torch.zeros((b, t, n_kv, hd), dtype=dtype, device="cuda"),
        v_cache=torch.zeros((b, t, n_kv, hd), dtype=dtype, device="cuda"),
        kv_pos=torch.full((b, t), -1, dtype=torch.int32, device="cuda"),
        a=randn(b, 1, cfg.d_ff, scale=3.0), g=randn(b, 1, cfg.d_ff))


def check_glue(torch, ops, pkg) -> tuple:
    """Phase 3's decode glue: at each ``GLUE_ARCHS`` decode shape and
    ``GLUE_BATCHES``, each kernel against the composition it replaces,
    run on the card in bf16 (gated by ``GLUE_ULPS``; writes and the
    residual sum bitwise) and in float32 (logged), then each kernel's
    device time beside its plain chain's and its bound by bytes.  Returns
    the max |d| of each wrapper over the bf16 cases and the timings at
    granite-3-2b's B 64 (the kernels line's)."""
    import torch.nn.functional as F

    from repro_torch.models import transformer as tr
    from repro_torch.models.layers import apply_rope, rms_norm, rope_tables

    err, timing = dict.fromkeys(GLUE, 0.0), {}
    for arch, (t, _) in GLUE_ARCHS.items():
        cfg = pkg["get_config"](arch)
        for b in GLUE_BATCHES:
            for dtype in (torch.bfloat16, torch.float32):
                gen = torch.Generator(device="cuda").manual_seed(b + t)
                i = glue_inputs(torch, cfg, b, t, gen, dtype)
                x, r, w, eps, pos = i["x"], i["r"], i["w"], cfg.norm_eps, \
                    i["pos"]
                tables = rope_tables(pos[:, None], cfg.head_dim,
                                     cfg.rope_theta, "cuda")

                def plain_rope(k_cache, v_cache, kv_pos, i=i, pos=pos):
                    q = apply_rope(i["q"], pos[:, None], cfg.rope_theta)
                    tr.update_cache(k_cache, apply_rope(
                        i["k"], pos[:, None], cfg.rope_theta), pos)
                    tr.update_cache(v_cache, i["v"], pos)
                    tr.update_pos(kv_pos, pos, 1)
                    return q[:, 0]

                def fused_rope(k_cache, v_cache, kv_pos, i=i, pos=pos,
                               tables=tables):
                    return ops.rope_kv_write(i["q"], i["k"], i["v"], *tables,
                                             pos, k_cache, v_cache, kv_pos)

                caches = {path: [i[k].clone() for k in
                                 ("k_cache", "v_cache", "kv_pos")]
                          for path in ("plain", "fused")}
                total, normed = ops.fused_add_rms_norm(x, r, w, eps)
                pairs = {   # name: (wrapper, kernel's output, plain output)
                    "rms_norm": ("fused_rms_norm", ops.fused_rms_norm(
                        x, w, eps), rms_norm(x, w, eps)),
                    "add_rms_norm": ("fused_add_rms_norm", normed,
                                     rms_norm(x + r, w, eps)),
                    "add_sum": ("fused_add_rms_norm", total, x + r),
                    "rope_q": ("rope_kv_write", fused_rope(*caches["fused"]),
                               plain_rope(*caches["plain"])),
                    "k_cache": ("rope_kv_write", caches["fused"][0],
                                caches["plain"][0]),
                    "v_cache": ("rope_kv_write", caches["fused"][1],
                                caches["plain"][1]),
                    "silu_mul": ("silu_mul", ops.silu_mul(i["a"], i["g"]),
                                 F.silu(i["a"]) * i["g"]),
                }
                res = {name: _ulps(torch, k, p)
                       for name, (_, k, p) in pairs.items()}
                kv_pos_equal = torch.equal(caches["fused"][2],
                                           caches["plain"][2])
                log(f"  decode glue, {arch} B {b} {str(dtype)[6:]}: (max "
                    f"ulps, share equal) {res}; kv_pos equal {kv_pos_equal}")
                if dtype != torch.bfloat16:
                    continue
                for name, (wrapper, k, p) in pairs.items():
                    err[wrapper] = max(err[wrapper], float(
                        (k.float() - p.float()).abs().max()))
                bad = [name for name, (u, _) in res.items()
                       if u > GLUE_ULPS.get(name, 0)]
                if bad or not kv_pos_equal:
                    raise AssertionError(
                        f"decode glue at {arch} B {b}: {bad} beyond "
                        f"{GLUE_ULPS}, kv_pos equal {kv_pos_equal}")
                es = 2
                nh, n_kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
                xb = b * cfg.d_model * es
                cases = {
                    "fused_rms_norm": (
                        lambda: ops.fused_rms_norm(x, w, eps),
                        lambda: rms_norm(x, w, eps), 2 * xb + 4 * w.numel()),
                    "fused_add_rms_norm": (
                        lambda: ops.fused_add_rms_norm(x, r, w, eps),
                        lambda: (lambda y: (y, rms_norm(y, w, eps)))(x + r),
                        4 * xb + 4 * w.numel()),
                    "rope_kv_write": (
                        lambda: fused_rope(*caches["fused"]),
                        lambda: plain_rope(*caches["plain"]),
                        (2 * b * nh * hd + 4 * b * n_kv * hd) * es
                        + 4 * b * hd + 8 * b),
                    "silu_mul": (
                        lambda: ops.silu_mul(i["a"], i["g"]),
                        lambda: F.silu(i["a"]) * i["g"],
                        3 * b * cfg.d_ff * es),
                }
                for name, (kernel, plain, n_bytes) in cases.items():
                    ms = device_ms({"kernel": kernel, "plain": plain}, [()])
                    bound, by = bound_ms(n_bytes, 0.0, "bfloat16")
                    tm = dict(ms=ms["kernel"], plain_ms=ms["plain"],
                              library_ms=None, bound_ms=bound, bound_by=by,
                              shape=f"{arch} decode B={b} bf16")
                    log_timing(name, tm)
                    if arch == "granite-3-2b" and b == 64:
                        timing[name] = tm
                del i, caches, pairs
        torch.cuda.empty_cache()
    return err, timing


def device_ops(torch, fn) -> list:
    """Names of the device operations of one call of ``fn``, from a
    ``torch.profiler`` trace of the card."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name() for e in prof.profiler.kineto_results.events()
            if str(e.device_type()).endswith("CUDA")]


def glue_steps(torch, pkg, ops) -> None:
    """Phase 3's full-width decode steps: each ``GLUE_ARCHS`` model at its
    cell's slots and cache (random weights, the norm scales 1 +- 0.1 so
    that the scale's rounding is exercised; every slot's cache random and
    its ``kv_pos`` contiguous up to its position), composed
    (``fused_decode_path`` forced off) and fused: ``GLUE_STEPS`` steps
    with the launch counts zeroed before, one profiled step (device
    operations a step and a layer; the fused at most
    ``GLUE_MAX_OPS_PER_LAYER`` a layer), ten timed (host's enqueue and
    synchronised wall, medians); the fused steps' logits must equal the
    composed steps' bit for bit."""
    from collections import Counter

    from repro_torch.models import transformer as tr

    fused_path = tr.fused_decode_path
    for arch, (t, b) in GLUE_ARCHS.items():
        cfg = pkg["get_config"](arch)
        model = pkg["Model"](cfg, device="cuda")
        params = model.init(seed=11)
        gen = torch.Generator(device="cuda").manual_seed(12)
        for key in ("ln1", "ln2"):
            ln = params["blocks"][key]
            ln.copy_(1 + 0.1 * torch.randn(ln.shape, generator=gen,
                                           device="cuda"))
        out, logits = {}, {}
        for path in ("composed", "fused"):
            tr.fused_decode_path = (fused_path if path == "fused"
                                    else lambda *args: False)
            try:
                gen = torch.Generator(device="cuda").manual_seed(13)
                cache = model.init_cache(params, b, t)
                for key in ("k", "v"):
                    cache[key].copy_(torch.randn(
                        cache[key].shape, generator=gen, device="cuda") / 2)
                pos = torch.randint(1, t - GLUE_STEPS - 1, (b,),
                                    generator=gen, device="cuda",
                                    dtype=torch.int32)
                j = torch.arange(t, device="cuda", dtype=torch.int32)
                cache["kv_pos"].copy_(torch.where(j[None] < pos[:, None],
                                                  j[None], -1))
                toks = torch.randint(0, cfg.vocab, (b, 1), generator=gen,
                                     device="cuda", dtype=torch.int32)
                torch.cuda.synchronize()
                ops.reset_launch_counts()
                logits[path] = []
                for step in range(GLUE_STEPS):
                    lg, cache = model.decode(params, cache, toks, pos + step)
                    logits[path].append(lg)
                torch.cuda.synchronize()
                counts = {"paged_gqa_decode": ops.paged_gqa_decode.launches,
                          **glue_counts(ops)}
                nxt = pos + GLUE_STEPS
                names = device_ops(torch, lambda: model.decode(
                    params, cache, toks, nxt))
                enqueue, wall = [], []
                for _ in range(10):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    model.decode(params, cache, toks, nxt)
                    t1 = time.perf_counter()
                    torch.cuda.synchronize()
                    enqueue.append(1e3 * (t1 - t0))
                    wall.append(1e3 * (time.perf_counter() - t0))
            finally:
                tr.fused_decode_path = fused_path
            kinds = Counter(n.split("<")[0].split("(")[0][:48]
                            for n in names)
            out[path] = dict(counts=counts, ops=len(names),
                             enqueue=statistics.median(enqueue),
                             wall=statistics.median(wall))
            log(f"  {arch} full-width decode step, B {b}, cache {t}, "
                f"{path}: {len(names)} device operations "
                f"({len(names) / cfg.n_layers:.1f} a layer), host enqueue "
                f"{out[path]['enqueue']:.2f} ms, wall "
                f"{out[path]['wall']:.2f} ms; launches over {GLUE_STEPS} "
                f"steps {counts}; most frequent {kinds.most_common(8)}")
            del cache
            torch.cuda.empty_cache()
        n = cfg.n_layers * GLUE_STEPS
        want = {"composed": {"paged_gqa_decode": n, **dict.fromkeys(GLUE, 0)},
                "fused": {"paged_gqa_decode": n, **dict.fromkeys(GLUE, n)}}
        equal = all(torch.equal(f, c) for f, c in zip(logits["fused"],
                                                       logits["composed"]))
        gap = max(float((f.float() - c.float()).abs().max())
                  for f, c in zip(logits["fused"], logits["composed"]))
        log(f"  {arch}: {GLUE_STEPS} steps' logits fused against composed "
            f"bitwise equal {equal} (max |d| {gap:.3g}); device operations "
            f"{out['composed']['ops']} -> {out['fused']['ops']} a step")
        for path, counts in want.items():
            if out[path]["counts"] != counts:
                raise AssertionError(f"{arch} {path}: launches "
                                     f"{out[path]['counts']}, not {counts}")
        if out["fused"]["ops"] > GLUE_MAX_OPS_PER_LAYER * cfg.n_layers:
            raise AssertionError(f"{arch}: {out['fused']['ops']} device "
                                 "operations a fused step")
        if not equal:
            raise AssertionError(f"{arch}: fused logits differ from the "
                                 f"composed step's by up to {gap}")
        del model, params, logits
        gc.collect()
        torch.cuda.empty_cache()


def _mlstm_inputs(torch, gen, b, h, s, hd, dtype, state: bool):
    """q, k, v as transposed views of (B, S, H, hd) tensors and the gates
    as views of (B, S, H) float32 tensors, as the model passes them."""
    q, k, v = ((torch.randn(b, s, h, hd, generator=gen, device="cuda") * 0.5)
               .to(dtype).transpose(1, 2) for _ in range(3))
    i_raw = (torch.randn(b, s, h, generator=gen, device="cuda") * 0.5
             ).transpose(1, 2)
    log_f = torch.nn.functional.logsigmoid(
        torch.randn(b, s, h, generator=gen, device="cuda") * 0.5 + 2.0
    ).transpose(1, 2)
    st = None
    if state:
        st = ((torch.randn(b, h, hd, hd, generator=gen, device="cuda") * 0.1),
              (torch.randn(b, h, hd, generator=gen, device="cuda") * 0.1),
              torch.randn(b, h, generator=gen, device="cuda"))
    return q, k, v, i_raw, log_f, st


def check_mlstm(ops, ref, torch, gen, mlstm):
    """The chunkwise mLSTM against its plain version on its output and its
    final (C, n, m), each case on the instantiation its rule gives
    (``mlstm.mlstm_path``) and, where that is tensor_core, on the cuda_core
    kernel too; h within ``TOL``, the float32 state within ``STATE_TOL``;
    returns the max |d| on h at xlstm-350m's prefill shape in bfloat16 on
    the rule's path."""
    x = XLSTM
    cases = [  # b, h, s, hd, chunk, with a state
        (2, 2, 64, 32, 16, False),     # the shapes of tests/test_kernels.py
        (1, 3, 128, 64, 32, False),
        (1, 1, 96, 128, 32, False),
        (2, 1, 64, 256, 64, False),
        (1, 4, 100, 256, 64, False),   # hd 256, ragged last chunks
        (1, 4, 257, 256, 64, False),
        (1, 4, 257, 256, 64, True),    # from a given state
        (2, 2, 37, 32, 64, True),
        (2, 2, 200, 128, 64, True),
        (1, 2, 1100, 256, 64, True),   # more chunks than the states ring
        (x["b"], x["nh"], x["s"], x["hd"], 64, False),   # xlstm-350m
    ]
    fn = ops.kernel_library()["mlstm_chunk"]
    xlstm_err = None
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for b, h, s, hd, chunk, with_state in cases:
            args = _mlstm_inputs(torch, gen, b, h, s, hd, dtype, with_state)
            want, want_st = ref.mlstm_chunk_ref(*args, chunk=chunk)
            rule = mlstm.mlstm_path(dtype, hd, chunk)
            paths = [rule] + (["cuda_core"] if rule == "tensor_core" else [])
            for path in paths:
                if path == rule:
                    got, got_st = ops.mlstm_chunk(*args, chunk=chunk)
                else:
                    got, got_st = mlstm.mlstm_chunk(fn, *args, chunk=chunk,
                                                    path=path)
                torch.cuda.synchronize()
                errs = [(g.float() - w.float()).abs().max().item()
                        for g, w in zip((got, *got_st), (want, *want_st))]
                log(f"  mlstm {name:8s} b={b} h={h} S={s} hd={hd} "
                    f"chunk={chunk} state={'given' if with_state else 'empty'}"
                    f" path={path}{'' if path == rule else ' (forced)'} "
                    f"max|d| h={errs[0]:.3g} C={errs[1]:.3g} n={errs[2]:.3g} "
                    f"m={errs[3]:.3g}")
                if not (errs[0] <= TOL[name]
                        and max(errs[1:]) <= STATE_TOL[name]):
                    raise AssertionError(
                        f"mlstm_chunk ({path}) differs by {errs} (h, C, n, "
                        f"m)")
                if (b, h, s, hd) == (x["b"], x["nh"], x["s"], x["hd"]) and \
                        dtype == torch.bfloat16 and path == rule:
                    xlstm_err = errs[0]
    return xlstm_err


def time_mlstm(ops, ref, torch, gen, s: int = XLSTM["s"], floor=None):
    """xlstm-350m's prefill shape: one prompt of ``s`` tokens, 4 heads of
    256, bf16 q/k/v, float32 gates, from the empty state as prefill starts;
    one layer's call through the wrapper, with q, k, v and the gates in the
    layout the model passes them (transposed views), so that whatever the
    wrapper launches for them is timed with the kernel; 16 input sets
    rotating to keep L2 cold.  ``floor`` (``build_launch_floor``'s entry
    point) also times a kernel that does nothing, launched with the blocks,
    threads and shared memory of the tensor-core passes: their launch
    floor."""
    x = XLSTM
    b, h, hd = x["b"], x["nh"], x["hd"]
    sets = [_mlstm_inputs(torch, gen, b, h, s, hd, torch.bfloat16,
                          False)[:5] for _ in range(16)]
    fns = {"kernel": lambda *a: ops.mlstm_chunk(*a),
           "plain": lambda *a: ref.mlstm_chunk_ref(*a)}
    if floor is not None:
        import ctypes

        from repro_torch.kernels import mlstm_chunk as mlstm

        passes = ("states", "outputs")
        blocks = mlstm.grids(b, h, s, hd, "tensor_core")
        args = [(ctypes.c_int * 2)(*vals) for vals in (
            [blocks[p] for p in passes], [mlstm.THREADS[p] for p in passes],
            [mlstm.smem_bytes(hd, kernel=p) for p in passes])]

        def empty_grids(*_):
            err = floor(2, *args, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch floor: CUDA error {err}")

        fns["floor"] = empty_grids
    t = device_ms(fns, sets, iters=20)
    chunk = 64
    lens = [min(chunk, s - t0) for t0 in range(0, s, chunk)]
    # inputs read once (q, k, v bf16; gates f32), h written in bf16 and the
    # final state in f32
    n_bytes = (3 * 2 + 2) * b * h * s * hd + 2 * 4 * b * h * s + 4 * b * h * (
        hd * hd + hd + 1)
    # per (b, h): causal q.k^T and (q.k^T * w).v within each chunk, q.C0
    # and the C update per token, q.n0 and the n update per token
    flops = b * h * (2 * 2 * hd * sum(n * (n + 1) // 2 for n in lens)
                     + 2 * 2 * s * hd * hd + 2 * 2 * s * hd)
    bound, by = bound_ms(n_bytes, flops, "bfloat16")
    return dict(ms=t["kernel"], plain_ms=t["plain"], library_ms=None,
                bound_ms=bound, bound_by=by, floor_ms=t.get("floor"),
                shape=f"B={b} H={h} S={s} hd={hd} chunk={chunk} bf16 q/k/v, "
                      "f32 gates and state, empty state in")


def log_timing(name: str, t: dict) -> None:
    lib = ("none" if t["library_ms"] is None
           else f"{t['library_ms']:.4f} ms")
    floor = ("" if t.get("floor_ms") is None
             else f", launch floor of its grids {t['floor_ms']:.4f} ms")
    log(f"  {name} at {t['shape']}: kernel {t['ms']:.4f} ms, plain "
        f"{t['plain_ms']:.4f} ms, library call {lib}, bound "
        f"{t['bound_ms']:.4f} ms by {t['bound_by']} "
        f"(kernel at {t['bound_ms'] / t['ms']:.3%} of the bound){floor}")


# ---------------------------------------------------------- phases 4 and 5


def seeded_agents(agent_cls, inference_spec, agent_cost, seed, n, p_range,
                  d_range, vocab):
    import numpy as np

    rng = np.random.default_rng(seed)
    agents, budgets = [], {}
    for i in range(n):
        stages, specs = [], []
        for _ in range(1 + int(rng.integers(0, 2))):
            stage = []
            for _ in range(1 + int(rng.integers(0, 2))):
                p = int(rng.integers(*p_range))
                d = int(rng.integers(*d_range))
                stage.append((rng.integers(0, vocab, size=p), d))
                specs.append(inference_spec(p, d))
            stages.append(stage)
        budgets[i] = sum(s.decode for s in specs)
        agents.append(agent_cls(i, int(rng.integers(0, 2 * n)), stages,
                                agent_cost(specs)))
    return agents, budgets


def shared_prefix_agents(agent_cls, inference_spec, agent_cost, seed, n,
                         vocab, closed_loop=False):
    """Seeded agents whose prompts share block-aligned heads, so that a
    prefix cache hits: each prompt is one of two 32-token family heads plus
    4-15 tokens of its own, every third agent opens with one 48-token
    prompt that the others repeat whole (a full hit), and a second stage
    extends the agent's first prompt by 4-8 tokens (a multi-turn session);
    12-31 new tokens each.  Prompt plus budget stay below 96 tokens."""
    import numpy as np

    rng = np.random.default_rng(seed)
    heads = [rng.integers(0, vocab, size=32) for _ in range(2)]
    repeat = np.concatenate([heads[0], rng.integers(0, vocab, size=16)])
    agents = []
    for i in range(n):
        stages, specs, first = [], [], None
        for _ in range(1 + int(rng.integers(0, 2))):
            stage = []
            for j in range(1 + int(rng.integers(0, 2))):
                if first is None and i % 3 == 2:
                    prompt = repeat
                elif first is None or j:
                    prompt = np.concatenate([
                        heads[i % 2],
                        rng.integers(0, vocab, size=int(rng.integers(4, 16))),
                    ])
                else:
                    prompt = np.concatenate([
                        first,
                        rng.integers(0, vocab, size=int(rng.integers(4, 9))),
                    ])
                first = prompt if first is None else first
                d = int(rng.integers(12, 32))
                stage.append((prompt, d))
                specs.append(inference_spec(len(prompt), d))
            stages.append(stage)
        agents.append(agent_cls(i, int(rng.integers(0, 3 * n)), stages,
                                agent_cost(specs), closed_loop=closed_loop))
    return agents


def serving_agents(pkg, vocab: int):
    """The 8 seeded agents the full-width phases serve (prompts of 64-400
    tokens, 16-64 new tokens each)."""
    return seeded_agents(pkg["EngineAgent"], pkg["InferenceSpec"],
                         pkg["agent_cost"], 2026, 8, (64, 401), (16, 65),
                         vocab)


class EventLog:
    """Every engine listener callback as a row ``[name, *args]``, the token
    value of ``on_token`` kept aside (per agent) and left out of the row."""

    def __init__(self):
        self.rows, self.tokens = [], {}

    def __getattr__(self, name):
        if not name.startswith("on_"):
            raise AttributeError(name)

        def note(*args):
            if name == "on_token":
                self.tokens.setdefault(int(args[0]), []).append(int(args[2]))
                args = args[:2] + args[3:]
            self.rows.append([name, *args])

        return note


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


def reduced_engine(torch, pkg, arch: str, flags: bool = False, **over):
    """A reduced config at f32 on the GPU (kernels) and the CPU (plain).
    For the ssm family the sampled tokens must be equal too.  ``flags``
    serves with ``prefix_cache`` and ``fused_prefill`` on (a pool of 192
    tokens, a cache of 96) agents that share prompt heads, in 16-token
    slices under justitia and in 80-token slices under vtc (a slice that
    starts after a prefix hit runs past the cache end, whose rows must be
    dropped): the sampled tokens must be equal, the cache must hit, the
    fused slices must run and the pool must swap."""
    cfg = pkg["get_config"](arch).reduced(**over)
    keys = ("tokens", "prefills", "swaps", "decode_steps")
    cases = [(sched, dict(cache_len=128))
             for sched in ("justitia", "vtc", "vllm-fcfs")]
    pool = 256
    if flags:
        keys += ("prefix_hits", "prefill_tokens_saved", "fused_slices")
        cases = [(sched, dict(prefix_cache=True, fused_prefill=True,
                              cache_len=96, prefill_chunk=chunk))
                 for sched, chunk in (("justitia", 16), ("vtc", 80))]
        pool = 192

    def agents(classes):
        if flags:
            return shared_prefix_agents(*classes, 5, 8, cfg.vocab)
        return seeded_agents(*classes, 5, 8, (16, 64), (24, 60),
                             cfg.vocab)[0]

    for g, match in engines_equal(torch, pkg, cfg, cases, pool, agents,
                                  keys, shown=flags):
        if flags and (g["prefix_hits"] == 0 or g["fused_slices"] == 0):
            raise AssertionError("the prefix cache did not hit or no fused "
                                 "slice ran")
        if g["swaps"] == 0:
            raise AssertionError(f"pool {pool} did not force a swap")
        if (cfg.kind == "ssm" or flags) and match != 1.0:
            raise AssertionError(f"sampled tokens differ: match {match}")


def engines_equal(torch, pkg, cfg, cases, pool: int, make_agents, keys,
                  shown: bool = True) -> list:
    """Serve ``make_agents((agent_cls, spec, cost))`` on ``cfg`` at f32 on
    the GPU (kernels, ``Model(debug_checks=True)``) and on the CPU (plain),
    once per ``(scheduler, engine arguments)`` of ``cases``, from the same
    parameters; the completions, the clock and the counters ``keys`` must
    be equal.  Returns per case the GPU's numbers and the share of sampled
    tokens that are equal."""
    import numpy as np

    cpu_model = pkg["Model"](cfg, device="cpu")
    cpu_params = cpu_model.init(seed=0)
    gpu_model = pkg["Model"](cfg, device="cuda", debug_checks=True)
    gpu_params = to_device(cpu_params, "cuda")
    classes = (pkg["EngineAgent"], pkg["InferenceSpec"], pkg["agent_cost"])
    out = []
    for sched, engine_kw in cases:
        runs = []
        for model, params, dev in ((gpu_model, gpu_params, "cuda"),
                                   (cpu_model, cpu_params, "cpu")):
            toks = EventLog()
            eng = pkg["ServeEngine"](
                model, params, pkg["make_scheduler"](sched, float(pool)),
                pool_tokens=pool, max_batch=4, listener=toks, device=dev,
                **engine_kw,
            )
            for a in make_agents(classes):
                eng.submit_agent(a)
            eng.run_until_idle()
            eng.alloc.check_invariants()
            runs.append(({"completions": dict(eng.completions),
                          "now": eng.now,
                          **{k: eng.metrics[k] for k in keys}}, toks.tokens))
        (g, gt), (c, ct) = runs
        flat_g = np.concatenate([gt[a] for a in sorted(gt)])
        flat_c = np.concatenate([ct[a] for a in sorted(ct)])
        match = float(np.mean(flat_g == flat_c)) if len(flat_g) == len(
            flat_c) else 0.0
        log(f"  {cfg.name} {sched:9s} "
            f"{engine_kw if shown else ''} gpu={g} cpu_equal={g == c} "
            f"token_match={match:.4f}")
        if g != c:
            raise AssertionError(f"GPU and CPU engines differ: {g} vs {c}")
        out.append((g, match))
    return out


def reduced_zoo(torch, pkg) -> None:
    """Phase 4's engines of the decoder-only zoo, at f32, card against
    CPU, every sampled token equal: reduced mixtral-8x7b (4 experts,
    top-2) over its ring (window 64, cache 128) under justitia and vtc,
    then with its full-width window of 4096 over a full 128-token cache
    (paged decode) with fused prefill off and on; reduced h2o-danube-1.8b
    (window 64) at ``cache_len`` 160 for prompts of 70-120 tokens, longer
    than the window and bucket-padded past it, so that ``_fill_kv`` keeps
    the last 64 and decode wraps."""
    keys = ("tokens", "prefills", "swaps", "decode_steps", "fused_slices")
    mixtral = pkg["get_config"]("mixtral-8x7b")

    def short(classes):
        return seeded_agents(*classes, 5, 8, (16, 64), (24, 60),
                             mixtral.reduced().vocab)[0]

    def long(classes):
        return seeded_agents(*classes, 6, 6, (70, 121), (16, 40),
                             mixtral.reduced().vocab)[0]

    runs = [
        (mixtral.reduced(), [(s, dict(cache_len=128))
                             for s in ("justitia", "vtc")], 256, short),
        (mixtral.reduced(sliding_window=mixtral.sliding_window),
         [("justitia", dict(cache_len=128, prefill_chunk=16,
                            fused_prefill=fused)) for fused in (False, True)],
         256, short),
        (pkg["get_config"]("h2o-danube-1.8b").reduced(),
         [(s, dict(cache_len=160)) for s in ("justitia", "vtc")], 512, long),
    ]
    for cfg, cases, pool, agents in runs:
        for (sched, kw), (g, match) in zip(cases, engines_equal(
                torch, pkg, cfg, cases, pool, agents, keys)):
            if match != 1.0:
                raise AssertionError(f"{cfg.name} {sched} {kw}: sampled "
                                     f"tokens differ, match {match}")
            if kw.get("fused_prefill") and not g["fused_slices"]:
                raise AssertionError(f"{cfg.name}: no fused slice ran")


def family_batch(torch, cfg, b: int, s: int, lens, device, seed: int):
    """A seeded batch for ``cfg``'s family: ``b`` rows of ``s`` tokens with
    ``lens``, and llava's image embeddings (the config's ``n_image_tokens``)
    or whisper's frames (``n_audio_frames``) at the text embeddings' scale;
    made on the CPU, then moved to ``device``."""
    gen = torch.Generator().manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                     dtype=torch.int32),
             "lens": torch.tensor(lens, dtype=torch.int32)}
    n = {"vlm": cfg.n_image_tokens, "encdec": cfg.n_audio_frames}.get(
        cfg.kind)
    if n:
        batch["embeds"] = torch.randn((b, n, cfg.d_model), generator=gen) * 0.02
    return {k: v.to(device) for k, v in batch.items()}


def greedy(torch, model, params, batch, cache_len: int, steps: int,
           walls=None):
    """``Model.prefill`` of ``batch``, then ``steps`` greedy
    ``Model.decode`` steps from its argmax (positions after each row's
    prompt, image rows included).  Returns the tokens (B, steps + 1), the
    logits of every call, the cache and the next (tokens, positions).
    ``walls``: a dict that gets the prefill's wall (ended by a
    synchronize) under ``"prefill"``."""
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch, cache_len=cache_len)
    if walls is not None:
        torch.cuda.synchronize()
        walls["prefill"] = time.perf_counter() - t0
    pos = batch["lens"].clone()
    if model.cfg.kind == "vlm" and "embeds" in batch:
        pos += batch["embeds"].shape[1]
    out = [logits]
    nxt = logits[:, 0].argmax(-1).to(torch.int32)[:, None]
    toks = [nxt]
    for _ in range(steps):
        logits, cache = model.decode(params, cache, nxt, pos)
        out.append(logits)
        nxt = logits[:, 0].argmax(-1).to(torch.int32)[:, None]
        toks.append(nxt)
        pos = pos + 1
    return torch.cat(toks, dim=1), out, cache, (nxt, pos)


def reduced_families(torch, pkg) -> None:
    """Phase 4's last three families at float32, reduced
    (``REDUCED_FAMILIES``): ``Model.prefill`` of a ragged batch (llava with
    its image embeddings, whisper with its frames), then 16 greedy decode
    steps, on the card (kernels, ``debug_checks``) and on the CPU (plain
    versions) from the same parameters: every greedy token equal and every
    call's logits within ``FAMILY_LOGIT_TOL``."""
    for arch, over in REDUCED_FAMILIES.items():
        cfg = pkg["get_config"](arch).reduced(**over)
        cpu = pkg["Model"](cfg, device="cpu")
        params = cpu.init(seed=0)
        gpu = pkg["Model"](cfg, device="cuda", debug_checks=True)
        runs = [greedy(torch, model, p, family_batch(
                    torch, cfg, 2, 48, [48, 29], dev, seed=6), 128, 16)
                for model, p, dev in ((gpu, to_device(params, "cuda"), "cuda"),
                                      (cpu, params, "cpu"))]
        (tg, lg, _, _), (tc, lc, _, _) = runs
        err = max(float((g.float().cpu() - c.float()).abs().max())
                  for g, c in zip(lg, lc))
        equal = bool((tg.cpu() == tc).all())
        log(f"  {cfg.name} ({cfg.kind}) prefill + 16 decode steps, card "
            f"against CPU: tokens equal {equal}, logits max |d| {err:.3g}")
        if not equal or not err <= FAMILY_LOGIT_TOL:
            raise AssertionError(f"{cfg.name}: card and CPU differ (tokens "
                                 f"equal {equal}, logits max |d| {err})")


def build_full_width(torch, pkg, cfg, note: str = ""):
    """``cfg``'s model on the card with random weights from seed 0, after
    collecting what earlier phases left; logs its size.  Returns the model,
    its parameters and the bytes still allocated before it was built."""
    # an earlier phase's engine is freed only by the cycle collector (its
    # timed methods refer back to it): collect it, and count what is still
    # allocated (an earlier model kept for phase 7), so that the peak
    # memory of the phase is its own
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = pkg["Model"](cfg, device="cuda")
    params = model.init(seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    moe = (f" {cfg.n_experts} experts top-{cfg.top_k}" if cfg.is_moe
           else "")
    window = (f" window={cfg.sliding_window}" if cfg.sliding_window
              else "")
    log(f"  {cfg.name}: {cfg.n_layers} layers{note} d_model={cfg.d_model} "
        f"heads={cfg.n_heads}/{cfg.n_kv_heads} hd={cfg.head_dim} "
        f"d_ff={cfg.d_ff}{moe}{window} vocab={cfg.vocab} {cfg.dtype}; "
        f"{n_params / 1e9:.3f} B parameters "
        f"({(torch.cuda.memory_allocated() - held) / 2**30:.2f} GiB) from "
        f"seed 0 in {time.perf_counter() - t0:.1f} s")
    return model, params, held


def full_width(torch, pkg, ops, arch: str, profile: bool = True):
    """Serve ``arch`` at full width from random weights; returns the launch
    counts of the family's kernels over the serving run, the model and its
    parameters.  ``profile``: profile a decode step and a prefill after
    the run."""
    cfg = pkg["get_config"](arch)
    ssm = cfg.kind == "ssm"
    model, params, held = build_full_width(torch, pkg, cfg)
    toks = EventLog()
    eng = pkg["ServeEngine"](
        model, params, pkg["make_scheduler"]("justitia", 4096.0),
        pool_tokens=4096, max_batch=8, cache_len=512, listener=toks,
    )
    eng.warmup()
    agents, budgets = serving_agents(pkg, cfg.vocab)
    for a in agents:
        eng.submit_agent(a)
    wall = {"prefill": 0.0, "decode": 0.0}

    def timed(fn, key):
        def run(*args, **kw):
            t = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            wall[key] += time.perf_counter() - t
            return out
        return run

    # both end in a device->host copy of sampled tokens; the sync is a
    # no-op that makes the host clock honest
    eng._prefill_batch = timed(eng._prefill_batch, "prefill")
    eng._decode_once = timed(eng._decode_once, "decode")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run_until_idle()
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {"paged_attention": ops.paged_gqa_decode.launches,
                "flash_attention": ops.flash_prefill.launches,
                "mlstm_chunk": ops.mlstm_chunk.launches}
    m = eng.metrics
    peak = torch.cuda.max_memory_allocated() - held
    log(f"  agents={len(agents)} completed={len(done)} now={eng.now} "
        f"prefills={m['prefills']} swaps={m['swaps']} "
        f"decode_steps={m['decode_steps']} windows={m['windows']} "
        f"tokens={m['tokens']}")
    log(f"  wall: total={total:.3f} s prefill={wall['prefill']:.3f} s "
        f"decode={wall['decode']:.3f} s; "
        f"decode iterations/s={m['decode_steps'] / wall['decode']:.2f} "
        f"tokens/s={m['tokens'] / total:.2f} "
        f"peak memory={peak / 2**30:.3f} GiB")
    if ssm:
        n_pairs = cfg.n_layers // cfg.slstm_every
        want = {"mlstm_chunk": n_pairs * m["prefills"]}
        log(f"  launches: {launches} (mlstm_chunk = {n_pairs} pairs x "
            f"{m['prefills']} prefills: "
            f"{launches['mlstm_chunk'] == want['mlstm_chunk']})")
    else:
        want = {"paged_attention": cfg.n_layers * m["decode_steps"]}
        log(f"  launches: {launches} (paged_gqa_decode = {cfg.n_layers} "
            f"layers x {m['decode_steps']} decode steps: "
            f"{launches['paged_attention'] == want['paged_attention']})")
    if set(done) != set(budgets):
        raise AssertionError(f"agents {set(budgets) - set(done)} did not "
                             "complete")
    for aid, budget in budgets.items():
        got = len(toks.tokens.get(aid, []))
        if got != budget:
            raise AssertionError(f"agent {aid}: {got} tokens, budget "
                                 f"{budget}")
        if not all(0 <= t < cfg.vocab for t in toks.tokens[aid]):
            raise AssertionError(f"agent {aid}: token id out of range")
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"{name} launched {launches[name]} times, "
                                 f"not {n}")
    if not ssm and launches["flash_attention"] <= 0:
        raise AssertionError("flash prefill never launched")
    if not ssm:
        launches.update(check_glue_counts(
            ops, cfg, launches["paged_attention"], cfg.name))
    # one more decode step on the final cache: finite logits of the
    # expected shape
    logits, _ = model.decode(params, eng.cache,
                             eng._d_state[0][:, None].clone(),
                             eng._d_state[1].clone())
    if logits.shape != (8, 1, cfg.vocab) or not bool(
            torch.isfinite(logits.float()).all()):
        raise AssertionError("full-width logits are not finite")
    attention = ("paged_attention", "flash_attention", *GLUE)
    if not profile:
        return {k: launches[k] for k in attention}, model, params
    profile_decode(torch, model, params, eng.cache,
                   eng._d_state[0][:, None].clone(), eng._d_state[1].clone())
    if ssm:
        profile_prefill(torch, model, params)
        return {"mlstm_chunk": launches["mlstm_chunk"]}, model, params
    profile_granite_prefill(torch, model, params, 8, largest_bucket(agents))
    return {k: launches[k] for k in attention}, model, params


def _device_rows(prof, per: int):
    """(device us per ``per``, calls per ``per``, name) of every kernel in
    a ``torch.profiler`` run; operator rows are left out, as they repeat
    their kernels' time."""
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        dev = getattr(ev, "self_device_time_total", None)
        if dev is None:
            dev = getattr(ev, "self_cuda_time_total", 0)
        if dev > 0:
            rows.append((dev / per, ev.count // per, ev.key))
    return rows


def profile_decode(torch, model, params, cache, toks, pos, steps: int = 4):
    """Where a full-width decode step's time goes: host wall per step, the
    kernels launched per step, the device's busy time (sum of kernel times)
    and the kernels that take most of it, from ``torch.profiler``.  Returns
    the busy time per step in us (0 where the profiler saw none)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            model.decode(params, cache, toks, pos)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) / steps * 1e6
    rows = _device_rows(prof, steps)
    busy = sum(r[0] for r in rows)
    log(f"  profile: decode step wall {wall_us:.0f} us (profiler on), "
        f"{sum(r[1] for r in rows)} kernels/step, device busy {busy:.0f} "
        f"us, idle share {1 - busy / wall_us:.3f}" if busy else
        "  profile: the profiler recorded no device time (not measured)")
    for dev, count, key in sorted(rows, reverse=True)[:8]:
        log(f"    {dev:9.1f} us/step {count:5d} calls/step  {key[:70]}")
    return busy


def profile_prefill(torch, model, params, s: int = 256):
    """Where a full-width xLSTM prefill of one ``s``-token prompt goes: the
    host wall of its mLSTM and sLSTM calls (each ended by a synchronize),
    then, from ``torch.profiler``, the device time of the mLSTM kernel
    against all device time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import ssm

    gen = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, model.cfg.vocab, (1, s), generator=gen,
                         device="cuda", dtype=torch.int32)
    orig = {"mlstm": ssm.mlstm_forward_chunked, "slstm": ssm.slstm_forward}
    wall = dict.fromkeys(orig, 0.0)

    def timed(key):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = orig[key](*args, **kw)
            torch.cuda.synchronize()
            wall[key] += time.perf_counter() - t
            return out
        return run

    ssm.mlstm_forward_chunked, ssm.slstm_forward = (timed("mlstm"),
                                                    timed("slstm"))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(params, {"tokens": toks}, cache_len=512)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        ssm.mlstm_forward_chunked = orig["mlstm"]
        ssm.slstm_forward = orig["slstm"]
    log(f"  prefill of {s} tokens: wall {total * 1e3:.1f} ms; mLSTM calls "
        f"{wall['mlstm'] * 1e3:.1f} ms ({wall['mlstm'] / total:.3f}), "
        f"sLSTM loops {wall['slstm'] * 1e3:.1f} ms "
        f"({wall['slstm'] / total:.3f}), the rest "
        f"{(total - wall['mlstm'] - wall['slstm']) * 1e3:.1f} ms")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.prefill(params, {"tokens": toks}, cache_len=512)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = _device_rows(prof, 1)
    busy = sum(r[0] for r in rows)
    mlstm = [r for r in rows if "mlstm_chunk" in r[2]]
    if not busy:
        log("  profile: the profiler recorded no device time (not measured)")
        return
    log(f"  profile: prefill wall {wall_us:.0f} us (profiler on), device "
        f"busy {busy:.0f} us, idle share {1 - busy / wall_us:.3f}; "
        f"mlstm_chunk kernel {sum(r[0] for r in mlstm):.0f} us in "
        f"{sum(r[1] for r in mlstm)} calls, the other kernels "
        f"{busy - sum(r[0] for r in mlstm):.0f} us in "
        f"{sum(r[1] for r in rows) - sum(r[1] for r in mlstm)} calls")
    for dev, count, key in sorted(rows, reverse=True)[:8]:
        log(f"    {dev:9.1f} us {count:6d} calls  {key[:70]}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def sass_counts(lib: Path):
    """Tensor-core instructions in each kernel function of a built library,
    ``{function: {"HGMMA": n, "HMMA": n}}`` from ``cuobjdump -sass``; None
    where the toolkit has no ``cuobjdump``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).is_file():
        return None
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = {"HGMMA": 0, "HMMA": 0}
        elif fn is not None:
            for op in ("HGMMA", "HMMA"):
                if op + "." in line:
                    counts[fn][op] += 1
                    break
    names = list(counts)
    filt = shutil.which("c++filt")
    if filt and names:
        shown = subprocess.run([filt], input="\n".join(names),
                               capture_output=True, text=True,
                               timeout=60).stdout.splitlines()
        if len(shown) == len(names):
            counts = {short: counts[n] for short, n in zip(shown, names)}
    return counts


def build_launch_floor(ops):
    """Start ``nvcc`` on ``scripts/launch_floor.cu`` (a check-only kernel
    that does nothing) into the kernels' build directory; returns a function
    that waits for it and returns its loaded C entry point, so that the
    build runs beside the port's."""
    import ctypes

    ops.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = ops.BUILD_DIR / "launch_floor.so"
    proc = subprocess.Popen(
        [ops._nvcc(), *ops.NVCC_FLAGS, "-o", str(lib),
         str(LAUNCH_FLOOR_SOURCE)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def load():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"launch_floor.cu build failed:\n{out}")
        fn = ctypes.CDLL(str(lib)).launch_floor
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
        return fn

    return load


def largest_bucket(agents) -> int:
    """The largest 64-token prefill bucket the agents' prompts reach."""
    longest = max(len(p) for a in agents for stage in a.stages
                  for p, _ in stage)
    return -(-longest // 64) * 64


def profile_granite_prefill(torch, model, params, b: int, s: int) -> dict:
    """Where one full-width granite prefill pass of ``b`` prompts of ``s``
    tokens goes (the engine's one-shot bucketed prefill): the host wall
    after a synchronize, then, from ``torch.profiler``, the flash kernel's
    device time against all device time of the pass."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = {"tokens": torch.randint(0, model.cfg.vocab, (b, s),
                                     generator=gen, device="cuda")}
    model.prefill(params, batch, cache_len=512)   # warm the allocator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.prefill(params, batch, cache_len=512)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.prefill(params, batch, cache_len=512)
        torch.cuda.synchronize()
    rows = _device_rows(prof, 1)
    busy = sum(r[0] for r in rows)
    flash = [r for r in rows if "flash" in r[2]]
    flash_us = sum(r[0] for r in flash)
    log(f"  prefill pass B={b} S={s}: wall {wall_ms:.2f} ms")
    if not busy:
        log("  profile: the profiler recorded no device time (not measured)")
        return {"wall_ms": wall_ms}
    log(f"  profile: device busy {busy:.0f} us; flash kernel {flash_us:.0f} "
        f"us in {sum(r[1] for r in flash)} calls ({flash_us / busy:.3f} of "
        f"the busy time), the other kernels {busy - flash_us:.0f} us in "
        f"{sum(r[1] for r in rows) - sum(r[1] for r in flash)} calls")
    for dev, count, key in sorted(rows, reverse=True)[:8]:
        log(f"    {dev:9.1f} us {count:6d} calls  {key[:70]}")
    return {"wall_ms": wall_ms, "busy_us": busy, "flash_us": flash_us}


# --------------------------------------------------------------------- main


# ------------------------------------------------------------------ phase 7


def api_specs(api, run: dict) -> list:
    """The run's seeded ``AgentSpec`` list, sampled by ``api``'s workload
    builders (the port's ``repro_torch.api``; the record's script passes the
    JAX package's)."""
    import numpy as np

    rng = np.random.default_rng(run["seed"])
    if run["workload"] == "open":
        return api.specs_from_classes(rng, run["n_agents"], API_WINDOW_S)
    kw = {"classes": run["classes"]} if "classes" in run else {}
    return api.specs_from_closed_loop(rng, run["n_agents"], API_WINDOW_S,
                                      **kw)


def event_row(ev) -> list:
    """One event as the record holds it: its type, then every field but the
    agent id and the token value."""
    return [type(ev).__name__] + [
        getattr(ev, f.name) for f in dataclasses.fields(ev)
        if f.name not in ("agent_id", "token")
    ]


def serve_api(api, model, params, run: dict, **service) -> tuple:
    """Serve ``run`` through ``api.AgentService.engine`` on ``model``.

    Returns the run's record, as JSON gives it back: finish and JCT per
    agent, each engine's counters, and every agent's events with the token
    values left out; and the agents' handles.  ``service`` overrides the
    run's own service arguments."""
    svc = api.AgentService.engine(
        model, params, "justitia", pool_tokens=run["pool_tokens"],
        **API_SERVE, **{**run.get("service", {}), **service})
    try:
        handles = svc.submit_many(api_specs(api, run))
        res = svc.drain()
    finally:
        if hasattr(svc.backend, "close"):
            svc.backend.close()
    m = res.metrics
    engines = [m] if "per_replica" not in m else [
        {k[len("child_"):]: v for k, v in r.items() if k.startswith("child_")}
        for r in m["per_replica"]
    ]
    record = {
        "finish": {str(a): t for a, t in sorted(res.finish.items())},
        "jct": {str(a): t for a, t in sorted(res.jct.items())},
        "counters": [{k: e[k] for k in API_COUNTERS} for e in engines],
    }
    return {**json.loads(json.dumps(record)),
            "events": handle_events(handles)}, handles


def sampled_tokens(handles) -> dict:
    """Each agent's sampled token ids, in the order they streamed."""
    return {h.agent_id: [int(ev.token) for ev in h.events
                         if type(ev).__name__ == "TokenGenerated"]
            for h in handles}


def record_diff(got: dict, want: dict) -> str:
    """Where two run records first differ ("" where they are equal)."""
    for key in ("finish", "jct", "counters"):
        if got[key] != want[key]:
            return f"{key}: {got[key]} != {want[key]}"
    return events_diff(got["events"], want["events"])


def events_diff(got: dict, want: dict) -> str:
    """Where two agents-to-event-rows maps first differ ("" where they
    are equal)."""
    for aid in sorted(set(got) | set(want), key=int):
        g, w = got.get(aid, []), want.get(aid, [])
        for i, (a, b) in enumerate(zip(g, w)):
            if a != b:
                return f"agent {aid} event {i}: {a} != {b}"
        if len(g) != len(w):
            return f"agent {aid}: {len(g)} events != {len(w)}"
    return ""


def ring_agents(agent_cls, inference_spec, agent_cost, vocab: int):
    """``RING_RUN``'s seeded agents.  Lengths, budgets and arrivals come
    from one generator and token values from another, so that the run's
    shape, and so its record, does not depend on the vocabulary."""
    import numpy as np

    run = RING_RUN
    rng = np.random.default_rng(run["seed"])
    values = np.random.default_rng(run["seed"] + 1)
    agents = []
    for i in range(run["n_agents"]):
        stage, specs = [], []
        for _ in range(1 + int(rng.integers(0, 2))):
            p = int(rng.integers(*run["p_range"]))
            d = int(rng.integers(*run["d_range"]))
            stage.append((values.integers(0, vocab, size=p), d))
            specs.append(inference_spec(p, d))
        agents.append(agent_cls(i, int(rng.integers(0, 2 * run["n_agents"])),
                                [stage], agent_cost(specs)))
    return agents


def serve_ring(pkg, model, params, **engine_kw) -> tuple:
    """Serve ``RING_RUN`` on ``pkg``'s ``ServeEngine`` (the port's, or the
    JAX package's for the record).  Returns the run's record as JSON gives
    it back (completions, clock, ``RING_COUNTERS``, every listener event
    without token values), the engine, the event log and the agents."""
    run = RING_RUN
    events = EventLog()
    eng = pkg["ServeEngine"](
        model, params,
        pkg["make_scheduler"]("justitia", float(run["pool_tokens"])),
        pool_tokens=run["pool_tokens"], max_batch=run["max_batch"],
        cache_len=run["cache_len"], listener=events, **engine_kw)
    agents = ring_agents(pkg["EngineAgent"], pkg["InferenceSpec"],
                         pkg["agent_cost"], model.cfg.vocab)
    for a in agents:
        eng.submit_agent(a)
    eng.run_until_idle()
    eng.alloc.check_invariants()
    record = {
        "completions": {str(a): t for a, t in sorted(eng.completions.items())},
        "now": eng.now,
        "counters": {k: eng.metrics[k] for k in RING_COUNTERS},
        "events": events.rows,
    }
    # numpy scalars of the JAX engine as plain numbers
    text = json.dumps(record, default=lambda o: o.item())
    return json.loads(text), eng, events, agents


def launcher_lines(out: str) -> dict:
    """The ``jct:`` and ``completions:`` lines of a launcher's output."""
    return {key: line for line in out.splitlines()
            for key in ("jct", "completions") if line.startswith(key + ":")}


def serve_full_width_api(torch, api, ops, model, params, record: dict,
                         card: str, runs=tuple(API_RUNS)) -> dict:
    """Phase 7a: the record's runs through ``AgentService`` on the
    full-width model; each must equal the JAX engine's record.  Paged
    decode must launch n_layers times a decode step (fused steps
    included) and flash n_layers times a batched prefill pass (each pass
    is one-shot here: every bucket fits ``prefill_chunk``, 512); a run
    with the prefix cache on must hit, one with fused prefill must run
    slices.  ``runs``: the names of the runs to serve.  Returns the
    launches summed over the runs."""
    from repro_torch.engine import engine as engine_mod

    vocab = model.cfg.vocab
    n_layers = model.cfg.n_layers
    total = {"paged_attention": 0, "flash_attention": 0,
             **dict.fromkeys(GLUE, 0)}
    passes = []          # one entry per batched prefill pass, any thread
    write = engine_mod._prefill_write

    def counted_write(*args, **kw):
        passes.append(1)
        return write(*args, **kw)

    engine_mod._prefill_write = counted_write
    try:
        for name in runs:
            run = API_RUNS[name]
            gc.collect()
            torch.cuda.synchronize()
            passes.clear()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            got, handles = serve_api(api, model, params, run)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            paged = ops.paged_gqa_decode.launches
            flash = ops.flash_prefill.launches
            total["paged_attention"] += paged
            total["flash_attention"] += flash
            _check_api_run(name, run, got, handles, record, wall, paged,
                           flash, n_layers * len(passes), n_layers, vocab,
                           card)
            for key, n in check_glue_counts(ops, model.cfg, paged,
                                            name).items():
                total[key] += n
    finally:
        engine_mod._prefill_write = write
    return total


def _check_api_run(name, run, got, handles, record, wall, paged, flash,
                   want_flash, n_layers, vocab, card) -> None:
    """Log one phase-7 run and hold it to the record, its launch counts
    and the features it turns on."""
    steps = sum(c["decode_steps"] for c in got["counters"])
    n_tok = sum(c["tokens"] for c in got["counters"])
    log(f"  {name:12s} engines={len(got['counters'])} "
        f"counters={got['counters']}")
    log(f"  {name:12s} wall {wall:.3f} s, decode iterations/s "
        f"{steps / wall:.2f}, tokens/s {n_tok / wall:.2f} "
        f"(whole run, prefills included; {card}); launches: paged "
        f"{paged} (= {n_layers} x {steps} decode steps: "
        f"{paged == n_layers * steps}), flash {flash} (= {n_layers} x "
        f"{want_flash // n_layers} prefill passes: {flash == want_flash})")
    diff = record_diff(got, record["runs"][name])
    if diff:
        raise AssertionError(f"run {name} differs from the JAX "
                             f"engine's record: {diff}")
    log(f"  {name:12s} finish, JCT, counters and "
        f"{sum(len(e) for e in got['events'].values())} events equal "
        "the JAX engine's record")
    if paged != n_layers * steps:
        raise AssertionError(f"run {name}: paged decode launched {paged}"
                             f" times, not {n_layers * steps}")
    if flash != want_flash:
        raise AssertionError(f"run {name}: flash prefill launched {flash} "
                             f"times, not {want_flash}")
    service = run.get("service", {})
    for flag, counter in (("prefix_cache", "prefix_hits"),
                          ("fused_prefill", "fused_slices")):
        if service.get(flag) and not sum(c[counter] for c in
                                         got["counters"]):
            raise AssertionError(f"run {name}: {flag} on but {counter} 0")
    for aid, toks in sampled_tokens(handles).items():
        if not all(0 <= t < vocab for t in toks):
            raise AssertionError(f"run {name} agent {aid}: token id out of "
                                 "range")


def profile_fused_step(torch, model, params, card: str) -> None:
    """Where a full-width fused step's time goes, at phase 7's serving
    shape (4 slots of 512 rows, ``prefill_chunk`` 512): three slots decode
    at position 256 while the fourth prefills a zero-padded 512-token slice
    of a 400-token prompt.  The host wall of a decode step, a fused step
    and the slice alone (median of 5 after a synchronize), then, from
    ``torch.profiler``, the device time of the fused step and of the
    slice."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.engine.engine import _decode_window, _fused_window

    b, t, total, at = API_SERVE["max_batch"], API_SERVE["cache_len"], 400, 256
    chunk = t
    gen = torch.Generator(device="cuda").manual_seed(4)
    vocab = model.cfg.vocab
    toks = torch.randint(0, vocab, (b, at), generator=gen, device="cuda",
                         dtype=torch.int32)
    _, cache = model.prefill(params, {"tokens": toks}, cache_len=t)
    slot = b - 1
    cache["kv_pos"][:, slot] = -1
    slices = torch.randint(0, vocab, (1, chunk), generator=gen,
                           device="cuda", dtype=torch.int32)
    slices[0, total:] = 0
    state0 = torch.tensor([[1] * b, [at] * (b - 1) + [0],
                           [8] * (b - 1) + [0]], dtype=torch.int32,
                          device="cuda")
    fns = {
        "decode step": lambda: _decode_window(model, 1, params, cache,
                                              state0.clone()),
        "fused step": lambda: _fused_window(model, 1, chunk, params, cache,
                                            state0.clone(), slices, slot, 0,
                                            total),
        "slice alone": lambda: model.prefill_slice(params, cache, slices[0],
                                                   slot, 0, total),
    }
    wall = {}
    for name, fn in fns.items():
        times = []
        for i in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if i:
                times.append((time.perf_counter() - t0) * 1e3)
        wall[name] = statistics.median(times)
    share = wall["slice alone"] / wall["fused step"]
    log(f"  fused step (B {b}, T {t}, slice {chunk} of a {total}-token "
        f"prompt; {card}): wall decode step {wall['decode step']:.2f} ms, "
        f"fused step {wall['fused step']:.2f} ms, slice alone "
        f"{wall['slice alone']:.2f} ms ({share:.3f} of the fused step)")
    busy = {}
    for name in ("fused step", "slice alone"):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fns[name]()
            torch.cuda.synchronize()
        rows = _device_rows(prof, 1)
        busy[name] = sum(r[0] for r in rows)
        log(f"  profile: {name}: device busy {busy[name]:.0f} us in "
            f"{sum(r[1] for r in rows)} kernels")
        for dev, count, key in sorted(rows, reverse=True)[:5]:
            log(f"    {dev:9.1f} us {count:6d} calls  {key[:70]}")
    if busy["fused step"]:
        log(f"  the slice's share of the fused step's device time "
            f"{busy['slice alone'] / busy['fused step']:.3f}")


def src_env() -> dict:
    """The environment of a subprocess that imports the port from this
    checkout."""
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT / "src"), os.environ.get("PYTHONPATH")) if p))


def run_launchers(record: dict) -> None:
    """Phase 7b: ``python -m repro_torch.launch.serve --backend engine`` as
    users start it (no ``--device``: the card), for each arch; its
    ``jct:`` and ``completions:`` lines must equal the JAX launcher's."""
    env = src_env()
    for arch in LAUNCHER_ARCHS:
        cmd = [sys.executable, "-m", "repro_torch.launch.serve",
               "--backend", "engine", "--arch", arch]
        t0 = time.perf_counter()
        out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=LAUNCHER_TIMEOUT_S)
        wall = time.perf_counter() - t0
        if out.returncode:
            raise AssertionError(f"launcher --arch {arch} exited "
                                 f"{out.returncode}:\n{out.stderr[-3000:]}")
        got = launcher_lines(out.stdout)
        log(f"  launcher --arch {arch}: exit 0 in {wall:.1f} s; "
            f"{got.get('completions')}")
        if got != record["launcher"][arch]:
            raise AssertionError(f"launcher --arch {arch}: {got} != the JAX "
                                 f"launcher's {record['launcher'][arch]}")


def bf16_logits_report(torch, pkg) -> None:
    """Phase 7c (logged, not gated): one prefill and one decode step of
    reduced granite-3-2b at bfloat16 on the card and on the CPU, from the
    same parameters and tokens: the max |d| of the logits and the share of
    argmax tokens that agree."""
    cfg = pkg["get_config"]("granite-3-2b").reduced(dtype="bfloat16")
    cpu = pkg["Model"](cfg, device="cpu")
    params = cpu.init(seed=0)
    gpu = pkg["Model"](cfg, device="cuda")
    gparams = to_device(params, "cuda")
    gen = torch.Generator().manual_seed(3)
    b, s = 4, 128
    toks = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                         dtype=torch.int32)
    pc, cache_c = cpu.prefill(params, {"tokens": toks}, cache_len=2 * s)
    pg, cache_g = gpu.prefill(gparams, {"tokens": toks.cuda()},
                              cache_len=2 * s)
    nxt = pc.float().argmax(-1).to(torch.int32).reshape(b, 1)
    pos = torch.full((b,), s, dtype=torch.int32)
    dc, _ = cpu.decode(params, cache_c, nxt, pos)
    dg, _ = gpu.decode(gparams, cache_g, nxt.cuda(), pos.cuda())
    for name, c, g in (("prefill", pc, pg), ("decode", dc, dg)):
        c, g = c.float(), g.float().cpu()
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"bf16 {name} logits on the card are not "
                                 "finite")
        match = float((c.argmax(-1) == g.argmax(-1)).float().mean())
        log(f"  bf16 {name} (B {b}, S {s}): max |d| of the logits "
            f"{float((c - g).abs().max()):.4g} (|logits| up to "
            f"{float(c.abs().max()):.4g}), argmax tokens equal "
            f"{match:.4f}")



# ------------------------------------------------------------------ phase 8


def decode_ready_cache(torch, model, params, b: int = 8, s: int = 448):
    """A cache of ``b`` slots after a prefill of ``s`` random tokens each,
    with the next tokens and positions: the state phase 5 profiles a
    decode step in."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    toks = torch.randint(0, model.cfg.vocab, (b, s), generator=gen,
                         device="cuda", dtype=torch.int32)
    _, cache = model.prefill(params, {"tokens": toks}, cache_len=512)
    return cache, toks[:, -1:].clone(), torch.full(
        (b,), s, dtype=torch.int32, device="cuda")


def profile_moe_share(torch, model, params, busy_step: float,
                      b: int = 8) -> None:
    """The MoE layers' share of a decode step: the device time of one
    ``moe_mlp`` call per layer at the decode step's shape (B ``b``, one
    token each), from ``torch.profiler``, against ``busy_step``, the busy
    time of a profiled decode step."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.layers import moe_mlp

    cfg = model.cfg
    gen = torch.Generator(device="cuda").manual_seed(3)
    h = torch.randn(b, 1, cfg.d_model, generator=gen, device="cuda").to(
        params["embed"].dtype)
    layers = model.layer_params(params)

    def moe_layers():
        for lp in layers:
            moe_mlp(lp["moe"], h, top_k=cfg.top_k,
                    capacity_factor=cfg.capacity_factor)

    moe_layers()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    moe_layers()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        moe_layers()
        torch.cuda.synchronize()
    rows = _device_rows(prof, 1)
    busy = sum(r[0] for r in rows)
    log(f"  MoE layers of a decode step ({cfg.n_layers} moe_mlp calls at "
        f"B {b}): wall {wall_ms:.2f} ms, device busy {busy:.0f} us in "
        f"{sum(r[1] for r in rows)} kernels"
        + (f", {busy / busy_step:.3f} of the decode step's busy time"
           if busy_step else ""))
    for dev, count, key in sorted(rows, reverse=True)[:5]:
        log(f"    {dev:9.1f} us {count:6d} calls  {key[:70]}")


def cut_cfg(pkg, arch: str):
    """``arch``'s full-width config, its depth cut where ``ZOO_CUTS`` says,
    and the note that says so."""
    cfg = pkg["get_config"](arch)
    if arch not in ZOO_CUTS:
        return cfg, ""
    n_layers, why = ZOO_CUTS[arch]
    return (dataclasses.replace(cfg, n_layers=n_layers),
            f" (cut from {cfg.n_layers}: {why})")


def zoo_api(torch, api, ops, pkg, record: dict, card: str, arch: str) -> dict:
    """Phase 8 (a, b): ``arch`` at full width (its depth cut where
    ``ZOO_CUTS`` says), bf16, random weights, in ``ZOO_API_RUNS`` through
    ``AgentService.engine``, each held to the JAX record with paged decode
    at n_layers x decode steps and flash at n_layers x prefill passes; then
    a profiled decode step at B 8 (and the MoE layers' share of it).
    Returns the launches over the runs."""
    cfg, note = cut_cfg(pkg, arch)
    model, params, _ = build_full_width(torch, pkg, cfg, note)
    launches = serve_full_width_api(torch, api, ops, model, params, record,
                                    card, runs=ZOO_API_RUNS)
    cache, toks, pos = decode_ready_cache(torch, model, params)
    busy = profile_decode(torch, model, params, cache, toks, pos)
    if cfg.is_moe:
        profile_moe_share(torch, model, params, busy)
    log(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def zoo_ring(torch, pkg, ops, record: dict, card: str) -> dict:
    """Phase 8 (c): ``RING_RUN``, h2o-danube-1.8b at full width and its own
    window of 4096 in a 6144-token cache (a 4096-row ring), bf16, held to
    the JAX record; every decode step on the ring (paged decode launched
    0 times), flash n_layers x prefill passes, every pass past the window.
    Returns the launches."""
    from repro_torch.engine import engine as engine_mod

    cfg = pkg["get_config"](RING_RUN["arch"])
    model, params, _ = build_full_width(torch, pkg, cfg)
    seqs = []                       # S of each batched prefill pass
    write = engine_mod._prefill_write

    def counted_write(model_, cache_len, chunk, params_, cache, tokens,
                      *args, **kw):
        seqs.append(int(tokens.shape[1]))
        return write(model_, cache_len, chunk, params_, cache, tokens,
                     *args, **kw)

    engine_mod._prefill_write = counted_write
    try:
        gc.collect()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        got, eng, events, agents = serve_ring(pkg, model, params)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        engine_mod._prefill_write = write
    paged = ops.paged_gqa_decode.launches
    flash = ops.flash_prefill.launches
    m = got["counters"]
    log(f"  ring run: cache {tuple(eng.cache['k'].shape)} (rows = window "
        f"{cfg.sliding_window} < cache_len {RING_RUN['cache_len']}); "
        f"counters {m}, clock {got['now']}; prefill passes at S {seqs}")
    log(f"  ring run wall {wall:.3f} s, decode iterations/s "
        f"{m['decode_steps'] / wall:.2f}, tokens/s {m['tokens'] / wall:.2f} "
        f"(whole run, prefills included; {card}); launches: paged {paged} "
        f"(0 on ring steps: {paged == 0}), flash {flash} (= "
        f"{cfg.n_layers} x {len(seqs)} passes: "
        f"{flash == cfg.n_layers * len(seqs)})")
    want = record["ring"]
    for key in ("completions", "now", "counters"):
        if got[key] != want[key]:
            raise AssertionError(f"ring run {key}: {got[key]} != the JAX "
                                 f"record's {want[key]}")
    for i, (a, b) in enumerate(zip(got["events"], want["events"])):
        if a != b:
            raise AssertionError(f"ring run event {i}: {a} != {b}")
    if len(got["events"]) != len(want["events"]):
        raise AssertionError(f"ring run: {len(got['events'])} events != "
                             f"{len(want['events'])}")
    log(f"  ring run: completions, clock, counters and {len(want['events'])}"
        " events equal the JAX engine's record")
    if eng.cache["k"].shape[2] != cfg.sliding_window:
        raise AssertionError("the ring run's cache is not a ring")
    if paged != 0:
        raise AssertionError(f"paged decode launched {paged} times on ring "
                             "decode steps")
    if flash != cfg.n_layers * len(seqs) or min(seqs) <= cfg.sliding_window:
        raise AssertionError(f"flash launched {flash} times for passes at "
                             f"S {seqs}")
    for a in agents:
        budget = sum(d for stage in a.stages for _, d in stage)
        toks = events.tokens.get(a.agent_id, [])
        if len(toks) != budget or not all(0 <= t < cfg.vocab for t in toks):
            raise AssertionError(f"ring run agent {a.agent_id}: "
                                 f"{len(toks)} tokens of {budget}, or out "
                                 "of range")
    return {"paged_attention": paged, "flash_attention": flash,
            **check_glue_counts(ops, cfg, paged, "ring run")}


# ------------------------------------------------------------------ phase 9


def n_attention(cfg) -> int:
    """Attention layers a prefill or decode step runs: the hybrid's shared
    block once per super block, else one per layer."""
    return (cfg.n_layers // cfg.attn_every if cfg.kind == "hybrid"
            else cfg.n_layers)


def run_family(torch, ops, model, params, batch, cache_len: int, steps: int,
               card: str, label: str):
    """Phase 9's main path on one model: ``greedy`` over ``batch``, with
    the launch counts zeroed just before and read just after.  Flash must
    launch once per attention layer and paged decode once per attention
    layer and step; every token in range, the last logits finite.  Logs
    the walls (each ended by a synchronize).  Returns the launches, the
    tokens and the cache with the next (tokens, positions)."""
    cfg = model.cfg
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    walls = {}
    t0 = time.perf_counter()
    toks, logits, cache, nxt = greedy(torch, model, params, batch, cache_len,
                                      steps, walls)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    decode = wall - walls["prefill"]
    launches = {"paged_attention": ops.paged_gqa_decode.launches,
                "flash_attention": ops.flash_prefill.launches}
    n = n_attention(cfg)
    b, s = batch["tokens"].shape
    extra = (f"{batch['embeds'].shape[1]} "
             f"{'frames' if cfg.kind == 'encdec' else 'image embeddings'} + "
             if "embeds" in batch else "")
    log(f"  {label}: B {b} x ({extra}"
        f"{s} tokens), cache {cache_len}: prefill {walls['prefill']:.3f} s, "
        f"{steps} greedy decode steps {decode:.3f} s ({steps / decode:.2f} "
        f"steps/s; {card}); launches {launches} (flash = {n} attention "
        f"layers: {launches['flash_attention'] == n}; paged = {n} x {steps} "
        f"steps: {launches['paged_attention'] == n * steps})")
    if launches != {"paged_attention": n * steps, "flash_attention": n}:
        raise AssertionError(f"{label}: launches {launches}, not flash {n} "
                             f"and paged {n * steps}")
    launches.update(check_glue_counts(ops, cfg, n * steps, label))
    last = logits[-1]
    if last.shape != (b, 1, cfg.vocab) or not bool(
            torch.isfinite(last.float()).all()):
        raise AssertionError(f"{label}: logits not finite or of shape "
                             f"{tuple(last.shape)}")
    if not bool(((toks >= 0) & (toks < cfg.vocab)).all()):
        raise AssertionError(f"{label}: token id out of range")
    return launches, toks, cache, nxt


def free_model(torch) -> None:
    gc.collect()
    torch.cuda.empty_cache()


def family_llava(torch, api, ops, pkg, record: dict, card: str) -> dict:
    """Phase 9 (a): llava-next-34b at full width (its depth cut where
    ``ZOO_CUTS`` says), bf16, random weights: the ``ZOO_API_RUNS`` through
    ``AgentService.engine`` held to the JAX record (token prompts, as the
    engine serves a VLM), then ``Model.prefill`` of B 2 x (2,880 seeded
    image embeddings + 256 text tokens) at ``cache_len`` 4,096 and 32
    greedy decode steps, and a profiled decode step.  Returns the
    launches."""
    cfg, note = cut_cfg(pkg, "llava-next-34b")
    b, _, _, _, s, cache_len = FAMILY_SHAPES["llava-next-34b"]
    run = FAMILY_RUNS["llava-next-34b"]
    model, params, held = build_full_width(torch, pkg, cfg, note)
    launches = serve_full_width_api(torch, api, ops, model, params, record,
                                    card, runs=ZOO_API_RUNS)
    free_model(torch)
    torch.cuda.reset_peak_memory_stats()
    batch = family_batch(torch, cfg, b, run["text"], [run["text"]] * b,
                         "cuda", seed=7)
    assert batch["embeds"].shape[1] + run["text"] == s
    got, _, cache, (nxt, pos) = run_family(
        torch, ops, model, params, batch, cache_len, run["steps"], card,
        "image prefill")
    for name, n in got.items():
        launches[name] += n
    profile_decode(torch, model, params, cache, nxt, pos)
    log(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
        f" ({(torch.cuda.max_memory_allocated() - held) / 2**30:.2f} GiB of "
        "it this phase's)")
    del model, params, cache
    free_model(torch)
    return launches


def profile_hybrid_prefill(torch, model, params, batch, cache_len: int):
    """Where zamba2's prefill goes: the host wall of its Mamba2 calls and of
    its shared attention blocks, each call bracketed by synchronizes, then,
    from ``torch.profiler``, all device time against the flash kernel's."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import ssm, transformer

    orig = {"mamba2": ssm.mamba2_forward_chunked,
            "shared": transformer.dense_block_train}
    wall = dict.fromkeys(orig, 0.0)

    def timed(key):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = orig[key](*args, **kw)
            torch.cuda.synchronize()
            wall[key] += time.perf_counter() - t
            return out
        return run

    ssm.mamba2_forward_chunked = timed("mamba2")
    transformer.dense_block_train = timed("shared")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(params, batch, cache_len=cache_len)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        ssm.mamba2_forward_chunked = orig["mamba2"]
        transformer.dense_block_train = orig["shared"]
    log(f"  prefill wall {total * 1e3:.1f} ms: Mamba2 calls "
        f"{wall['mamba2'] * 1e3:.1f} ms ({wall['mamba2'] / total:.3f}), "
        f"shared attention blocks {wall['shared'] * 1e3:.1f} ms "
        f"({wall['shared'] / total:.3f}), the rest "
        f"{(total - wall['mamba2'] - wall['shared']) * 1e3:.1f} ms")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.prefill(params, batch, cache_len=cache_len)
        torch.cuda.synchronize()
    rows = _device_rows(prof, 1)
    busy = sum(r[0] for r in rows)
    if not busy:
        log("  profile: the profiler recorded no device time (not measured)")
        return
    flash = sum(r[0] for r in rows if "flash" in r[2])
    log(f"  profile: prefill device busy {busy:.0f} us in "
        f"{sum(r[1] for r in rows)} kernels; flash kernel {flash:.0f} us "
        f"({flash / busy:.3f})")
    for dev, count, key in sorted(rows, reverse=True)[:8]:
        log(f"    {dev:9.1f} us {count:6d} calls  {key[:70]}")


def family_zamba2(torch, ops, pkg, card: str) -> dict:
    """Phase 9 (b): zamba2-2.7b at full width (9 super blocks of 6 Mamba2
    layers and the shared attention block), bf16, random weights:
    ``Model.prefill`` of B 4 x 1,024 tokens and 64 greedy decode steps,
    then a profiled prefill (Mamba2 against attention) and decode step.
    Returns the launches."""
    cfg, note = cut_cfg(pkg, "zamba2-2.7b")
    b, _, _, _, s, cache_len = FAMILY_SHAPES["zamba2-2.7b"]
    run = FAMILY_RUNS["zamba2-2.7b"]
    model, params, held = build_full_width(
        torch, pkg, cfg, f" ({cfg.n_layers // cfg.attn_every} x "
        f"{cfg.attn_every} Mamba2, ssm_state {cfg.ssm_state}, one shared "
        f"attention block){note}")
    torch.cuda.reset_peak_memory_stats()
    batch = family_batch(torch, cfg, b, s, [s] * b, "cuda", seed=8)
    launches, _, cache, (nxt, pos) = run_family(
        torch, ops, model, params, batch, cache_len, run["steps"], card,
        "prefill and decode")
    log(f"  peak memory {(torch.cuda.max_memory_allocated() - held) / 2**30:.2f}"
        " GiB")
    profile_hybrid_prefill(torch, model, params, batch, cache_len)
    profile_decode(torch, model, params, cache, nxt, pos)
    del model, params, cache
    free_model(torch)
    return launches


def family_whisper(torch, ops, pkg, card: str) -> dict:
    """Phase 9 (c): whisper-tiny at full width (4 + 4 layers, d_model 384,
    1,500 frames): B 4 x 1,500 seeded frames and a 32-token decoder prompt,
    then 64 greedy steps, at float32 on the card and on the CPU from the
    same parameters (every token equal), then at bf16 on the card, timed.
    Returns the launches of both card runs."""
    cfg, note = cut_cfg(pkg, "whisper-tiny")
    b, _, _, _, _, cache_len = FAMILY_SHAPES["whisper-tiny"]
    run = FAMILY_RUNS["whisper-tiny"]
    f32 = dataclasses.replace(cfg, dtype="float32")
    cpu = pkg["Model"](f32, device="cpu")
    params = cpu.init(seed=0)
    log(f"  {cfg.name}: {cfg.n_enc_layers} encoder + {cfg.n_layers} decoder"
        f" layers{note} d_model={cfg.d_model} heads={cfg.n_heads}/"
        f"{cfg.n_kv_heads} hd={cfg.head_dim} d_ff={cfg.d_ff} "
        f"frames={cfg.n_audio_frames} vocab={cfg.vocab}; "
        f"{sum(t.numel() for t in _leaves(params)) / 1e6:.2f} M parameters")
    batch = family_batch(torch, cfg, b, run["s"], [run["s"]] * b, "cpu",
                         seed=9)
    t0 = time.perf_counter()
    want = greedy(torch, cpu, params, batch, cache_len, run["steps"])[0]
    log(f"  float32 on the CPU: {time.perf_counter() - t0:.2f} s (host)")
    gpu = pkg["Model"](f32, device="cuda", debug_checks=True)
    launches, got, _, _ = run_family(
        torch, ops, gpu, to_device(params, "cuda"), to_device(batch, "cuda"),
        cache_len, run["steps"], card, "float32 on the card")
    equal = bool((got.cpu() == want).all())
    log(f"  float32 tokens, card against CPU: {got.shape[0]} x "
        f"{got.shape[1]} equal {equal}")
    if not equal:
        raise AssertionError("whisper-tiny float32 tokens differ between the "
                             "card and the CPU")
    bf16 = pkg["Model"](cfg, device="cuda")
    bparams = bf16.init(seed=0)
    bbatch = to_device(batch, "cuda")
    greedy(torch, bf16, bparams, bbatch, cache_len, 2)   # warm the allocator
    got, _, _, _ = run_family(torch, ops, bf16, bparams, bbatch, cache_len,
                              run["steps"], card, "bfloat16 on the card")
    for name, n in got.items():
        launches[name] += n
    free_model(torch)
    return launches


# ----------------------------------------------------------------- phase 10


def table1_samples(sample_agent):
    """``tests/test_predictor.py``'s Table-1 MLP-row setting: per class
    (EV, SC) 100 training and 40 held-out agents, from one seed."""
    import numpy as np

    rng = np.random.default_rng(0)
    samples, test = {}, {}
    for cls in PREDICTOR_CLASSES:
        tr = [sample_agent(rng, cls) for _ in range(100)]
        te = [sample_agent(rng, cls) for _ in range(40)]
        samples[cls] = ([a.prompt for a in tr], [a.true_cost for a in tr])
        test[cls] = ([a.prompt for a in te],
                     np.array([a.true_cost for a in te]))
    return samples, test


def median_ms(fn, n: int = 200) -> float:
    """Median host wall of ``fn()`` over n calls (each returns host data,
    so it has waited for the card)."""
    fn()
    times = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def predictor_on_card(torch) -> None:
    """Phase 10 (a): the paper's per-class MLP predictor fitted on the card
    in Table 1's setting, held to its accuracy bound; one Adam step card
    against CPU; the heavy pooled baseline trained on the card."""
    import numpy as np

    from repro_torch.predictor import (
        AgentCostPredictor,
        HeavyPredictor,
        relative_error,
    )
    from repro_torch.predictor import mlp as pmlp
    from repro_torch.workloads import sample_agent

    samples, test = table1_samples(sample_agent)
    card = AgentCostPredictor(max_features=PREDICTOR_FEATURES)
    card.fit(samples)
    cpu = AgentCostPredictor(max_features=PREDICTOR_FEATURES, device="cpu")
    cpu.fit(samples)
    for cls, (prompts, truth) in test.items():
        pred = card.predict_batch(cls, prompts)
        err = relative_error(pred, truth)
        gap = float(np.max(np.abs(pred - cpu.predict_batch(cls, prompts))
                           / cpu.predict_batch(cls, prompts)))
        lat = median_ms(lambda: card.predict(cls, prompts[0]))
        log(f"  MLP {cls}: fit {card.models[cls].train_time_s:.3f} s on the "
            f"card ({cpu.models[cls].train_time_s:.3f} s on the CPU); "
            f"held-out relative error {err:.2f} % (bound "
            f"{PREDICTOR_ERR_BOUND} %); predict(cls, prompt) median "
            f"{lat:.3f} ms; card against CPU predictions max rel "
            f"{gap:.3g} (from the same initial draws; logged, as Adam's "
            "eps magnifies ulps)")
        if not err < PREDICTOR_ERR_BOUND:
            raise AssertionError(f"{cls}: relative error {err} %")

    # one Adam step from the same parameters and data, card against CPU
    gen = torch.Generator().manual_seed(0)
    params = pmlp.init_mlp_params(gen, 65, [65, 32, 16])
    x = torch.randn(80, 65, generator=gen)
    y = torch.randn(80, generator=gen)
    zeros = [{k: torch.zeros_like(t) for k, t in lay.items()}
             for lay in params]
    got = pmlp._adam_step(to_device(params, "cuda"),
                          (to_device(zeros, "cuda"),) * 2,
                          x.cuda(), y.cuda(), 1, 3e-3, 3e-4)
    want = pmlp._adam_step(params, (zeros, zeros), x, y, 1, 3e-3, 3e-4)
    err = max((a.cpu() - b).abs().max().item()
              for ga, gb in zip(got[0] + got[1][0] + got[1][1],
                                want[0] + want[1][0] + want[1][1])
              for a, b in zip(ga.values(), gb.values()))
    log(f"  MLP _adam_step card against CPU: max |d| {err:.3g} (tolerance "
        "1e-5)")
    if not err <= 1e-5:
        raise AssertionError(f"the Adam step differs by {err}")

    prompts = [p for cls in PREDICTOR_CLASSES for p in samples[cls][0]]
    costs = [c for cls in PREDICTOR_CLASSES for c in samples[cls][1]]
    t = time.perf_counter()
    heavy = HeavyPredictor.train(prompts, costs)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    held = [p for cls in PREDICTOR_CLASSES for p in test[cls][0]]
    truth = np.concatenate([test[cls][1] for cls in PREDICTOR_CLASSES])
    pred = heavy.predict_batch(held)
    if not (pred.shape == truth.shape and np.isfinite(pred).all()):
        raise AssertionError("the heavy predictor's costs are not finite")
    lat = median_ms(lambda: heavy.predict(held[0]))
    log(f"  heavy (pooled, {len(prompts)} prompts, 30 epochs): fit "
        f"{fit_s:.2f} s on the card; held-out relative error "
        f"{relative_error(pred, truth):.2f} %; predict(prompt) median "
        f"{lat:.3f} ms")


def train_reduced(torch, pkg, ops) -> None:
    """Phase 10 (b): reduced granite-3-2b at float32 (TF32 off, as phase 1
    sets it): one train step card against CPU, the 80-step learning check,
    and a checkpoint written on the card restored on the CPU."""
    import numpy as np

    from repro_torch.training import (
        AdamWConfig,
        DataConfig,
        data_iterator,
        init_adamw,
        make_train_step,
        restore_checkpoint,
        save_checkpoint,
    )
    from repro_torch.tree import tree_leaves

    cfg = pkg["get_config"]("granite-3-2b").reduced()
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=80)
    batch = next(data_iterator(DataConfig(vocab=cfg.vocab, seq_len=64,
                                          global_batch=8, order=1)))
    out = {}
    for dev in ("cuda", "cpu"):
        model = pkg["Model"](cfg, device=dev)
        params = to_device(pkg["Model"](cfg, device="cpu").init(seed=0), dev)
        opt = init_adamw(params)
        params, opt, met = make_train_step(model, opt_cfg)(
            params, opt, {"tokens": torch.as_tensor(batch["tokens"],
                                                    device=dev)})
        out[dev] = (params, opt, {k: float(v) for k, v in met.items()})
    (pg, og, mg), (pc, oc, mc) = out["cuda"], out["cpu"]
    for k in ("loss", "grad_norm", "lr"):
        if not abs(mg[k] - mc[k]) <= TRAIN_TOL * max(1.0, abs(mc[k])):
            raise AssertionError(f"train step {k}: card {mg[k]} CPU {mc[k]}")
    # a first Adam step moves p by lr * g / (|g| + 1e-8): where the clipped
    # gradient (m / (1 - b1)) is nonzero and below 1e-6, an ulp of g moves
    # the step; those elements (under 1 % of all) are held to 2 lr, the
    # rest to TRAIN_TOL
    worst = tiny_worst = 0.0
    n_tiny = n_all = 0
    for a, b, m in zip(tree_leaves(pg), tree_leaves(pc),
                       tree_leaves(oc.m)):
        g = (m / (1 - opt_cfg.b1)).abs()
        tiny = (g > 0) & (g < 1e-6)
        gap = (a.cpu() - b).abs()
        worst = max(worst, gap[~tiny].max().item())
        if tiny.any():
            tiny_worst = max(tiny_worst, gap[tiny].max().item())
        n_tiny, n_all = n_tiny + int(tiny.sum()), n_all + g.numel()
    log(f"  reduced {cfg.name} f32, one train step card against CPU: loss "
        f"{mg['loss']:.6f} / {mc['loss']:.6f}, grad norm "
        f"{mg['grad_norm']:.6f} / {mc['grad_norm']:.6f}, parameters max "
        f"|d| {worst:.3g} (tolerance {TRAIN_TOL}); {n_tiny} of {n_all} "
        f"elements with 0 < |g| < 1e-6, max |d| {tiny_worst:.3g} (bound "
        f"{2 * mc['lr']:.3g})")
    if not (worst <= TRAIN_TOL and tiny_worst <= 2 * mc["lr"]
            and n_tiny < 1e-2 * n_all):
        raise AssertionError("the train step differs between card and CPU")

    # tests/test_training.py's learning check, on the card
    cfg = pkg["get_config"]("granite-3-2b").reduced(vocab=128, n_layers=2)
    model = pkg["Model"](cfg)
    params = model.init(seed=0)
    it = data_iterator(DataConfig(vocab=128, seq_len=64, global_batch=8,
                                  seed=0, order=1, temperature=0.2))
    step = make_train_step(model, AdamWConfig(lr=3e-3, warmup_steps=5,
                                              total_steps=200,
                                              weight_decay=0.0))
    opt = init_adamw(params)
    losses = []
    t = time.perf_counter()
    for _ in range(80):
        params, opt, met = step(params, opt, {"tokens": torch.as_tensor(
            next(it)["tokens"], device="cuda")})
        losses.append(float(met["loss"]))
    bound = 0.75 * float(np.log(128))
    log(f"  learning: 80 steps in {time.perf_counter() - t:.2f} s; loss "
        f"{losses[0]:.3f} -> min of the last 5 {min(losses[-5:]):.3f} "
        f"(bound 0.75 ln 128 = {bound:.3f})")
    if not (losses[-1] < losses[0] and min(losses[-5:]) < bound):
        raise AssertionError(f"no learning: {losses[-5:]}")

    path = ROOT / "build" / "chip_smoke" / "train.ckpt"
    tree = {"params": params, "opt": opt}
    save_checkpoint(str(path), tree, step=80)
    cpu_tree = {"params": to_device(params, "cpu"),
                "opt": type(opt)(opt.step.cpu(), to_device(opt.m, "cpu"),
                                 to_device(opt.v, "cpu"))}
    restored, n = restore_checkpoint(str(path), cpu_tree)
    same = all(torch.equal(a, b.cpu()) for a, b in zip(
        tree_leaves(restored["params"]) + tree_leaves(restored["opt"].m)
        + tree_leaves(restored["opt"].v) + [restored["opt"].step],
        tree_leaves(params) + tree_leaves(opt.m) + tree_leaves(opt.v)
        + [opt.step]))
    log(f"  checkpoint written on the card ({path.stat().st_size} bytes) "
        f"restored on the CPU: step {n}, every leaf equal: {same}")
    path.unlink()
    if not (same and n == 80):
        raise AssertionError("the checkpoint did not round-trip")


def train_full_width(torch, ops, card: str) -> None:
    """Phase 10 (c): granite-3-2b at full width, bf16, through the training
    launcher's code path (``--no-reduced``); every loss and grad norm
    finite and no kernel launched."""
    import math

    from repro_torch.launch import train as launcher

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t = time.perf_counter()
    history = launcher.run(TRAIN_FULL_ARGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = {"paged_attention": ops.paged_gqa_decode.launches,
              "flash_attention": ops.flash_prefill.launches,
              "mlstm_chunk": ops.mlstm_chunk.launches, **glue_counts(ops)}
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    steps = [h["elapsed_s"] for h in history]
    per_step = [b - a for a, b in zip(steps, steps[1:])]
    log(f"  granite-3-2b full width ({' '.join(TRAIN_FULL_ARGS)}): "
        f"{len(history)} steps in {wall:.1f} s (model init included); "
        f"first step {steps[0]:.2f} s, later steps median "
        f"{statistics.median(per_step):.3f} s; peak memory {peak:.2f} GiB "
        f"({card})")
    log("  loss curve: " + " ".join(f"{h['loss']:.4f}" for h in history))
    log("  grad norms: " + " ".join(f"{h['grad_norm']:.3f}" for h in history))
    log(f"  kernel launches while training: {counts}")
    if not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
               for h in history):
        raise AssertionError("a full-width loss or grad norm is not finite")
    if any(counts.values()):
        raise AssertionError(f"training launched kernels: {counts}")


def nccl_mesh(torch):
    """Phase 11's NCCL group of one rank (an in-memory store, no
    environment needed) and its 1x1 ("data", "model") mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    return init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))


def sharded_serving(torch, ops, pkg, mesh, card: str) -> dict:
    """Phase 11 (a): full-width granite-3-2b through the prefill and decode
    plans on real DTensors, held to the unsharded model; returns the
    launches of the sharded run."""
    from repro_torch.launch.specs import build_dryrun, distribute, lower_plan

    cfg = pkg["get_config"]("granite-3-2b")
    model, params, held = build_full_width(torch, pkg, cfg)
    b, s = SHARDED_SERVE["b"], SHARDED_SERVE["s"]
    cache_len, steps = SHARDED_SERVE["cache_len"], SHARDED_SERVE["steps"]
    batch = family_batch(torch, cfg, b, s, [s] * b, "cuda", seed=11)
    want_toks, want_logits, _, _ = greedy(torch, model, params, batch,
                                          cache_len, steps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    plan = build_dryrun(cfg.name, "prefill_32k", mesh, cfg_override=cfg,
                        batch_override=b, seq_override=s, params=params,
                        batch=batch, kernels=True, cache_len=cache_len)
    logits, cache = lower_plan(plan)
    got = [logits.full_tensor()]
    nxt = got[-1][:, 0].argmax(-1).to(torch.int32)[:, None]
    pos = batch["lens"].clone()
    dplan = build_dryrun(cfg.name, "decode_32k", mesh, cfg_override=cfg,
                         batch_override=b, seq_override=cache_len,
                         params=params, batch={"tokens": nxt, "pos": pos},
                         kernels=True, cache=cache)
    toks = [nxt]
    for i in range(steps):
        args = () if i == 0 else (
            dplan.args[0], cache, distribute(nxt, mesh, dplan.in_specs[2]),
            distribute(pos, mesh, dplan.in_specs[3]))
        logits, cache = lower_plan(dplan, *args)
        got.append(logits.full_tensor())
        nxt = got[-1][:, 0].argmax(-1).to(torch.int32)[:, None]
        toks.append(nxt)
        pos = pos + 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_attention": ops.paged_gqa_decode.launches,
                "flash_attention": ops.flash_prefill.launches}
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    toks = torch.cat(toks, dim=1)
    err = max(float((a.float() - w.float()).abs().max())
              for a, w in zip(got, want_logits))
    same = int((toks == want_toks).sum())
    placements = {k: str(v.placements) for k, v in cache.items()}
    n = cfg.n_layers
    log(f"  granite-3-2b, 1x1 mesh: prefill plan B {b} x {s} tokens at "
        f"cache {cache_len}, then {steps} greedy decode-plan steps in "
        f"{wall:.3f} s ({card}); peak memory {peak:.2f} GiB; cache layout "
        f"{placements}")
    log(f"  against the unsharded Model: {same} of {toks.numel()} greedy "
        f"tokens equal, logits max |d| {err:.3g} (bound "
        f"{SHARDED_LOGIT_TOL}); launches {launches} (flash = {n} layers, "
        f"paged = {n} x {steps} steps)")
    if not torch.equal(toks, want_toks):
        raise AssertionError("sharded greedy tokens differ from the "
                             "unsharded model's")
    if not err <= SHARDED_LOGIT_TOL:
        raise AssertionError(f"sharded logits differ by {err}")
    if launches != {"paged_attention": n * steps, "flash_attention": n}:
        raise AssertionError(f"sharded serving launched {launches}, not "
                             f"flash {n} and paged {n * steps}")
    launches.update(check_glue_counts(ops, cfg, n * steps, "sharded serving",
                                      plain=False))
    del model, params, cache, plan, dplan
    free_model(torch)
    return launches


def sharded_training(torch, ops, card: str) -> None:
    """Phase 11 (b): the training launcher with a 1x1 mesh on phase 11's
    group, each step held to the unsharded launcher's; no kernel launch."""
    import math

    from repro_torch.launch import train as launcher

    free_model(torch)
    want = launcher.run(SHARDED_TRAIN_ARGS)
    free_model(torch)
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t = time.perf_counter()
    got = launcher.run(SHARDED_TRAIN_ARGS + SHARDED_MESH_ARGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = {"paged_attention": ops.paged_gqa_decode.launches,
              "flash_attention": ops.flash_prefill.launches,
              "mlstm_chunk": ops.mlstm_chunk.launches, **glue_counts(ops)}
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    steps = [h["elapsed_s"] for h in got]
    per_step = [b - a for a, b in zip(steps, steps[1:])]
    log(f"  granite-3-2b full width, sharded "
        f"({' '.join(SHARDED_TRAIN_ARGS + SHARDED_MESH_ARGS)}): "
        f"{len(got)} steps in {wall:.1f} s (model init included); first "
        f"step {steps[0]:.2f} s, later steps "
        + " ".join(f"{d:.3f}" for d in per_step)
        + f" s; peak memory {peak:.2f} GiB ({card})")
    for name in ("loss", "grad_norm"):
        log(f"  {name}: sharded "
            + " ".join(f"{h[name]:.6f}" for h in got) + "; unsharded "
            + " ".join(f"{h[name]:.6f}" for h in want))
    log(f"  kernel launches while training: {counts}")
    for g, w in zip(got, want):
        for name in ("loss", "grad_norm"):
            if not (math.isfinite(g[name]) and abs(g[name] - w[name])
                    <= SHARDED_TRAIN_TOL * abs(w[name])):
                raise AssertionError(f"sharded {name} {g[name]} against "
                                     f"unsharded {w[name]}")
    if len(got) != len(want):
        raise AssertionError("the sharded run's step count differs")
    if any(counts.values()):
        raise AssertionError(f"sharded training launched kernels: {counts}")


DRYRUN_SCRIPT = """
import json, sys
from repro_torch.configs import ASSIGNED_ARCHS
from repro_torch.launch.dryrun import production_world, run_pair
recs = []
with production_world(False) as mesh:
    for shape in sys.argv[1:]:
        for arch in ASSIGNED_ARCHS:
            recs.append(run_pair(arch, shape, multi_pod=False, mesh=mesh,
                                 verbose=False))
print("DRYRUN::" + json.dumps(recs))
"""


def start_dryrun_rows() -> tuple:
    """Phase 11 (c)'s subprocess, started before (a) so that its host-only
    work (meta tensors, a fake group apart from this process's state)
    overlaps (a) and (b); returns it and its start time."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen([sys.executable, "-c", DRYRUN_SCRIPT,
                             *DRYRUN_ROWS], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, time.perf_counter()


def dryrun_rows(started: tuple, card: str) -> None:
    """Phase 11 (c): the dry-run's ``DRYRUN_ROWS`` on the 16x16 fake mesh
    (``start_dryrun_rows``'s subprocess); every pair ``ok``."""
    proc, t = started
    try:
        stdout, stderr = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
    finally:
        proc.kill()
    wall = time.perf_counter() - t
    lines = [ln for ln in stdout.splitlines() if ln.startswith("DRYRUN::")]
    if proc.returncode or not lines:
        raise AssertionError(f"the dry-run subprocess failed "
                             f"({proc.returncode}): {stderr[-2000:]}")
    recs = json.loads(lines[0][len("DRYRUN::"):])
    log(f"  {len(recs)} pairs on the 16x16 fake mesh, {wall:.1f} s from "
        f"the start of phase 11 (the card's host, {card}; beside (a) and "
        "(b)); per device:")
    for rec in recs:
        if rec["status"] != "ok":
            raise AssertionError(f"dry-run {rec['arch']} x {rec['shape']}: "
                                 f"{rec['status']} {rec.get('error', '')}")
        log(f"    {rec['arch']:16s} {rec['shape']:11s} {rec['mode']:7s} "
            f"flops {rec['cost']['flops']:.4e} collective bytes "
            f"{rec['collectives']['total_bytes']:.4e} argument bytes "
            f"{rec['memory']['argument_bytes']} ({rec['wall_s']} s)")


# ----------------------------------------------------------------- phase 12


def serve_frozen_pair(torch, pkg, ops, model, params, pool: int) -> dict:
    """Phase 12: ``serving_agents`` through the frozen engine, then through
    ``ServeEngine``, at one pool; per engine its outcome (completions,
    clock, ``FROZEN_COUNTERS``), event rows, tokens per agent, budgets,
    wall seconds and launch counts (zeroed just before the run, read just
    after it)."""
    out = {}
    for name in ("ReferenceServeEngine", "ServeEngine"):
        events = EventLog()
        eng = pkg[name](
            model, params, pkg["make_scheduler"]("justitia", float(pool)),
            pool_tokens=pool, max_batch=8, cache_len=512, listener=events,
        )
        agents, budgets = serving_agents(pkg, model.cfg.vocab)
        for a in agents:
            eng.submit_agent(a)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        done = eng.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out[name] = dict(
            outcome={"completions": dict(done), "now": eng.now,
                     **{k: eng.metrics[k] for k in FROZEN_COUNTERS}},
            rows=events.rows, tokens=events.tokens, budgets=budgets,
            wall=wall,
            launches={"paged_attention": ops.paged_gqa_decode.launches,
                      "flash_attention": ops.flash_prefill.launches,
                      "mlstm_chunk": ops.mlstm_chunk.launches,
                      **glue_counts(ops)})
        del eng
    return out


def frozen_engine(torch, pkg, ops, arch: str, card: str) -> dict:
    """Phase 12: ``arch`` at full width, bf16, random weights, served by
    the frozen engine at each pool of ``FROZEN_RUNS`` and held to
    ``ServeEngine`` on the same agents; returns the launch counts of every
    run."""
    cfg = pkg["get_config"](arch)
    model, params, _ = build_full_width(torch, pkg, cfg)
    total = {"paged_attention": 0, "flash_attention": 0, "mlstm_chunk": 0,
             **dict.fromkeys(GLUE, 0)}
    for i, pool in enumerate(FROZEN_RUNS[arch]):
        runs = serve_frozen_pair(torch, pkg, ops, model, params, pool)
        ref, new = runs["ReferenceServeEngine"], runs["ServeEngine"]
        o = ref["outcome"]
        if cfg.kind == "ssm":
            want = {"paged_attention": 0, "flash_attention": 0,
                    "mlstm_chunk": (cfg.n_layers // cfg.slstm_every)
                    * o["prefills"], **dict.fromkeys(GLUE, 0)}
        else:
            want = {"paged_attention": cfg.n_layers * o["decode_steps"],
                    "flash_attention": cfg.n_layers * o["prefills"],
                    "mlstm_chunk": 0,
                    **want_glue(cfg, cfg.n_layers * o["decode_steps"])}
        pairs = [(a, b) for aid in sorted(ref["tokens"])
                 for a, b in zip(ref["tokens"][aid],
                                 new["tokens"].get(aid, []))]
        match = sum(a == b for a, b in pairs) / max(len(pairs), 1)
        log(f"  pool {pool}: completed={len(o['completions'])} "
            f"now={o['now']} prefills={o['prefills']} swaps={o['swaps']} "
            f"decode_steps={o['decode_steps']} tokens={o['tokens']}")
        log(f"    launches: frozen {ref['launches']} (want {want}), "
            f"ServeEngine {new['launches']}")
        log(f"    wall ({card}): frozen engine {ref['wall']:.3f} s, "
            f"ServeEngine {new['wall']:.3f} s, ratio "
            f"{ref['wall'] / new['wall']:.2f}; decode iterations/s "
            f"{o['decode_steps'] / ref['wall']:.2f} against "
            f"{o['decode_steps'] / new['wall']:.2f}; sampled tokens equal "
            f"in {match:.3f} of {len(pairs)} (logged, not gated)")
        for name, run in runs.items():
            if set(run["outcome"]["completions"]) != set(run["budgets"]):
                raise AssertionError(f"{name}: agents did not complete")
            for aid, budget in run["budgets"].items():
                got = run["tokens"].get(aid, [])
                if len(got) != budget:
                    raise AssertionError(f"{name}: agent {aid} made "
                                         f"{len(got)} tokens, budget {budget}")
                if not all(0 <= t < cfg.vocab for t in got):
                    raise AssertionError(f"{name}: agent {aid}: token id "
                                         "out of range")
        if ref["launches"] != want:
            raise AssertionError(f"frozen engine launched {ref['launches']}"
                                 f", not {want}")
        if i > 0 and o["swaps"] == 0:
            raise AssertionError(f"pool {pool} did not force a swap")
        if new["outcome"] != o:
            raise AssertionError(f"ServeEngine {new['outcome']} != frozen "
                                 f"engine {o}")
        for j, (a, b) in enumerate(zip(new["rows"], ref["rows"])):
            if a != b:
                raise AssertionError(f"event {j}: ServeEngine {a} != frozen"
                                     f" engine {b}")
        if len(new["rows"]) != len(ref["rows"]):
            raise AssertionError(f"{len(new['rows'])} events != "
                                 f"{len(ref['rows'])}")
        for run in runs.values():
            for name, n in run["launches"].items():
                total[name] += n
    del model, params
    free_model(torch)
    return total


# ----------------------------------------------------------------- phase 13


def prompt_digest(prompt: str) -> str:
    """A short digest of a synthetic prompt: how the record names it."""
    import hashlib

    return hashlib.sha256(prompt.encode()).hexdigest()[:16]


class RecordedCosts:
    """A cost predictor that answers from a record: ``costs`` holds
    ``[class, prompt digest, cost]`` per call the JAX example made."""

    def __init__(self, costs):
        self.costs = {(cls, digest): cost for cls, digest, cost in costs}

    def predict(self, cls: str, prompt: str) -> float:
        return self.costs[(cls, prompt_digest(prompt))]


def metrics_subset(metrics: dict) -> dict:
    """The ``backend metrics:`` values held to the record: each of
    ``EXAMPLE_COUNTERS`` and ``FLEET_KEYS`` present, and per replica its
    agents, makespan and ``child_`` counters."""
    keys = EXAMPLE_COUNTERS + FLEET_KEYS
    out = {k: metrics[k] for k in keys if k in metrics}
    if "per_replica" in metrics:
        out["per_replica"] = [
            {k: r[k] for k in ("agents", "makespan") + tuple(
                "child_" + c for c in EXAMPLE_COUNTERS) if k in r}
            for r in metrics["per_replica"]]
    return out


def serve_agents_output(out: str) -> dict:
    """What a serve_agents run printed, as the record holds it: every line
    but the wall seconds' and the metrics' (``lines``), and the metrics
    that are held to the record (``metrics``)."""
    import ast
    import re

    lines, metrics = [], None
    for line in out.splitlines():
        if line.startswith("backend metrics: "):
            # numpy scalars print as np.float64(x): keep x
            text = re.sub(r"np\.\w+\(([^()]*)\)", r"\1",
                          line[len("backend metrics: "):])
            metrics = metrics_subset(ast.literal_eval(text))
        elif not line.startswith("served "):
            lines.append(line)
    return {"lines": lines, "metrics": metrics}


def handle_events(handles) -> dict:
    """Each agent's events without token values, as JSON gives them
    back."""
    rows = {str(h.agent_id): [event_row(ev) for ev in h.events]
            for h in handles}
    return json.loads(json.dumps(rows, default=lambda o: o.item()))


def load_example(name: str):
    """``examples/<name>.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def example_commands(ckpt: str) -> dict:
    """Phase 13 (a)'s runs: name -> argv of ``python examples/...``, with
    no ``--device`` (the card), as users start them."""
    cmds = {f"serve_agents {name}": ["examples/serve_agents_torch.py", *argv]
            for name, argv in EXAMPLE_SETS.items()}
    cmds["quickstart"] = ["examples/quickstart_torch.py"]
    cmds["fairness_demo"] = ["examples/fairness_demo_torch.py"]
    cmds["train_small"] = ["examples/train_small_torch.py", "--ckpt", ckpt]
    return cmds


def start_examples(ckpt: str, extra=()) -> dict:
    """Starts every run of ``example_commands`` at once, each with its
    output in a file of its own; ``extra`` is appended to each command but
    fairness_demo's.  Returns name -> (process, stdout, stderr, start)."""
    import tempfile

    env = src_env()
    started = {}
    for name, argv in example_commands(ckpt).items():
        cmd = [sys.executable, *argv]
        if name != "fairness_demo":
            cmd += list(extra)
        out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        started[name] = (subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=out,
                                          stderr=err),
                         out, err, time.perf_counter())
    return started


def finish_examples(started: dict) -> dict:
    """Waits for every run of ``start_examples``; returns name -> (stdout,
    wall).  A run that fails or outlasts ``EXAMPLE_TIMEOUT_S`` fails the
    phase, and no run outlives it."""
    done = {}
    try:
        for name, (proc, out, err, t0) in started.items():
            left = EXAMPLE_TIMEOUT_S - (time.perf_counter() - t0)
            code = proc.wait(timeout=max(left, 1.0))
            wall = time.perf_counter() - t0
            out.seek(0)
            err.seek(0)
            if code:
                raise AssertionError(f"{name} exited {code}:\n"
                                     f"{err.read()[-3000:]}")
            done[name] = (out.read(), wall)
    finally:
        for proc, out, err, _ in started.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
            err.close()
    return done


def check_examples(done: dict, record: dict) -> None:
    """Phase 13 (a): each example's output against the JAX examples'
    record.  serve_agents' closed-loop sets, fairness_demo's table and
    quickstart's completions and counters must equal it; the sets that fit
    the predictor on the card (every set without ``--closed-loop``) are
    logged line by line, not gated: the port's MLPs start from torch's
    draws, so its costs are not JAX's (the costs of the record are served
    in (b) and (c))."""
    for name, (out, wall) in done.items():
        log(f"  {name}: exit 0 in {wall:.1f} s")
    out = done["fairness_demo"][0].splitlines()
    if out != record["fairness_demo"]["lines"]:
        raise AssertionError(f"fairness_demo: {out} != the record's "
                             f"{record['fairness_demo']['lines']}")
    log("  fairness_demo: the table equals the JAX example's")
    got, want = (done["quickstart"][0].splitlines(),
                 record["quickstart"]["lines"])
    for i in (0, 2, 3):     # completions, engine counters, the mouse first
        if got[i] != want[i]:
            raise AssertionError(f"quickstart line {i}: {got[i]!r} != the "
                                 f"JAX example's {want[i]!r}")
    log(f"  quickstart: completions and engine counters equal the JAX "
        f"example's, the mouse finished first; {got[1]} (JAX: "
        f"{want[1][len('mouse generated tokens: '):]}; logged: the weights "
        "are torch's draws)")
    for name, argv in EXAMPLE_SETS.items():
        rec = record["serve_agents"][name]
        got = serve_agents_output(done[f"serve_agents {name}"][0])
        equal = [a == b for a, b in zip(got["lines"], rec["lines"])]
        same = (len(got["lines"]) == len(rec["lines"]) and all(equal)
                and got["metrics"] == rec["metrics"])
        jct = next((x for x in got["lines"] if x.startswith("jct:")), None)
        if rec["costs"] is None:
            if not same:
                diff = next((f"line {i}: {a!r} != {b!r}" for i, (a, b) in
                             enumerate(zip(got["lines"], rec["lines"]))
                             if a != b), f"metrics {got['metrics']} != "
                            f"{rec['metrics']}")
                raise AssertionError(f"serve_agents {name} differs from the "
                                     f"JAX example's record: {diff}")
            log(f"  serve_agents {name} ({' '.join(argv)}): every line and "
                "the gated metrics equal the JAX example's")
            continue
        log(f"  serve_agents {name} ({' '.join(argv) or 'no flags'}), the "
            f"card's own predictor (logged): {sum(equal)} of "
            f"{len(rec['lines'])} lines equal, metrics equal "
            f"{got['metrics'] == rec['metrics']}; {jct} (JAX: "
            f"{next(x for x in rec['lines'] if x.startswith('jct:'))})")


def check_train_small(torch, out: str, ckpt: str) -> None:
    """Phase 13 (a): train_small's final loss under ln(vocab), and its
    checkpoint read back into the reduced model on the CPU: the step it
    names, and a loss on the data's first batch well under the initial
    parameters' (the trained parameters, not the initial ones)."""
    import math

    from repro_torch.training import make_eval_step, restore_checkpoint

    ex = load_example("train_small_torch")
    args = ex.parse_args(["--device", "cpu"])
    model, params, _, _, data = ex.build(args, "cpu")
    final = float(out.split("final loss ")[1].split()[0])
    per_step = out.rsplit("(", 1)[1].split("s/step")[0]
    uniform = math.log(ex.VOCAB)
    restored, step = restore_checkpoint(ckpt, {"params": params})
    batch = {k: torch.as_tensor(v) for k, v in next(data).items()}
    loss = make_eval_step(model)
    trained, init = (float(loss(restored["params"], batch)),
                     float(loss(params, batch)))
    log(f"  train_small: {args.steps} steps, final loss {final:.3f} vs "
        f"uniform {uniform:.3f}, {per_step} s/step on the card; checkpoint "
        f"at step {step}: loss {trained:.3f} on the first batch (initial "
        f"parameters {init:.3f})")
    if not final < uniform:
        raise AssertionError(f"train_small: final loss {final} not under "
                             f"ln({ex.VOCAB})")
    if "checkpoint round-trip OK" not in out or step != args.steps:
        raise AssertionError(f"train_small: checkpoint at step {step}")
    if not trained < init - 1.0:
        raise AssertionError(f"train_small: the checkpoint's loss {trained} "
                             f"is not the trained parameters' (initial "
                             f"{init})")


def serve_example(torch, api, ops, ex, model, params, argv: list,
                  costs: list, device: str = "cuda") -> dict:
    """serve_agents' flag set ``argv`` on a model already built: the
    example's own ``build_specs`` (each agent's predicted cost from
    ``costs``, the record's), ``fault_plan``, ``service_kwargs`` and
    ``serve``, over ``AgentService.engine`` with ``EXAMPLE_SERVE``.
    ``model`` is None for the sim (``build_service``).  Returns the
    printed output as the record holds it, each agent's events, the wall
    seconds, the decode steps, the kernels' launches and the (B, S) of
    every batched prefill pass."""
    import contextlib
    import io

    from repro_torch.engine import engine as engine_mod

    args = ex.parse_args(argv + ["--device", device])
    passes = []
    write = engine_mod._prefill_write

    def counted_write(*a, **kw):
        passes.append(tuple(a[5].shape))       # the padded tokens
        return write(*a, **kw)

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        specs = ex.build_specs(args, device,
                               fit=lambda samples, dev: RecordedCosts(costs))
        if args.backend == "sim":
            svc = ex.build_service(args, device)
        else:
            plan, watchdog = ex.fault_plan(args)
            kw = {k: v for k, v in ex.service_kwargs(args, plan,
                                                     watchdog).items()
                  if v is not None and k != "stream"}
            svc = api.AgentService.engine(model, params, args.scheduler,
                                          **EXAMPLE_SERVE, **kw)
        gc.collect()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        engine_mod._prefill_write = counted_write
        try:
            t0 = time.perf_counter()
            result = ex.serve(args, svc, specs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            engine_mod._prefill_write = write
            if hasattr(svc.backend, "close"):
                svc.backend.close()
    m = result.metrics
    steps = m.get("decode_steps", 0) if "per_replica" not in m else sum(
        r["child_decode_steps"] for r in m["per_replica"])
    return {**serve_agents_output(buf.getvalue()),
            "events": handle_events(svc.handles.values()), "wall": wall,
            "steps": steps, "passes": passes,
            "paged": ops.paged_gqa_decode.launches,
            "flash": ops.flash_prefill.launches}


def check_example_run(name: str, got: dict, rec: dict, n_layers: int,
                      flash_path, dtype, hd: int, card: str) -> None:
    """Holds one of phase 13's full-width runs to the record (every line
    but the wall's, the gated metrics, every event row) and its launches
    to the prediction: paged decode n_layers x decode steps, flash n_layers
    x batched prefill passes, each pass on ``flash_path``'s tensor-core
    kernel."""
    paths = {}
    for shape in got["passes"]:
        path = flash_path(dtype, hd, shape[1])
        paths[path] = paths.get(path, 0) + 1
    want_paged, want_flash = (n_layers * got["steps"],
                              n_layers * len(got["passes"]))
    log(f"  {name:8s} wall {got['wall']:.3f} s, decode iterations/s "
        f"{got['steps'] / got['wall']:.2f} ({card}); launches: paged "
        f"{got['paged']} (= {n_layers} x {got['steps']} decode steps: "
        f"{got['paged'] == want_paged}), flash {got['flash']} (= {n_layers}"
        f" x {len(got['passes'])} prefill passes: "
        f"{got['flash'] == want_flash}; passes per path {paths})")
    for key in ("lines", "metrics", "events"):
        if got[key] != rec[key]:
            diff = (events_diff(got[key], rec[key]) if key == "events"
                    else f"{got[key]} != {rec[key]}")
            raise AssertionError(f"{name}: {key} differ from the JAX "
                                 f"example's record: {diff}")
    log(f"  {name:8s} every line, the gated metrics and "
        f"{sum(len(e) for e in got['events'].values())} events equal the "
        "JAX example's record")
    if got["paged"] != want_paged or got["flash"] != want_flash:
        raise AssertionError(f"{name}: launches paged {got['paged']}, flash "
                             f"{got['flash']}; want {want_paged}, "
                             f"{want_flash}")
    if set(paths) != {"tensor_core"}:
        raise AssertionError(f"{name}: prefill passes per flash path "
                             f"{paths}")


def examples_phase(torch, api, ops, pkg, card: str, extra=()) -> dict:
    """Phase 13: the four examples.  (a) every run of ``example_commands``
    in a subprocess as users start them (no ``--device``: the card),
    checked by ``check_examples`` and ``check_train_small``, the card's own
    predictor costs against the record's (logged), and the sim set with
    the record's costs, which must equal the record; (b) serve_agents'
    default set at full width (``EXAMPLE_ARCH`` at bf16, every layer) with
    the record's costs, then the ``chaos`` set; (c) the ``fleet`` set with
    ``--fleet-workers 2`` and without, two rounds each in turns: each run
    held to the record by ``check_example_run``, and the runs with and
    without workers identical; their walls and ratio logged.  ``extra``
    is appended to (a)'s commands.  Returns the launches of (b) and
    (c)."""
    import contextlib
    import io
    import tempfile

    from repro_torch.kernels.flash_attention import flash_path

    record = json.loads(EXAMPLES_RECORD.read_text())
    ex = load_example("serve_agents_torch")
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "train_small.msgpack")
        log("  (a) the examples as users start them, all at once")
        done = finish_examples(start_examples(ckpt, extra))
        check_examples(done, record)
        check_train_small(torch, done["train_small"][0], ckpt)
    rec = record["serve_agents"]
    args = ex.parse_args(["--device", "cuda"])
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        specs = ex.build_specs(args, "cuda")
    fit_s = time.perf_counter() - t0
    want = [c for _, _, c in rec["default"]["costs"]]
    rel = [abs(s.predicted_cost - c) / abs(c) for s, c in zip(specs, want)]
    log(f"  the card's predictor (fitted in {fit_s:.1f} s): each agent's "
        f"cost against the JAX example's, relative difference "
        f"{[f'{r:.2e}' for r in rel]} (max {max(rel):.2e}; logged)")
    got = serve_example(torch, api, ops, ex, None, None, EXAMPLE_SETS["sim"],
                        rec["sim"]["costs"])
    if {k: got[k] for k in ("lines", "metrics")} != {
            k: rec["sim"][k] for k in ("lines", "metrics")}:
        raise AssertionError(f"serve_agents sim with the record's costs: "
                             f"{got['lines']} != {rec['sim']['lines']}")
    log("  serve_agents sim with the record's costs: every line and the "
        "gated metrics equal the JAX example's")

    cfg = pkg["get_config"](EXAMPLE_ARCH)
    log(f"  (b) full-width {cfg.name} through serve_agents' functions and "
        "AgentService.engine, with the record's costs")
    model, params, _ = build_full_width(torch, pkg, cfg)
    total = {"paged_attention": 0, "flash_attention": 0,
             **dict.fromkeys(GLUE, 0)}
    check = dict(n_layers=cfg.n_layers, flash_path=flash_path,
                 dtype=getattr(torch, cfg.dtype), hd=cfg.head_dim, card=card)

    def run(name, argv):
        got = serve_example(torch, api, ops, ex, model, params, argv,
                            rec[name]["costs"])
        check_example_run(name, got, rec[name], **check)
        total["paged_attention"] += got["paged"]
        total["flash_attention"] += got["flash"]
        for key, n in check_glue_counts(ops, cfg, got["paged"],
                                        name).items():
            total[key] += n
        return got

    for name in ("default", "chaos"):
        run(name, EXAMPLE_SETS[name])
    log("  (c) the fleet set with --fleet-workers 2 and without, in turns")
    argv = EXAMPLE_SETS["fleet"]
    i = argv.index("--fleet-workers")
    seq = argv[:i] + argv[i + 2:]
    walls = {"workers": [], "sequential": []}
    first = None
    for _ in range(2):
        for mode, a in (("workers", argv), ("sequential", seq)):
            got = run("fleet", a)
            walls[mode].append(got["wall"])
            same = {k: got[k] for k in ("lines", "metrics", "events")}
            if first is None:
                first = same
            elif same != first:
                raise AssertionError(f"fleet ({mode}) differs from the "
                                     "first fleet run")
    w, s = (statistics.mean(walls["workers"]),
            statistics.mean(walls["sequential"]))
    log(f"  fleet walls ({card}): --fleet-workers 2 "
        f"{[round(x, 3) for x in walls['workers']]} s, sequential "
        f"{[round(x, 3) for x in walls['sequential']]} s; ratio of the "
        f"means {w / s:.3f} (1.0: no overlap; 0.5: the two children "
        f"overlap fully); the four runs identical")
    del model, params
    free_model(torch)
    return total


def run_baseline(torch, pkg, ops, ref, tree: Path) -> int:
    """The before side of a comparison made in one chip call: times the
    kernels of another tree's port (an earlier commit unpacked beside this
    one) by this script's methods, profiles its granite prefill pass and a
    decode step, and its xlstm-350m prefill.  Prints no result line."""
    log(f"== baseline: the port under {tree}")
    log(card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ops.kernel_library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    log_timing("paged_attention", time_paged(ops, ref, torch, gen))
    log_timing("flash_attention", time_flash(ops, ref, torch, gen))
    for name, t in {**time_zoo(ops, ref, torch),
                    **time_families(ops, ref, torch)}.items():
        log_timing(name, t)
    for s_len in (XLSTM["s"], 256):
        log_timing("mlstm_chunk", time_mlstm(ops, ref, torch, gen, s_len))
    cfg = pkg["get_config"]("granite-3-2b")
    model = pkg["Model"](cfg, device="cuda")
    params = model.init(seed=0)
    agents, _ = serving_agents(pkg, cfg.vocab)
    s = largest_bucket(agents)
    profile_granite_prefill(torch, model, params, 8, s)
    # a decode step of 8 slots after a prefill of s tokens, as phase 5
    # profiles one
    cache, toks, pos = decode_ready_cache(torch, model, params, 8, s)
    profile_decode(torch, model, params, cache, toks, pos)
    del model, params, cache
    gc.collect()
    torch.cuda.empty_cache()
    cfg = pkg["get_config"](CHUNK_PREFILL["arch"])
    model, params, _ = build_full_width(torch, pkg, cfg)
    batch = chunk_batch(torch, cfg)
    ms = chunked_pass(torch, model, params, batch)[0]
    log(f"  {cfg.name} prefill_chunked at CHUNK_PREFILL: {ms:.3f} ms a pass "
        "on the device")
    profile_chunked_pass(torch, model, params, batch)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    xlstm = pkg["Model"](pkg["get_config"]("xlstm-350m"), device="cuda")
    profile_prefill(torch, xlstm, xlstm.init(seed=0))
    return 0


def main(argv: list) -> int:
    """``chip_smoke.py``: the smoke run; ``chip_smoke.py --baseline DIR``:
    ``run_baseline`` on the port under DIR."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one GPU",
              file=sys.stderr)
        return 2
    tree = ROOT
    if argv:
        if len(argv) != 2 or argv[0] != "--baseline":
            print("usage: chip_smoke.py [--baseline DIR]", file=sys.stderr)
            return 2
        tree = Path(argv[1]).resolve()
    src = tree / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {src}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.configs import get_config
    from repro_torch.core import (
        InferenceSpec,
        agent_cost,
        make_scheduler,
    )
    from repro_torch.engine import EngineAgent, ServeEngine
    from repro_torch.kernels import ops, ref
    from repro_torch.models import Model
    from repro_torch.models.layers import attention_any

    pkg = dict(get_config=get_config, InferenceSpec=InferenceSpec,
               agent_cost=agent_cost, make_scheduler=make_scheduler,
               EngineAgent=EngineAgent, ServeEngine=ServeEngine, Model=Model)
    if argv:
        return run_baseline(torch, pkg, ops, ref, tree)
    from repro_torch import api
    from repro_torch.engine import ReferenceServeEngine
    from repro_torch.kernels import mlstm_chunk as mlstm
    from repro_torch.kernels.flash_attention import flash_path
    from repro_torch.kernels.flash_attention import smem_bytes as flash_smem
    from repro_torch.kernels.paged_attention import smem_bytes as paged_smem
    from repro_torch.kernels.paged_attention import split_plan
    from repro_torch.models.transformer import decode_page

    pkg["ReferenceServeEngine"] = ReferenceServeEngine
    clock = PhaseClock()
    clock.start("1. device")
    card = card_line()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"  torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; "
        "TF32 off for float32 matmuls and convolutions")

    clock.start("2. build")
    t0 = time.perf_counter()
    load_floor = build_launch_floor(ops)
    ops.kernel_library()
    floor = load_floor()
    log(f"  kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    for path in sorted(ops.BUILD_DIR.glob("*.log")):
        for line in path.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {path.stem}: {line.strip()}")
    for name, mod in ops._KERNELS.items():
        counts = sass_counts(ops._library_path(mod.SOURCE))
        if counts is None:
            log("  cuobjdump not found: tensor-core instruction counts not "
                "measured")
            break
        for fn, c in counts.items():
            log(f"  {name} SASS: HGMMA {c['HGMMA']:4d} HMMA {c['HMMA']:4d}"
                f"  {fn[:90]}")
            if any(t in fn for t in TENSOR_CORE_KERNELS) and not c["HGMMA"]:
                raise AssertionError(f"tensor-core kernel {fn} has no HGMMA")
        for inst in TC_HD80.get(name, ()):
            n = sum(c["HGMMA"] for fn, c in counts.items() if inst in fn)
            log(f"  {name} {inst}: HGMMA {n}")
            if not n:
                raise AssertionError(f"{inst} has no HGMMA in the SASS")
    g, hd = GRANITE, XLSTM["hd"]
    qpk = g["nh"] // g["n_kv"]
    log(f"  dynamic shared memory per block: paged_attention "
        f"{paged_smem(qpk, g['hd'])} bytes (qpk {qpk}, hd {g['hd']}; "
        f"{split_plan(512 // 16)[0]} blocks per slot and kv head), "
        f"flash_attention {flash_smem(g['hd'], path='tensor_core', qpk=qpk)}"
        f" bytes (tensor_core, hd {g['hd']}, qpk {qpk}) and "
        f"{flash_smem(g['hd'])} bytes (cuda_core), "
        f"mlstm_chunk (hd {hd}) {mlstm.smem_bytes(hd, kernel='states')} "
        f"bytes (states pass), {mlstm.smem_bytes(hd, kernel='outputs')} "
        f"bytes (outputs pass), {mlstm.smem_bytes(hd)} bytes (cuda_core); "
        f"blocks at xlstm-350m's prefill "
        f"{mlstm.grids(1, XLSTM['nh'], XLSTM['s'], hd, 'tensor_core')} "
        f"(tensor_core), "
        f"{mlstm.grids(1, XLSTM['nh'], XLSTM['s'], hd, 'cuda_core')}")

    clock.start("3. kernels against their plain versions")
    gen = torch.Generator(device="cuda").manual_seed(0)
    # the max |d| of the line below: the larger of granite-3-2b's and
    # llama2-7b's shapes in bfloat16
    err = {name: max(errs["granite-3-2b"], errs["llama2-7b"])
           for name, errs in (
               ("paged_attention", check_paged(ops, ref, torch, gen,
                                               split_plan, decode_page)),
               ("flash_attention", check_flash(ops, ref, torch, gen,
                                               flash_path)))}
    err["chunk_attention"] = max(
        check_chunk_attention(ops, torch, attention_any).values())
    err["mlstm_chunk"] = check_mlstm(ops, ref, torch, gen, mlstm)
    check_grad_guard(ops, torch)
    timing = {"paged_attention": time_paged(ops, ref, torch, gen),
              "flash_attention": time_flash(ops, ref, torch, gen),
              "mlstm_chunk": time_mlstm(ops, ref, torch, gen, floor=floor)}
    for name, t in timing.items():
        log_timing(name, t)
    # the prompt phase 6 profiles
    log_timing("mlstm_chunk", time_mlstm(ops, ref, torch, gen, 256,
                                         floor=floor))
    # slot caches that 16 does not divide, in the pages Model.decode views
    # them in (a generator of their own, as check_paged's)
    own = torch.Generator(device="cuda").manual_seed(100)
    for t_len in (100, 97):
        log_timing("paged_attention", time_paged(ops, ref, torch, own, t_len,
                                                 decode_page(t_len)))
    for name, t in time_zoo(ops, ref, torch).items():
        log_timing(name, t)
    for name, t in time_families(ops, ref, torch).items():
        log_timing(name, t)
    for arch, c in CHUNK_SHAPES.items():
        for offset in c["offsets"]:
            chunk_t = time_chunk(ops, torch, attention_any, arch, offset)
            log_chunk_timing(chunk_t)
            if (arch, offset) == ("h2o-danube-1.8b", 512):
                timing["chunk_attention"] = chunk_t   # the closed cell's
    glue_err, glue_timing = check_glue(torch, ops, pkg)
    err.update(glue_err)
    timing.update(glue_timing)
    glue_steps(torch, pkg, ops)
    chunk_launches = chunked_prefill(torch, pkg, ops)

    clock.start("4. reduced engines, GPU (kernels) against CPU (plain)")
    reduced_engine(torch, pkg, "granite-3-2b")
    reduced_engine(torch, pkg, "granite-3-2b", flags=True)
    reduced_engine(torch, pkg, "xlstm-350m", n_layers=4)
    reduced_zoo(torch, pkg)
    reduced_engine(torch, pkg, "llava-next-34b")
    reduced_families(torch, pkg)

    clock.start("5. full-width granite-3-2b")
    launches, granite, granite_params = full_width(torch, pkg, ops,
                                                   "granite-3-2b")

    clock.start("6. full-width xlstm-350m")
    launches.update(full_width(torch, pkg, ops, "xlstm-350m")[0])

    clock.start("7. the serving API on the card")
    record = json.loads(API_RECORD.read_text())
    log(f"  (a) full-width {granite.cfg.name} ({granite.cfg.dtype}, phase "
        "5's parameters) through AgentService.engine, held to the JAX "
        f"engine's record ({API_RECORD.relative_to(ROOT)})")
    serve_full_width_api(torch, api, ops, granite, granite_params, record,
                         card)
    profile_fused_step(torch, granite, granite_params, card)
    del granite, granite_params
    gc.collect()
    torch.cuda.empty_cache()
    log("  (b) the launcher, as users start it")
    run_launchers(record)
    log("  (c) bf16 logits, card against CPU")
    bf16_logits_report(torch, pkg)

    clock.start("8. the decoder-only zoo at full width")
    log("  (a) llama2-7b through AgentService.engine")
    zoo = [zoo_api(torch, api, ops, pkg, record, card, "llama2-7b")]
    log("  (b) mixtral-8x7b through AgentService.engine")
    zoo.append(zoo_api(torch, api, ops, pkg, record, card, "mixtral-8x7b"))
    log("  (c) h2o-danube-1.8b over its 4096-row ring")
    zoo.append(zoo_ring(torch, pkg, ops, record, card))
    for arch in ("llama3.2-3b", "starcoder2-7b"):
        log(f"  (d) {arch} through ServeEngine")
        zoo.append(full_width(torch, pkg, ops, arch, profile=False)[0])
        gc.collect()
        torch.cuda.empty_cache()

    clock.start("9. the last three families at full width")
    log("  (a) llava-next-34b through AgentService.engine, then its image "
        "prefill through Model")
    zoo.append(family_llava(torch, api, ops, pkg, record, card))
    log("  (b) zamba2-2.7b through Model")
    zoo.append(family_zamba2(torch, ops, pkg, card))
    log("  (c) whisper-tiny through Model")
    zoo.append(family_whisper(torch, ops, pkg, card))
    for counts in zoo:
        for name, n in counts.items():
            launches[name] += n

    clock.start("10. the agent cost predictor and training on the card")
    log("  (a) the per-class MLP predictor and the heavy baseline")
    predictor_on_card(torch)
    log("  (b) reduced granite-3-2b at float32: a step card against CPU, "
        "learning, a checkpoint")
    train_reduced(torch, pkg, ops)
    log("  (c) full-width granite-3-2b at bf16 through the training launcher")
    train_full_width(torch, ops, card)

    clock.start("11. the distribution layer on the card")
    import torch.distributed as dist

    rows = start_dryrun_rows()
    try:
        mesh = nccl_mesh(torch)
        log("  (a) full-width granite-3-2b through the sharded serving "
            "plans")
        for name, n in sharded_serving(torch, ops, pkg, mesh, card).items():
            launches[name] += n
        log("  (b) full-width granite-3-2b through the training launcher's "
            "--mesh path")
        sharded_training(torch, ops, card)
        dist.destroy_process_group()
    except BaseException:
        rows[0].kill()      # no process outlives a failed run
        raise
    log(f"  (c) the dry-run rows {', '.join(DRYRUN_ROWS)} at full width")
    dryrun_rows(rows, card)

    clock.start("12. the frozen engine at full width, held to ServeEngine")
    for label, arch in zip("ab", FROZEN_RUNS):
        log(f"  ({label}) {arch} through ReferenceServeEngine, then "
            "ServeEngine")
        for name, n in frozen_engine(torch, pkg, ops, arch, card).items():
            launches[name] += n

    clock.start("13. the four examples on the card")
    examples = examples_phase(torch, api, ops, pkg, card)
    log(f"  launches of phases 1-12 {launches}; of phase 13 {examples}")
    for name, n in examples.items():
        launches[name] += n
    clock.start(None)
    launches["chunk_attention"] = chunk_launches   # phase 3's serving run

    sources = {
        "paged_attention": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                            "src/repro/kernels/paged_attention.py:125"),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:125"),
        # chunked prefill's attention replaces no Pallas kernel: the JAX
        # package's plain attention in its chunk step
        "chunk_attention": ("src/repro_torch/kernels/csrc/chunk_attention.cu",
                            "src/repro/models/transformer.py:170"),
        "mlstm_chunk": ("src/repro_torch/kernels/csrc/mlstm_chunk.cu",
                        "src/repro/kernels/mlstm_chunk.py:127"),
        # the decode block's glue replaces no Pallas kernel: the JAX
        # package's jnp, which XLA fuses
        "fused_rms_norm": (GLUE_SOURCE, "src/repro/models/layers.py:22"),
        "fused_add_rms_norm": (GLUE_SOURCE,
                               "src/repro/models/layers.py:22"),
        "rope_kv_write": (GLUE_SOURCE, "src/repro/models/layers.py:46"),
        "silu_mul": (GLUE_SOURCE, "src/repro/models/layers.py:326"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except Exception as exc:  # every phase failure ends the run non-zero
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
