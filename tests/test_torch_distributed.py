"""The port's sharded plans on real DTensors: four gloo CPU processes on a
(2, 2) ("data", "model") mesh, float32, against the unsharded port in the
same process.

* One AdamW train step (``build_dryrun(..., params=, batch=)`` ->
  ``lower_plan``, the train launcher's layout: parameters and moments by
  ``param_pspecs``/``opt_pspecs``, the batch by its batch axes) for reduced
  granite-3-2b, mixtral-8x7b and xlstm-350m: loss and grad norm within
  1e-5 relative, every parameter within 1e-5, except the elements whose
  unsharded gradient is |g| < 1e-6, which Adam's first step normalises by
  |g| + 1e-8 (so a rounding of g moves them by up to lr), held to 2 lr.
  That takes in g == 0: at xlstm-350m an element whose unsharded
  gradient is exactly 0 gets a rounding residue from the sum of the two
  batch shards' partial gradients, which Adam's eps turned into 1.05e-5.
* granite-3-2b's sharded prefill and 8 greedy decode steps through the
  kernel wrappers on local shards (``local_map``): the heads split 2-way
  over "model", the plain kernels of the CPU on each shard; every token
  equal to the unsharded ``Model``'s and the logits within 1e-5.

Each process gathers (``full_tensor``, a collective every rank calls)
before rank 0 compares.  The processes run in a subprocess under a
timeout, which kills them all where one hangs.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["granite-3-2b", "mixtral-8x7b", "xlstm-350m"]
LR = 1e-2

WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def worker(rank, world, outdir):
        dist.init_process_group("gloo", init_method=f"file://{outdir}/store",
                                rank=rank, world_size=world)
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.configs import get_config
        from repro_torch.launch.specs import (build_dryrun, distribute,
                                              lower_plan)
        from repro_torch.models import Model
        from repro_torch.training import AdamWConfig, init_adamw
        from repro_torch.training import make_train_step
        from repro_torch.training.train import chunked_lm_loss
        from repro_torch.tree import tree_leaves, tree_map

        def plan_model(plan):
            return Model(plan.cfg, device="cpu")

        torch.manual_seed(0)
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        out = {"train": {}, "serve": {}}
        rng = np.random.default_rng(0)
        opt_cfg = AdamWConfig(lr=LR, warmup_steps=1, total_steps=10)
        for arch in ARCHS:
            cfg = get_config(arch).reduced(vocab=512)
            model = Model(cfg, device="cpu")
            params = model.init(seed=0)
            tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (4, 64)),
                                     dtype=torch.int32)
            batch = {"tokens": tokens}
            clone = lambda t: tree_map(lambda x: x.clone(), t)
            # the unsharded step and its gradients
            ref = clone(params)
            leaves = [p.detach().requires_grad_(True)
                      for p in tree_leaves(params)]
            from repro_torch.tree import tree_unflatten
            tree = tree_unflatten(params, leaves)
            x, aux = model.hidden(tree, batch)
            loss = chunked_lm_loss(x, model.head_matrix(tree), tokens,
                                   moe_aux=aux)
            grads = torch.autograd.grad(loss, leaves)
            _, _, ref_m = make_train_step(model, opt_cfg)(
                ref, init_adamw(ref), batch)
            plan = build_dryrun(arch, "train_4k", mesh, cfg_override=cfg,
                                batch_override=4, seq_override=64,
                                params=clone(params), batch=batch)
            # the plan's step with this test's optimizer (a larger lr than
            # JAX's default's first step, so that the update shows)
            plan = plan._replace(fn=make_train_step(plan_model(plan),
                                                    opt_cfg))
            new, _, m = lower_plan(plan)
            got = [p.full_tensor() for p in tree_leaves(new)]
            if rank == 0:
                worst, worst_tiny = 0.0, 0.0
                for g, a, b in zip(grads, got, tree_leaves(ref)):
                    d = (a - b).abs()
                    tiny = g.abs() < 1e-6
                    worst = max(worst, float(torch.where(tiny, 0, d).max()))
                    worst_tiny = max(worst_tiny,
                                     float(torch.where(tiny, d, 0).max()))
                out["train"][arch] = {
                    "loss": [float(m["loss"]), float(ref_m["loss"])],
                    "grad_norm": [float(m["grad_norm"]),
                                  float(ref_m["grad_norm"])],
                    "param_err": worst, "tiny_err": worst_tiny}

        # sharded prefill + greedy decode, heads split 2-way: the kernel
        # wrappers record the heads of each sharded call's local shard
        import repro_torch.models.transformer as T
        heads_seen = set()

        from repro_torch.models.shardlib import active_rules

        def seen(fn, dim):
            def run(q, *args, **kw):
                if active_rules() is not None:     # the sharded plans only
                    heads_seen.add((fn.__name__, q.shape[dim]))
                return fn(q, *args, **kw)
            return run

        T.flash_prefill = seen(T.flash_prefill, 2)
        T.paged_gqa_decode = seen(T.paged_gqa_decode, 1)
        cfg = get_config("granite-3-2b").reduced(vocab=512)
        model = Model(cfg, device="cpu")
        params = model.init(seed=1)
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (4, 32)),
                                 dtype=torch.int32)
        lens = torch.tensor([32, 20, 32, 27], dtype=torch.int32)
        ref_logits, ref_cache = model.prefill(
            params, {"tokens": tokens, "lens": lens}, cache_len=64)
        plan = build_dryrun("granite-3-2b", "prefill_32k", mesh,
                            cfg_override=cfg, batch_override=4,
                            seq_override=32, params=params,
                            batch={"tokens": tokens, "lens": lens},
                            cache_len=64)
        logits, cache = lower_plan(plan)
        heads = cache["k"].placements
        steps, err = [], 0.0
        tok_ref = ref_logits.argmax(-1).to(torch.int32)
        full = logits.full_tensor()
        err = max(err, float((full - ref_logits).abs().max()))
        tok = full.argmax(-1).to(torch.int32)
        pos = lens.clone()
        dplan = None
        for i in range(8):
            steps.append([tok[:, 0].tolist(), tok_ref[:, 0].tolist()])
            ref_logits, ref_cache = model.decode(params, ref_cache, tok_ref,
                                                 pos)
            if dplan is None:
                dplan = build_dryrun("granite-3-2b", "decode_32k", mesh,
                                     cfg_override=cfg, batch_override=4,
                                     seq_override=64, params=params,
                                     batch={"tokens": tok, "pos": pos},
                                     cache=cache)
                logits, cache = lower_plan(dplan)
            else:
                args = (dplan.args[0], cache,
                        distribute(tok, mesh, dplan.in_specs[2]),
                        distribute(pos, mesh, dplan.in_specs[3]))
                logits, cache = lower_plan(dplan, *args)
            full = logits.full_tensor()
            err = max(err, float((full - ref_logits).abs().max()))
            tok = full.argmax(-1).to(torch.int32)
            tok_ref = ref_logits.argmax(-1).to(torch.int32)
            pos = pos + 1
        steps.append([tok[:, 0].tolist(), tok_ref[:, 0].tolist()])
        out["serve"] = {"tokens": steps, "logit_err": err,
                        "heads_seen": sorted(heads_seen),
                        "cache_placements": [[type(p).__name__,
                                              getattr(p, "dim", None)]
                                             for p in heads],
                        "n_heads": cfg.n_heads}
        if rank == 0:
            with open(f"{outdir}/results.json", "w") as f:
                json.dump(out, f)
        dist.barrier()
        dist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(worker, args=(4, sys.argv[1]), nprocs=4, join=True)
""").replace("LR", repr(LR)).replace("ARCHS", repr(ARCHS))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    script = tmp / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, str(script), str(tmp)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=ROOT,
                            start_new_session=True)
    try:
        _, err = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.communicate()
        pytest.fail("the 4-process run did not finish in 300 s")
    assert proc.returncode == 0, err[-3000:]
    return json.loads((tmp / "results.json").read_text())


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_equals_unsharded(results, arch):
    rec = results["train"][arch]
    for name in ("loss", "grad_norm"):
        got, want = rec[name]
        assert got == pytest.approx(want, rel=1e-5), name
    assert rec["param_err"] <= 1e-5
    assert rec["tiny_err"] <= 2 * LR


def test_sharded_serving_equals_unsharded(results):
    rec = results["serve"]
    for got, want in rec["tokens"]:
        assert got == want
    assert rec["logit_err"] <= 1e-5
    # the cache kept the baseline layout: batch on "data", head_dim on
    # "model"; the kernels ran on half the heads of each of the local
    # batch rows (the attention redistributed head_dim to heads itself)
    assert rec["cache_placements"] == [["Shard", 1], ["Shard", 4]]
    half = rec["n_heads"] // 2
    assert rec["heads_seen"] == [["flash_prefill", half],
                                 ["paged_gqa_decode", half]]
