"""The port's dry-run (``repro_torch.launch.dryrun``) against the JAX
package's, at the reductions of ``tests/test_dryrun_machinery.py``.

One subprocess runs ``build_dryrun`` -> ``lower_plan`` under the op
analysis on an 8-rank fake process group (meshes 2x4 and 2x2x2, nothing
allocated: every tensor is a DTensor over ``meta`` shards) for the five
cases of ``scripts/record_jax_dryrun.py``, and on a 1x1 mesh for the
logical (unsharded) FLOPs of every assigned arch x shape.  The JAX
numbers come from ``tests/torch_dryrun_jax.json`` (written by that
script): this file never compiles JAX.

Tolerances.  Per-device argument bytes: equal.  Logical FLOPs of the five
cases and of every serving pair (prefill, decode, long-context decode):
within 1% of JAX's unsharded ``total_stats`` (measured: within 0.15%,
the largest gap xlstm-350m's prefill).  Training pairs differ by more
than 2% where the head is its own weight (untied): the port counts one
(B, S, D) x (D, V) logits product more than JAX's compiled step, which
keeps one of the chunked loss's forward and rematerialised logits
products (the two are the same computation); tied heads agree exactly.
With that product taken off, every training pair is within 2%.
"""

import importlib.util
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
RECORD = json.loads((ROOT / "tests" / "torch_dryrun_jax.json").read_text())
_spec = importlib.util.spec_from_file_location(
    "record_jax_dryrun", ROOT / "scripts" / "record_jax_dryrun.py")
recorder = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(recorder)

SCRIPT = textwrap.dedent("""
    import dataclasses, importlib.util, json, sys
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import ASSIGNED_ARCHS, get_config, supports_shape
    from repro_torch.launch.dryrun import (arg_bytes, fake_world, trace_stats,
                                           with_groups)
    from repro_torch.launch.op_analysis import count_ops
    from repro_torch.launch.specs import build_dryrun, lower_plan

    spec = importlib.util.spec_from_file_location("rec", sys.argv[1])
    rec = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(rec)
    out = {"cases": {}, "logical": {}, "scaling": {}}

    def full_trace(arch, shape, mesh, cfg, **kw):
        plan = build_dryrun(arch, shape, mesh, cfg_override=cfg, **kw)
        return count_ops(lower_plan, plan)[1], plan

    def stats(st):
        return {"flops": st.flops, "coll_bytes": st.coll_bytes,
                "coll_counts": st.coll_counts, "bytes": st.bytes}

    with fake_world(8):
        for arch, shape, seq, b, mshape, axes, opt in rec.CASES:
            cfg = rec.reduce_cfg(get_config(arch, shape=shape))
            mesh = init_device_mesh("cpu", mshape, mesh_dim_names=axes)
            st, plan = full_trace(arch, shape, mesh, cfg, batch_override=b,
                                  seq_override=seq, optimized=opt)
            key = rec.case_key(arch, shape, mshape, opt)
            out["cases"][key] = dict(stats(st), mode=plan.mode,
                                     args=arg_bytes(plan))
        # depth scaling against full traces of a 4-group stack
        mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data",
                                                               "model"))
        for arch, shape in [("granite-3-2b", "train_4k"),
                            ("xlstm-350m", "train_4k"),
                            ("zamba2-2.7b", "prefill_32k"),
                            ("whisper-tiny", "decode_32k")]:
            cfg0 = rec.reduce_cfg(get_config(arch, shape=shape))
            cfg = with_groups(dataclasses.replace(
                cfg0, n_enc_layers=cfg0.n_layers if cfg0.n_enc_layers
                else 0), 4)
            seq, b = rec.SIZES[shape]
            kw = dict(batch_override=b, seq_override=seq // 4)
            full, _ = full_trace(arch, shape, mesh, cfg, **kw)
            scaled, _, info = trace_stats(arch, shape, mesh, cfg=cfg, **kw)
            out["scaling"][f"{arch}|{shape}"] = {
                "full": stats(full), "scaled": stats(scaled), "info": info}
    with fake_world(1):
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data",
                                                               "model"))
        for arch in ASSIGNED_ARCHS:
            for shape, (seq, b) in rec.SIZES.items():
                if not supports_shape(arch, shape):
                    continue
                cfg = rec.reduce_cfg(get_config(arch, shape=shape))
                st, _ = full_trace(arch, shape, mesh, cfg, batch_override=b,
                                   seq_override=seq)
                out["logical"][f"{arch}|{shape}"] = st.flops
        for arch, shape, seq, b, mshape, axes, opt in rec.CASES:
            cfg = rec.reduce_cfg(get_config(arch, shape=shape))
            st, _ = full_trace(arch, shape, mesh, cfg, batch_override=b,
                               seq_override=seq, optimized=opt)
            key = rec.case_key(arch, shape, mshape, opt)
            out["cases"][key]["logical_flops"] = st.flops
    print("RESULTS::" + json.dumps(out))
""")


@pytest.fixture(scope="module")
def results():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT,
         str(ROOT / "scripts" / "record_jax_dryrun.py")],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("RESULTS::")]
    assert line, proc.stdout[-2000:]
    return json.loads(line[0][len("RESULTS::"):])


CASE_KEYS = [recorder.case_key(c[0], c[1], c[4], c[6])
             for c in recorder.CASES]


def _mesh_size(key: str) -> int:
    n = 1
    for d in key.split("|")[2].split("x"):
        n *= int(d)
    return n


def test_record_covers_the_cases():
    assert set(RECORD["cases"]) == set(CASE_KEYS)


@pytest.mark.parametrize("key", CASE_KEYS)
def test_case_mode_and_argument_bytes_equal_jax(results, key):
    got, want = results["cases"][key], RECORD["cases"][key]
    assert got["mode"] == want["mode"]
    assert got["args"] == want["args"]


@pytest.mark.parametrize("key", CASE_KEYS)
def test_case_logical_flops_match_jax(results, key):
    arch, shape = key.split("|")[:2]
    got = results["cases"][key]["logical_flops"]
    want = RECORD["unsharded_flops"][f"{arch}|{shape}"]
    assert got == pytest.approx(want, rel=0.01)


@pytest.mark.parametrize("key", CASE_KEYS)
def test_case_per_device_flops_between_global_over_n_and_global(results,
                                                                 key):
    rec = results["cases"][key]
    glob, n = rec["logical_flops"], _mesh_size(key)
    assert glob / n <= rec["flops"] <= glob


def test_sharded_train_step_has_collectives(results):
    key = [k for k in CASE_KEYS if k.startswith("granite-3-2b|train")][0]
    rec = results["cases"][key]
    assert rec["coll_bytes"] > 0
    assert rec["coll_counts"]["all-gather"] > 0
    assert rec["coll_counts"]["all-reduce"] > 0


def test_optimized_decode_moves_fewer_collective_bytes(results):
    """As the JAX package asserts: the optimized granite decode (no FSDP,
    the cache's sequence on "model") moves fewer collective bytes than the
    sharded train step."""
    opt = [k for k in CASE_KEYS if "opt=True" in k][0]
    train = [k for k in CASE_KEYS if "train" in k][0]
    cases = results["cases"]
    assert cases[opt]["coll_bytes"] < cases[train]["coll_bytes"]


@pytest.mark.parametrize("key", ["granite-3-2b|train_4k",
                                 "xlstm-350m|train_4k",
                                 "zamba2-2.7b|prefill_32k",
                                 "whisper-tiny|decode_32k"])
def test_depth_scaling_equals_a_full_trace(results, key):
    rec = results["scaling"][key]
    assert rec["info"]["traced"] == [1, 2]
    full, scaled = rec["full"], rec["scaled"]
    assert scaled["flops"] == pytest.approx(full["flops"], rel=1e-9)
    assert scaled["coll_bytes"] == pytest.approx(full["coll_bytes"],
                                                 rel=1e-9)
    assert scaled["bytes"] == pytest.approx(full["bytes"], rel=1e-9)
    assert scaled["coll_counts"] == pytest.approx(full["coll_counts"])


def _head_product(arch: str, shape: str) -> float:
    from repro_torch.configs import get_config

    cfg = recorder.reduce_cfg(get_config(arch, shape=shape))
    if cfg.tie_embeddings:
        return 0.0
    seq, b = recorder.SIZES[shape]
    return 2.0 * b * seq * cfg.d_model * cfg.vocab


@pytest.mark.parametrize("pair", sorted(RECORD["unsharded_flops"]))
def test_logical_flops_of_every_pair_match_jax(results, pair):
    arch, shape = pair.split("|")
    got = results["logical"][pair]
    want = RECORD["unsharded_flops"][pair]
    if shape == "train_4k":
        assert got - _head_product(arch, shape) == pytest.approx(want,
                                                                 rel=0.02)
    else:
        assert got == pytest.approx(want, rel=0.01)
