"""The port's training path against the JAX package's (CPU, float32), and
the guard that keeps the kernels out of it.

Inputs come from numpy seeds; parameters from the JAX ``Model.init``
through ``params_from_jax``.

* Optimizer: ``lr_schedule``, ``global_norm`` and ``adamw_update`` (with
  and without clipping, three steps) within 1e-6.
* ``data_iterator`` (a verbatim copy): equal batches.
* Checkpoints: the port's codec byte-equal to ``msgpack.packb(payload,
  use_bin_type=True)`` (msgpack is used by this test only); a JAX
  checkpoint of params with a bf16 leaf and an ``AdamState`` restores in
  the port and the reverse, the two packages' files byte-equal; the
  ``ValueError`` and ``KeyError`` cases.
* Loss and every gradient leaf of every family, reduced, from bridged
  parameters: granite, mixtral (with its aux loss), llava with image
  embeddings, xlstm, zamba2 and whisper with frames; the loss within 1e-5
  relative, each gradient leaf within 1e-5 x (1 + max |g_JAX|).  One
  ``make_train_step`` step within 1e-5 (see its test for the elements
  Adam's first step magnifies) and ``make_eval_step`` (mixtral, its aux
  loss included) within 1e-5; remat on and off give equal
  gradients; no kernel wrapper is called on the training path.
* The port's version of ``tests/test_training.py``'s 80-step learning
  check; the launcher runs with ``--device cpu`` and refuses the meshes.
* The gradient guard: ``ops.refuse_grad`` raises on an input that requires
  grad while grad mode is on and not under ``no_grad``; on the CPU each
  wrapper's plain version keeps its ``grad_fn``; the serving entry points
  run under ``no_grad``.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import Model as JaxModel
from repro.training import AdamWConfig as JaxAdamWConfig
from repro.training import DataConfig as JaxDataConfig
from repro.training import chunked_lm_loss as jax_chunked_lm_loss
from repro.training import data_iterator as jax_data_iterator
from repro.training import init_adamw as jax_init_adamw
from repro.training import lr_schedule as jax_lr_schedule
from repro.training import make_eval_step as jax_make_eval_step
from repro.training import make_train_step as jax_make_train_step
from repro.training import adamw_update as jax_adamw_update
from repro.training import restore_checkpoint as jax_restore
from repro.training import save_checkpoint as jax_save
from repro.training.optimizer import global_norm as jax_global_norm
from repro_torch.kernels import ops
from repro_torch.launch import train as launcher
from repro_torch.models import Model
from repro_torch.models import ssm, transformer
from repro_torch.models.params import params_from_jax
from repro_torch.training import (
    AdamState,
    AdamWConfig,
    DataConfig,
    adamw_update,
    chunked_lm_loss,
    data_iterator,
    init_adamw,
    lr_schedule,
    make_eval_step,
    make_train_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.training.checkpoint import packb, unpackb
from repro_torch.training.optimizer import global_norm
from repro_torch.tree import tree_leaves

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-5
#: reduced families, each at its arch's real q-per-kv ratio where
#: ``reduced()`` alone would change it (the overrides of
#: ``tests/test_torch_families.py``)
FAMILIES = {
    "granite-3-2b": {},
    "mixtral-8x7b": {},
    "llava-next-34b": dict(n_heads=7, n_kv_heads=1),
    "xlstm-350m": {},
    "zamba2-2.7b": dict(n_heads=4, n_kv_heads=4, n_layers=4),
    "whisper-tiny": dict(n_heads=4, n_kv_heads=4),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny tensors: one intra-op thread per test worker.  Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_leaves(tree) -> list:
    return [np.asarray(x) for x in jax.tree.leaves(jax.device_get(tree))]


def assert_leaves_close(port_tree, jax_tree, atol):
    port, ref = tree_leaves(port_tree), jax_leaves(jax_tree)
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   b.astype(np.float32), atol=atol, rtol=0)


# -------------------------------------------------------------- optimizer


def test_lr_schedule_matches_jax():
    cfg = dict(lr=1e-3, warmup_steps=10, total_steps=100)
    for s in range(0, 120, 3):
        np.testing.assert_allclose(
            float(lr_schedule(AdamWConfig(**cfg), torch.tensor(s))),
            float(jax_lr_schedule(JaxAdamWConfig(**cfg), jnp.int32(s))),
            rtol=1e-6, atol=0)


def small_tree(seed: int):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(5, 3)).astype(np.float32),
            "nested": {"b": rng.normal(size=(4,)).astype(np.float32),
                       "a": [rng.normal(size=(2, 2)).astype(np.float32)]}}


def to_torch(tree):
    return params_from_jax(tree, "cpu")


def test_global_norm_matches_jax():
    tree = small_tree(0)
    np.testing.assert_allclose(
        float(global_norm(to_torch(tree))),
        float(jax_global_norm(jax.tree.map(jnp.asarray, tree))),
        rtol=1e-6)


@pytest.mark.parametrize("clip", [0.5, 100.0], ids=["clipped", "unclipped"])
def test_adamw_update_matches_jax(clip):
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=clip)
    jp = jax.tree.map(jnp.asarray, small_tree(0))
    tp = to_torch(small_tree(0))
    jopt, topt = jax_init_adamw(jp), init_adamw(tp)
    for i in range(3):
        grads = small_tree(10 + i)
        jp, jopt, jm = jax_adamw_update(JaxAdamWConfig(**cfg),
                                        jax.tree.map(jnp.asarray, grads),
                                        jopt, jp)
        tp, topt, tm = adamw_update(AdamWConfig(**cfg), to_torch(grads),
                                    topt, tp)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    assert int(topt.step) == int(jopt.step) == 3
    assert_leaves_close(tp, jp, 1e-6)
    assert_leaves_close(topt.m, jopt.m, 1e-6)
    assert_leaves_close(topt.v, jopt.v, 1e-6)


def test_data_iterator_equal_batches():
    cfg = dict(vocab=128, seq_len=64, global_batch=4, seed=3, order=1)
    ours = data_iterator(DataConfig(**cfg))
    ref = jax_data_iterator(JaxDataConfig(**cfg))
    for _ in range(3):
        np.testing.assert_array_equal(next(ours)["tokens"],
                                      next(ref)["tokens"])


# ------------------------------------------------------------- checkpoint


@pytest.mark.parametrize("payload", [
    0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32, -33, -129,
    -40000, -2 ** 40, "", "x" * 31, "y" * 32, "z" * 300, "w" * 70000,
    b"", b"\x00" * 255, b"\x01" * 256, b"\x02" * 70000, [], list(range(15)),
    list(range(16)), list(range(70000)), {}, {str(i): i for i in range(15)},
    {str(i): [i, str(i)] for i in range(16)},
], ids=lambda p: f"{type(p).__name__}{len(p) if hasattr(p, '__len__') else p}")
def test_codec_byte_equal_to_msgpack(payload):
    packed = packb(payload)
    assert packed == msgpack.packb(payload, use_bin_type=True)
    assert unpackb(packed) == msgpack.unpackb(packed, raw=False)


def ckpt_trees():
    """A JAX tree (params with a bf16 leaf, and its ``AdamState``) and the
    port's tree of the same values."""
    rng = np.random.default_rng(5)
    params = {"blocks": {"w": rng.normal(size=(2, 3, 4)).astype(np.float32)},
              "embed": rng.normal(size=(6, 4)).astype(np.float32),
              "lst": [np.arange(3, dtype=np.int32)]}
    jparams = jax.tree.map(jnp.asarray, params)
    jparams["embed"] = jparams["embed"].astype(jnp.bfloat16)
    tparams = to_torch(params)
    tparams["embed"] = tparams["embed"].to(torch.bfloat16)
    return ({"params": jparams, "opt": jax_init_adamw(jparams)},
            {"params": tparams, "opt": init_adamw(tparams)})


def test_checkpoint_crosses_between_packages(tmp_path):
    jtree, ttree = ckpt_trees()
    jpath, tpath = str(tmp_path / "jax.ckpt"), str(tmp_path / "port.ckpt")
    jax_save(jpath, jtree, step=5)
    save_checkpoint(tpath, ttree, step=5)
    assert Path(jpath).read_bytes() == Path(tpath).read_bytes()
    restored, step = restore_checkpoint(jpath, ttree)
    assert step == 5 and isinstance(restored["opt"], AdamState)
    assert restored["params"]["embed"].dtype == torch.bfloat16
    assert restored["opt"].step.dtype == torch.int32
    pairs = [(restored["params"], ttree["params"]),
             (restored["opt"].m, ttree["opt"].m),
             (restored["opt"].v, ttree["opt"].v),
             ([restored["opt"].step], [ttree["opt"].step])]
    for got_tree, want_tree in pairs:
        for got, want in zip(tree_leaves(got_tree), tree_leaves(want_tree)):
            assert got.dtype == want.dtype
            assert torch.equal(got, want)
    back, step = jax_restore(tpath, jtree)
    assert step == 5
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        assert got.dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(np.asarray(got, np.float32),
                                      np.asarray(want, np.float32))


def test_checkpoint_imports_neither_msgpack_nor_ml_dtypes(tmp_path):
    code = (
        "import sys, torch\n"
        "from repro_torch.training import save_checkpoint, "
        "restore_checkpoint, init_adamw\n"
        "t = {'w': torch.ones(3, dtype=torch.bfloat16)}\n"
        "tree = {'params': t, 'opt': init_adamw(t)}\n"
        f"save_checkpoint({str(tmp_path / 'c')!r}, tree, step=2)\n"
        f"r, s = restore_checkpoint({str(tmp_path / 'c')!r}, tree)\n"
        "assert s == 2 and torch.equal(r['params']['w'], t['w'])\n"
        "bad = [m for m in ('msgpack', 'ml_dtypes', 'jax') if m in "
        "sys.modules]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_checkpoint_refusals_match_jax(tmp_path):
    path = str(tmp_path / "ck")
    save_checkpoint(path, {"a": torch.zeros(2)})
    with pytest.raises(ValueError, match="shape mismatch for a"):
        restore_checkpoint(path, {"a": torch.zeros(3)})
    with pytest.raises(KeyError, match="checkpoint missing leaf b"):
        restore_checkpoint(path, {"a": torch.zeros(2), "b": torch.zeros(1)})
    with pytest.raises(ValueError):
        jax_restore(path, {"a": jnp.zeros((3,))})


# ------------------------------------------------------------ model + loss


def family_pair(arch: str):
    cfg = get_config(arch).reduced(**FAMILIES[arch])
    jm = JaxModel(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return cfg, jm, jp, Model(cfg, device="cpu"), params_from_jax(
        jax.device_get(jp), "cpu")


def family_batch(arch: str, cfg, b: int = 2, s: int = 32) -> dict:
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    n_embeds = {"llava-next-34b": 8, "whisper-tiny": cfg.n_audio_frames}
    if arch in n_embeds:
        batch["embeds"] = rng.normal(
            size=(b, n_embeds[arch], cfg.d_model)).astype(np.float32)
    return batch


def with_grad(tree):
    """The tree with each leaf detached and requiring grad."""
    return {k: with_grad(v) if isinstance(v, dict)
            else v.detach().requires_grad_(True) for k, v in tree.items()}


def port_loss_and_grads(model, params, batch, remat: bool = True):
    tp = with_grad(params)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    if remat:
        x, aux = model.hidden(tp, tb)
    else:
        run = model._run_stack_train
        model._run_stack_train = lambda *a: run(*a, remat=False)
        try:
            x, aux = model.hidden(tp, tb)
        finally:
            del model._run_stack_train
    loss = chunked_lm_loss(x, model.head_matrix(tp), tb["tokens"],
                           moe_aux=aux)
    grads = torch.autograd.grad(loss, tree_leaves(tp))
    return loss.detach(), grads


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_loss_and_grads_match_jax(arch):
    cfg, jm, jp, tm, tp = family_pair(arch)
    batch = family_batch(arch, cfg)

    def jax_loss(p):
        x, aux = jm.hidden(p, {k: jnp.asarray(v) for k, v in batch.items()})
        return jax_chunked_lm_loss(x, jm.head_matrix(p),
                                   jnp.asarray(batch["tokens"]), moe_aux=aux)

    lj, gj = jax.value_and_grad(jax_loss)(jp)
    lt, gt = port_loss_and_grads(tm, tp, batch)
    assert float(lt) == pytest.approx(float(lj), rel=TOL)
    if arch == "mixtral-8x7b":
        assert float(tm.hidden(tp, {k: torch.as_tensor(v) for k, v in
                                    batch.items()})[1]) > 0
    ref = jax_leaves(gj)
    assert len(gt) == len(ref)
    for g, r in zip(gt, ref):
        np.testing.assert_allclose(g.numpy(), r,
                                   atol=TOL * (1 + np.abs(r).max()), rtol=0)


@pytest.mark.parametrize("arch", ["granite-3-2b", "xlstm-350m",
                                  "zamba2-2.7b"])
def test_remat_on_and_off_equal_gradients(arch):
    cfg, _, _, tm, tp = family_pair(arch)
    batch = family_batch(arch, cfg)
    l1, g1 = port_loss_and_grads(tm, tp, batch, remat=True)
    l0, g0 = port_loss_and_grads(tm, tp, batch, remat=False)
    assert float(l1) == float(l0)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_train_step_matches_jax():
    """One step: loss, grad norm, lr and every parameter within 1e-5, but
    for the elements whose JAX gradient is nonzero and below 1e-6.  A
    first Adam step moves a parameter by lr * g / (|g| + 1e-8), so there a
    one-ulp difference in g (the gradients agree to about 2e-7 relative)
    becomes a difference in the step: measured on the CPU, 1.0e-4 at an
    element of ``mlp.w1`` with |g| 3.9e-9, 241 such elements of 361,088,
    while every other element agreed within 5.1e-7.  Those elements are
    held to the most a first step can move two parameters apart, 2 lr,
    and must stay under 1 % of the elements."""
    cfg, jm, jp, tm, tp = family_pair("granite-3-2b")
    batch = family_batch("granite-3-2b", cfg)
    ocfg = dict(lr=3e-3, warmup_steps=2, total_steps=10)

    def jax_loss(p):
        x, aux = jm.hidden(p, {k: jnp.asarray(v) for k, v in batch.items()})
        return jax_chunked_lm_loss(x, jm.head_matrix(p),
                                   jnp.asarray(batch["tokens"]), moe_aux=aux)

    grads = jax_leaves(jax.grad(jax_loss)(jp))
    jstep = jax_make_train_step(jm, JaxAdamWConfig(**ocfg))
    jp, _, jmet = jstep(jp, jax_init_adamw(jp),
                        {k: jnp.asarray(v) for k, v in batch.items()})
    tstep = make_train_step(tm, AdamWConfig(**ocfg))
    tp, topt, tmet = tstep(tp, init_adamw(tp),
                           {k: torch.as_tensor(v) for k, v in batch.items()})
    for k in ("loss", "grad_norm", "lr"):
        assert float(tmet[k]) == pytest.approx(float(jmet[k]), rel=TOL)
    assert int(topt.step) == 1
    n_tiny = n_all = 0
    for got, want, g in zip(tree_leaves(tp), jax_leaves(jp), grads):
        tiny = (g != 0) & (np.abs(g) < 1e-6)
        gap = np.abs(got.numpy() - want)
        assert gap[~tiny].max() <= TOL
        assert not tiny.any() or gap[tiny].max() <= 2 * ocfg["lr"]
        n_tiny, n_all = n_tiny + int(tiny.sum()), n_all + g.size
    assert n_tiny < 1e-2 * n_all, (n_tiny, n_all)


def test_eval_step_matches_jax():
    cfg, jm, jp, tm, tp = family_pair("mixtral-8x7b")
    batch = family_batch("mixtral-8x7b", cfg)
    want = jax_make_eval_step(jm)(jp, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    got = make_eval_step(tm)(tp, {k: torch.as_tensor(v)
                                  for k, v in batch.items()})
    assert float(got) == pytest.approx(float(want), rel=TOL)


def test_training_path_launches_no_kernel(monkeypatch):
    """Training calls none of the three wrappers: on the card they would
    refuse it (no backward), so on the CPU any call fails here."""
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel wrapper was called while training")

    for mod, name in ((transformer, "flash_prefill"),
                      (transformer, "paged_gqa_decode"),
                      (ssm, "mlstm_chunk")):
        monkeypatch.setattr(mod, name, refuse)
    for arch in ("granite-3-2b", "xlstm-350m", "zamba2-2.7b",
                 "whisper-tiny"):
        cfg = get_config(arch).reduced(**FAMILIES[arch])
        model = Model(cfg, device="cpu")
        port_loss_and_grads(model, model.init(seed=0),
                            family_batch(arch, cfg, s=16))


def test_tiny_model_learns_synthetic_language():
    """The port's version of ``tests/test_training.py``'s learning check:
    the loss must drop clearly below the uniform baseline in 80 steps."""
    cfg = get_config("granite-3-2b").reduced(vocab=128, n_layers=2)
    model = Model(cfg, device="cpu")
    params = model.init(seed=0)
    it = data_iterator(DataConfig(vocab=128, seq_len=64, global_batch=8,
                                  seed=0, order=1, temperature=0.2))
    step = make_train_step(model, AdamWConfig(lr=3e-3, warmup_steps=5,
                                              total_steps=200,
                                              weight_decay=0.0))
    opt = init_adamw(params)
    losses = []
    for _ in range(80):
        batch = {k: torch.as_tensor(v) for k, v in next(it).items()}
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    uniform = np.log(128)
    assert losses[-1] < losses[0]
    assert min(losses[-5:]) < uniform * 0.75, losses[-5:]


def test_launcher_trains_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--steps", "3", "--batch", "2", "--seq", "32"],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    lines = [l for l in out.stdout.splitlines() if l.startswith("step")]
    assert len(lines) == 2 and "loss=" in lines[-1]


@pytest.mark.parametrize("mesh", ["debug", "prod", "multipod"])
def test_launcher_refuses_meshes(mesh):
    """A sharded mesh needs a process group: outside torchrun, with none
    initialised, the launcher refuses it (a group of the wrong size is
    refused in tests/test_torch_shardlib.py)."""
    assert "RANK" not in os.environ
    with pytest.raises(RuntimeError, match="torchrun"):
        launcher.run(["--mesh", mesh, "--device", "cpu"])


# -------------------------------------------------------------- the guard


def test_refuse_grad_raises_only_where_a_graph_would_be_cut():
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="flash_prefill: .*no backward"):
        ops.refuse_grad("flash_prefill", torch.ones(2), x)
    with torch.no_grad():
        ops.refuse_grad("flash_prefill", torch.ones(2), x)
    ops.refuse_grad("paged_gqa_decode", torch.ones(2),
                    torch.ones(2, dtype=torch.int32))


def test_cpu_wrappers_keep_their_grad_fn():
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(1, 64, 4, 32, generator=gen, requires_grad=True)
    k = torch.randn(1, 64, 2, 32, generator=gen, requires_grad=True)
    out = ops.flash_prefill(q, k, k)
    assert out.grad_fn is not None
    pages = torch.randn(4, 16, 2, 32, generator=gen, requires_grad=True)
    out = ops.paged_gqa_decode(q[:, 0], pages, pages,
                               torch.arange(4, dtype=torch.int32)[None],
                               torch.tensor([50], dtype=torch.int32))
    assert out.grad_fn is not None
    qm = torch.randn(1, 2, 40, 32, generator=gen, requires_grad=True)
    gates = torch.randn(1, 2, 40, generator=gen)
    h, _ = ops.mlstm_chunk(qm, qm, qm, gates, -gates.abs())
    assert h.grad_fn is not None


def test_serving_entry_points_compute_no_gradients():
    cfg = get_config("granite-3-2b").reduced()
    model = Model(cfg, device="cpu")
    params = with_grad(model.init(seed=0))
    tokens = torch.randint(0, cfg.vocab, (2, 16), generator=torch.Generator(
        ).manual_seed(0))
    logits, cache = model.prefill(params, {"tokens": tokens}, cache_len=32)
    assert logits.grad_fn is None and not cache["k"].requires_grad
    logits, _ = model.decode(params, cache, tokens[:, :1],
                             torch.full((2,), 16, dtype=torch.int32))
    assert logits.grad_fn is None
