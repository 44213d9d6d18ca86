"""The port's sharding annotations (``repro_torch.models.shardlib``) beside
the JAX package's, its placements on a fake (2, 2) mesh, the op analysis's
per-device and loop counts, and the kernel wrappers' refusals.

The cases of ``tests/test_shardlib_and_analysis.py`` carry over: no-op
without a mesh, the rank mismatch, the spec mapping and nesting, here
also held to the JAX package's own functions on the same inputs.  A fake
process group of four ranks (no collective moves data) is made for the
module and destroyed after it.
"""

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro.models import shardlib as jax_shardlib
from repro_torch.launch.op_analysis import (
    count_ops,
    expand,
    loop_weights,
    repeated,
)
from repro_torch.models.shardlib import (
    P,
    active_rules,
    local_call,
    logical_to_spec,
    param_spec,
    shard,
    to_placements,
    use_sharding,
)


@pytest.fixture(scope="module")
def mesh():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def meta_dtensor(mesh, shape, placements, dtype=torch.float32):
    """A DTensor over an empty meta shard of rank 0's shape."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )
    local, _ = compute_local_shape_and_global_offset(shape, mesh, placements)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(torch.empty(local, dtype=dtype, device="meta"),
                              mesh, placements, run_check=False,
                              shape=shape, stride=stride)


# ------------------------------------------------------------- shardlib


def test_shard_is_noop_without_mesh():
    x = torch.ones((4, 8))
    assert shard(x, "batch", "embed") is x
    assert active_rules() is None
    assert param_spec(["batch", "embed"]) == P()


def test_shard_rank_mismatch_raises(mesh):
    with use_sharding(mesh, {"batch": "data"}):
        with pytest.raises(ValueError):
            shard(torch.ones((4, 8)), "batch")


@pytest.mark.parametrize("names", [
    ["batch", None, "ffn"], ["embed", "vocab"], [None], ["ffn", "batch"]])
def test_logical_to_spec_mapping(names):
    """The same spec as the JAX package's on the same rules."""
    rules = {"batch": ("pod", "data"), "ffn": "model", "embed": None,
             "vocab": "model"}
    spec = logical_to_spec(names, rules)
    assert tuple(spec) == tuple(jax_shardlib.logical_to_spec(names, rules))
    if names == ["batch", None, "ffn"]:
        assert spec == P(("pod", "data"), None, "model")


def test_use_sharding_nests_and_restores(mesh):
    with use_sharding(mesh, {"batch": "data"}):
        assert active_rules()[1] == {"batch": "data"}
        with use_sharding(mesh, {"batch": None}):
            assert active_rules()[1] == {"batch": None}
        assert active_rules()[1] == {"batch": "data"}
    assert active_rules() is None


@pytest.mark.parametrize("spec,want", [
    (P("data", None), (Shard(0), Replicate())),
    (P(None, "model"), (Replicate(), Shard(1))),
    (P("model", "data"), (Shard(1), Shard(0))),
    (P(("data", "model")), (Shard(0), Shard(0))),
    (P(), (Replicate(), Replicate())),
])
def test_to_placements(mesh, spec, want):
    assert to_placements(spec, mesh) == want


def test_to_placements_refuses_bad_specs(mesh):
    with pytest.raises(ValueError):
        to_placements(P(("model", "data")), mesh)     # not in mesh order
    with pytest.raises(ValueError):
        to_placements(P("data", "data"), mesh)        # one axis twice


def test_shard_redistributes_a_dtensor(mesh):
    x = meta_dtensor(mesh, (8, 16), (Replicate(), Replicate()))
    rules = {"batch": "data", "ffn": "model"}
    with use_sharding(mesh, rules):
        y = shard(x, "batch", "ffn")
        assert y.placements == (Shard(0), Shard(1))
        assert y.to_local().shape == (4, 8)
        assert shard(y, "batch", "ffn") is y
        assert shard(torch.ones(8, 16), "batch", "ffn").shape == (8, 16)


def test_local_call_contraction_is_partial(mesh):
    """A product whose contracted dim is split gives a Partial output; a
    split free dim stays split; a plain tensor runs unchanged."""
    x = meta_dtensor(mesh, (8, 16), (Shard(0), Shard(1)))
    w = meta_dtensor(mesh, (16, 32), (Replicate(), Shard(0)))
    y = local_call(torch.matmul, "bd,df->bf", x, w)
    assert y.placements == (Shard(0), Partial())
    assert y.shape == (8, 32)
    a, b = torch.randn(3, 4), torch.randn(4, 5)
    assert torch.equal(local_call(torch.matmul, "bd,df->bf", a, b), a @ b)


# ----------------------------------------------------------- op analysis


def test_sharded_matmul_counts_per_device(mesh):
    """A matmul split over both mesh dims counts a quarter of the global
    FLOPs on this rank; the FlopCounterMode count is the global one."""
    a = meta_dtensor(mesh, (256, 128), (Shard(0), Replicate()))
    b = meta_dtensor(mesh, (128, 512), (Replicate(), Shard(1)))
    out, st = count_ops(lambda: a @ b)
    glob = 2 * 256 * 128 * 512
    assert out.placements == (Shard(0), Shard(1))
    assert st.flops == glob / 4
    assert sum(st.coll_counts.values()) == 0
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        a @ b
    assert fc.get_total_flops() == glob


def test_redistribution_counts_a_collective(mesh):
    """An FSDP-split weight against a batch-split input gathers once."""
    x = meta_dtensor(mesh, (8, 64), (Shard(0), Replicate()))
    w = meta_dtensor(mesh, (64, 32), (Shard(0), Replicate()))
    _, st = count_ops(local_call, torch.matmul, "bd,df->bf", x, w)
    assert st.coll_counts["all-gather"] == 1
    assert st.coll_bytes_by["all-gather"] == 64 * 32 * 4
    assert st.flops == 2 * 4 * 64 * 32


def test_python_loop_counts_each_iteration():
    """A loop of 10 matmuls counts 10x one matmul."""
    x, w = torch.ones(128, 128), torch.ones(128, 128)

    def f():
        c = x
        for _ in range(10):
            c = c @ w
        return c

    _, st = count_ops(f)
    assert st.flops == 10 * 2 * 128 ** 3


def test_nested_loops_multiply():
    x, w = torch.ones(64, 64), torch.ones(64, 64)

    def f():
        c = x
        for _ in range(3):
            for _ in range(4):
                c = c @ w
        return c

    _, st = count_ops(f)
    assert st.flops == 12 * 2 * 64 ** 3


@pytest.mark.parametrize("n", [2, 7])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_loop_weights_count_as_the_whole_loop(n, device):
    """A recurrence run by ``loop_weights`` (three iterations on meta)
    counts, forward and backward, what the whole loop counts."""
    def run(weights_fn):
        w = torch.ones(32, 32, device=device, requires_grad=True)
        h = torch.ones(4, 32, device=device)
        outs, weights = [], weights_fn(n, h)
        for _, k in enumerate(weights):
            with repeated(k):
                h = torch.tanh(h @ w)
            outs.append(h)
        loss = torch.stack(expand(outs, weights)).sum()
        return torch.autograd.grad(loss, w)

    _, whole = count_ops(run, lambda n, x: [1] * n)
    _, short = count_ops(run, loop_weights)
    assert short.flops == whole.flops
    assert whole.flops == n * 3 * 2 * 4 * 32 * 32 - 2 * 4 * 32 * 32


# -------------------------------------------------------- kernel guards


def test_kernel_wrappers_refuse_a_split_head_dim(mesh):
    from repro_torch.kernels import ops

    q = meta_dtensor(mesh, (2, 64, 4, 32), (Shard(0), Shard(3)))
    with pytest.raises(ValueError, match="heads-local"):
        ops.flash_prefill(q, q, q)
    qs = meta_dtensor(mesh, (2, 64, 4, 32), (Replicate(), Shard(1)))
    with pytest.raises(ValueError, match="heads-local"):
        ops.flash_prefill(qs, qs, qs)
    qd = meta_dtensor(mesh, (2, 4, 32), (Shard(0), Shard(2)))
    pages = meta_dtensor(mesh, (8, 16, 2, 32), (Replicate(), Shard(3)))
    table = torch.zeros(2, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="heads-local"):
        ops.paged_gqa_decode(qd, pages, pages, table,
                             torch.ones(2, dtype=torch.int32))


def test_meta_prefill_takes_the_plain_attention_by_argument():
    """On meta tensors prefill and decode take JAX's plain attention with
    no argument: a kernel wrapper would try to launch, and fail without a
    card."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    cfg = get_config("granite-3-2b").reduced()
    model = Model(cfg, device="meta")
    params = model.init()
    batch = {"tokens": torch.zeros((2, 64), dtype=torch.int32,
                                   device="meta")}
    logits, cache = model.prefill(params, batch, cache_len=80)
    assert logits.shape == (2, 1, cfg.vocab)
    tokens = torch.zeros((2, 1), dtype=torch.int32, device="meta")
    pos = torch.zeros((2,), dtype=torch.int32, device="meta")
    logits, _ = model.decode(params, cache, tokens, pos)
    assert logits.shape == (2, 1, cfg.vocab) and logits.is_meta


def test_meshes_refuse_a_world_of_another_size(mesh):
    """The fake group has 4 ranks: the production meshes and a debug mesh
    of another size raise, and so does the training launcher's --mesh."""
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh

    with pytest.raises(RuntimeError, match="256"):
        make_production_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="512"):
        make_production_mesh(multi_pod=True, device_type="cpu")
    with pytest.raises(RuntimeError, match="8 ranks"):
        make_debug_mesh((2, 4), device_type="cpu")
    assert make_debug_mesh((2, 2), device_type="cpu").shape == (2, 2)
    for flags in (["--mesh", "prod"], ["--mesh", "debug", "--mesh-shape",
                                       "1,1"]):
        with pytest.raises(RuntimeError, match="ranks"):
            train.run([*flags, "--device", "cpu", "--steps", "1"])
