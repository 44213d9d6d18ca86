"""The two-pass chunkwise mLSTM, on the CPU.

The tensor-core mLSTM kernel splits the chunk walk from the outputs: a
states pass hands every chunk its starting (C, n, m), and an outputs pass
computes all chunks' h at once from those states.  Its plain version,
``ref.mlstm_chunk_twopass_ref`` (``mlstm_states_pass_ref`` then
``mlstm_outputs_pass_ref``), is held here

* against the JAX package's Pallas ``mlstm_chunk_kernel`` in interpret
  mode, on the shapes of ``tests/test_kernels.py``;
* against ``ref.mlstm_chunk_ref`` and the per-step recurrence on h and the
  final state, from the empty and a given state, at ragged lengths and at
  S 1100 (more chunks than the states pass's ring), at hd 64, 128 and 256;
* its chunks' starting states against the states that ``mlstm_chunk_ref``
  hands on when it is run one chunk at a time;
* under extreme gates, against the per-step recurrence ``mlstm_forward`` of
  the JAX package and of the port.

Also the launcher's rules: ``mlstm_path``, the shared memory of both passes
against a Hopper block's 232,448 bytes, the grids, and the path override.

Tolerance: 2e-5 absolute and relative at float32, the tolerance of
``tests/test_kernels.py``.  The CUDA kernel itself needs the card:
``chip_smoke.py`` holds it against ``mlstm_chunk_ref`` there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import mlstm_chunk_kernel
from repro.models import ssm as jssm
from repro_torch.kernels import ref
from repro_torch.kernels.mlstm_chunk import (
    grids,
    mlstm_chunk,
    mlstm_path,
    smem_bytes,
)
from repro_torch.models import ssm

TOL = dict(atol=2e-5, rtol=2e-5)
#: shared memory one Hopper block may use (bytes)
BLOCK_SMEM = 232_448


def _np32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _inputs(seed, b, h, s, hd, state=False):
    """q, k, v, i_raw, log_f (and a state such as a prompt leaves behind)
    as float32 tensors, made from a numpy seed."""
    rng = np.random.default_rng(seed)
    q, k, v = (_np32(rng, b, h, s, hd) * 0.5 for _ in range(3))
    i_raw = _np32(rng, b, h, s) * 0.5
    log_f = -np.logaddexp(0.0, -(_np32(rng, b, h, s) * 0.5 + 2.0))
    args = [torch.from_numpy(a.astype(np.float32))
            for a in (q, k, v, i_raw, log_f)]
    st = None
    if state:
        st = (torch.from_numpy(_np32(rng, b, h, hd, hd) * 0.1),
              torch.from_numpy(_np32(rng, b, h, hd) * 0.1),
              torch.from_numpy(_np32(rng, b, h)))
    return args, st


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize(
    "b,h,s,hd,chunk",
    [
        (2, 2, 64, 32, 16),
        (1, 3, 128, 64, 32),
        (1, 1, 96, 128, 32),     # non-power-of-two chunk count
        (2, 1, 64, 256, 64),     # xlstm-350m head_dim, single chunk
    ],
)
def test_twopass_plain_matches_pallas(b, h, s, hd, chunk):
    args, _ = _inputs(4, b, h, s, hd)
    want = mlstm_chunk_kernel(*(jnp.asarray(a.numpy()) for a in args),
                              chunk=chunk, interpret=True)
    got, (c, n, m) = ref.mlstm_chunk_twopass_ref(*args, chunk=chunk)
    assert (c.shape, n.shape, m.shape) == ((b, h, hd, hd), (b, h, hd), (b, h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _recurrence(q, k, v, i_raw, log_f, state=None):
    """The per-step mLSTM recurrence (``tests/test_kernels.py::_mlstm_ref``
    with a state in and out), in float64."""
    q, k, v, i_raw, log_f = (x.double() for x in (q, k, v, i_raw, log_f))
    b, h, s, hd = q.shape
    if state is None:
        c = torch.zeros((b, h, hd, hd), dtype=torch.float64)
        n = torch.zeros((b, h, hd), dtype=torch.float64)
        m = torch.full((b, h), -1e30, dtype=torch.float64)
    else:
        c, n, m = (x.double() for x in state)
    outs = []
    for t in range(s):
        m_new = torch.maximum(log_f[:, :, t] + m, i_raw[:, :, t])
        alpha = torch.exp(log_f[:, :, t] + m - m_new)
        beta = torch.exp(i_raw[:, :, t] - m_new)
        kt = k[:, :, t] * hd ** -0.5
        c = (alpha[..., None, None] * c
             + beta[..., None, None] * kt[..., :, None] * v[:, :, t, None, :])
        n = alpha[..., None] * n + beta[..., None] * kt
        num = torch.einsum("bhk,bhkv->bhv", q[:, :, t], c)
        den = torch.maximum(torch.einsum("bhk,bhk->bh", q[:, :, t], n).abs(),
                            torch.exp(-m_new))
        outs.append(num / den[..., None])
        m = m_new
    return torch.stack(outs, dim=2).float(), tuple(x.float()
                                                   for x in (c, n, m))


@pytest.mark.parametrize("state", [False, True], ids=["empty", "given"])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("s", [37, 100, 257, 1100])
def test_twopass_matches_chunk_ref_and_recurrence(s, hd, state):
    """Ragged S (and S 1100, more chunks than the states pass's ring), from
    the empty and a given state: h and the final (C, n, m) of the two
    passes equal ``mlstm_chunk_ref``'s and the per-step recurrence's."""
    args, st = _inputs(s + hd, 1, 2, s, hd, state=state)
    want, want_st = ref.mlstm_chunk_ref(*args, st, chunk=64)
    got, got_st = ref.mlstm_chunk_twopass_ref(*args, st, chunk=64)
    rec, rec_st = _recurrence(*args, st)
    _close(got, want)
    _close(got, rec)
    for g, w, r in zip(got_st, want_st, rec_st):
        _close(g, w)
        _close(g, r)


@pytest.mark.parametrize("s,chunk", [(100, 64), (257, 64), (50, 16)])
def test_states_pass_starts_match_chunkwise_handoff(s, chunk):
    """Chunk j's starting state is what ``mlstm_chunk_ref`` hands on after
    chunks 0 .. j - 1, run one chunk at a time."""
    args, st = _inputs(7, 2, 2, s, 64, state=True)
    starts, final = ref.mlstm_states_pass_ref(*args[1:], st, chunk=chunk)
    nc = -(-s // chunk)
    assert starts[0].shape[2] == nc
    cur = st
    for j in range(nc):
        for start, want in zip(starts, cur):
            _close(start[:, :, j], want)
        sl = slice(j * chunk, (j + 1) * chunk)
        _, cur = ref.mlstm_chunk_ref(*(a[:, :, sl] for a in args), cur,
                                     chunk=chunk)
    for got, want in zip(final, cur):
        _close(got, want)


def _selector_params(h, hd):
    """mLSTM parameters under which x = [q | k | v | (i, f) per head]
    passes through the projections unchanged: wq, wk, wv, w_if and wo pick
    their columns of x, b_if is 0, so the gates are x's own."""
    hk = h * hd
    d = 3 * hk + 2 * h
    eye = np.eye(hk, dtype=np.float32).reshape(hk, h, hd)
    p = {name: np.zeros((d, h, hd), np.float32) for name in ("wq", "wk", "wv")}
    for i, name in enumerate(("wq", "wk", "wv")):
        p[name][i * hk:(i + 1) * hk] = eye
    p["w_if"] = np.zeros((d, h, 2), np.float32)
    for head in range(h):
        p["w_if"][3 * hk + 2 * head, head, 0] = 1.0
        p["w_if"][3 * hk + 2 * head + 1, head, 1] = 1.0
    p["b_if"] = np.zeros((h, 2), np.float32)
    p["wo"] = np.zeros((h, hd, d), np.float32)
    p["wo"][..., :hk] = eye.transpose(1, 2, 0).reshape(h, hd, hk)
    p["norm_w"] = np.ones((h, hd), np.float32)
    return p


def test_twopass_under_extreme_gates_matches_the_recurrence():
    """Input gates near +30 and forget gates with log f far below 0, from a
    given state: the two-pass form against the per-step recurrence
    ``mlstm_forward`` of the JAX package and of the port (their y, through
    the head norm, and their final state)."""
    b, h, s, hd = 1, 2, 100, 32
    rng = np.random.default_rng(11)
    q, k, v = (_np32(rng, b, s, h, hd) * 0.5 for _ in range(3))
    i_pre = 30.0 + _np32(rng, b, s, h)
    f_pre = -15.0 + 3.0 * _np32(rng, b, s, h)
    gates = np.stack([i_pre, f_pre], axis=-1).reshape(b, s, 2 * h)
    x = np.concatenate([a.reshape(b, s, h * hd) for a in (q, k, v)]
                       + [gates], axis=-1).astype(np.float32)
    st = (_np32(rng, b, h, hd, hd) * 0.1, _np32(rng, b, h, hd) * 0.1,
          _np32(rng, b, h))
    p = _selector_params(h, hd)

    y_j, st_j = jax.jit(jssm.mlstm_forward)(
        {kk: jnp.asarray(a) for kk, a in p.items()}, jnp.asarray(x),
        tuple(jnp.asarray(a) for a in st))
    tp = {kk: torch.from_numpy(a) for kk, a in p.items()}
    tst = tuple(torch.from_numpy(a) for a in st)
    y_t, st_t = ssm.mlstm_forward(tp, torch.from_numpy(x), tst)

    log_f = torch.nn.functional.logsigmoid(torch.from_numpy(f_pre))
    h_2p, st_2p = ref.mlstm_chunk_twopass_ref(
        *(torch.from_numpy(a).transpose(1, 2) for a in (q, k, v)),
        torch.from_numpy(i_pre).transpose(1, 2), log_f.transpose(1, 2),
        tst, chunk=64)
    y_2p = ssm._out(ssm.rms_head_norm(h_2p.transpose(1, 2), tp["norm_w"]),
                    tp["wo"])
    assert bool(torch.isfinite(h_2p).all())
    np.testing.assert_allclose(y_2p.numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(y_2p.numpy(), y_t.numpy(), **TOL)
    for got, want_j, want_t in zip(st_2p, st_j, st_t):
        np.testing.assert_allclose(got.numpy(), np.asarray(want_j), **TOL)
        _close(got, want_t)


@pytest.mark.parametrize("dtype,hd,chunk,path", [
    (torch.bfloat16, 256, 64, "tensor_core"),   # xlstm-350m's prefill
    (torch.bfloat16, 64, 64, "tensor_core"),
    (torch.bfloat16, 192, 64, "tensor_core"),
    (torch.float32, 256, 64, "cuda_core"),      # the f32 engines' parity
    (torch.bfloat16, 32, 64, "cuda_core"),      # hd not a multiple of 64
    (torch.bfloat16, 256, 32, "cuda_core"),     # another chunk
])
def test_mlstm_path(dtype, hd, chunk, path):
    assert mlstm_path(dtype, hd, chunk) == path


@pytest.mark.parametrize("hd", [64, 128, 256])
def test_both_passes_fit_a_hopper_block(hd):
    for kernel in ("states", "outputs", "cuda_core"):
        assert 0 < smem_bytes(hd, kernel=kernel) <= BLOCK_SMEM, kernel


def test_grids_at_xlstm_350m_prefill():
    """One prompt of 512 tokens, 4 heads of 256: 64 states blocks and 128
    outputs blocks, where the CUDA-core kernel has 16."""
    assert grids(1, 4, 512, 256, "tensor_core") == {"states": 64,
                                                     "outputs": 128}
    assert grids(1, 4, 512, 256, "cuda_core") == {"cuda_core": 16}


@pytest.mark.parametrize("dtype,path,chunk", [
    (torch.float32, "tensor_core", 64),   # the rule gives it cuda_core
    (torch.bfloat16, "wgmma", 64),        # no such path
    (torch.bfloat16, "tensor_core", 32),  # tensor core: 64-token chunks
])
def test_launcher_refuses_a_path_the_rule_does_not_give(dtype, path, chunk):
    """Checked before anything touches the device or the entry point."""
    def no_call(*_):
        raise AssertionError("the kernel entry point must not be reached")

    x = torch.zeros((1, 2, 64, 64), dtype=dtype)
    g = torch.zeros((1, 2, 64))
    with pytest.raises(ValueError, match="path"):
        mlstm_chunk(no_call, x, x, x, g, g, chunk=chunk, path=path)
