"""The port's xLSTM mixers (``repro_torch.models.ssm``) against the JAX
package's (``repro.models.ssm``) on the same seeded inputs and bridged
parameters, on the CPU at float32.

Tolerance: 2e-5 absolute and relative on outputs and states.  The chunkwise
mLSTM runs through ``ops.mlstm_chunk``'s plain version with the port's
64-token chunk and a masked last chunk, while the JAX function picks a chunk
that divides S (S itself up to 256, so 257 tokens are one chunk there and
five here): the two agree to rounding, not bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.kernels import ops
from repro_torch.models import ssm
from repro_torch.models.params import params_from_jax

D, H, HD, B = 64, 2, 32, 2
TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny tensors: one intra-op thread per test worker is faster and
    keeps the workers from oversubscribing the cores.  Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mlstm_params():
    jp = jssm.init_mlstm(jax.random.PRNGKey(0), D, H, HD, jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def slstm_params():
    jp = jssm.init_slstm(jax.random.PRNGKey(1), D, H, HD, jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _x(seed, s, b=B):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, D)) * 0.5).astype(np.float32)


def _mlstm_state(seed):
    """A nonzero state such as a prompt leaves behind."""
    rng = np.random.default_rng(seed)
    return (
        (rng.standard_normal((B, H, HD, HD)) * 0.1).astype(np.float32),
        (rng.standard_normal((B, H, HD)) * 0.1).astype(np.float32),
        rng.standard_normal((B, H)).astype(np.float32),
    )


def _slstm_state(seed):
    rng = np.random.default_rng(seed)
    c, h = (rng.standard_normal((2, B, H, HD)) * 0.5).astype(np.float32)
    n = rng.uniform(0.5, 2.0, (B, H, HD)).astype(np.float32)
    m = rng.standard_normal((B, H, HD)).astype(np.float32)
    return c, n, h, m


def _t(arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def _j(arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("s", [37, 64, 100, 257])
def test_mlstm_forward_chunked_matches_jax(mlstm_params, s):
    """From a nonzero state, S ragged or whole in the port's chunks: y and
    the final (C, n, m) agree with JAX's."""
    jp, tp = mlstm_params
    x = _x(s, s)
    st = _mlstm_state(s)
    yj, sj = jax.jit(jssm.mlstm_forward_chunked)(jp, jnp.asarray(x), _j(st))
    ops.reset_launch_counts()
    yt, stt = ssm.mlstm_forward_chunked(tp, torch.from_numpy(x), _t(st))
    assert ops.mlstm_chunk.launches == 0   # CPU tensors: the plain version
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    _close(stt, sj)


def test_mlstm_forward_chunked_from_empty_state(mlstm_params):
    jp, tp = mlstm_params
    x = _x(5, 80)
    yj, sj = jax.jit(jssm.mlstm_forward_chunked)(jp, jnp.asarray(x))
    yt, stt = ssm.mlstm_forward_chunked(tp, torch.from_numpy(x))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    _close(stt, sj)


def test_mlstm_recurrent_forms_match_jax(mlstm_params):
    """The per-step recurrence, and the chunkwise form against it."""
    jp, tp = mlstm_params
    x = _x(6, 45)
    st = _mlstm_state(6)
    yj, sj = jax.jit(jssm.mlstm_forward)(jp, jnp.asarray(x), _j(st))
    yt, stt = ssm.mlstm_forward(tp, torch.from_numpy(x), _t(st))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    _close(stt, sj)
    yc, stc = ssm.mlstm_forward_chunked(tp, torch.from_numpy(x), _t(st))
    np.testing.assert_allclose(yc.numpy(), yt.numpy(), **TOL)
    _close(stc, [t.numpy() for t in stt])


def test_mlstm_decode_matches_jax_and_continues_forward(mlstm_params):
    jp, tp = mlstm_params
    x = _x(7, 11)
    st = _mlstm_state(7)
    yj, sj = jax.jit(jssm.mlstm_decode)(jp, jnp.asarray(x[:, :1]), _j(st))
    yt, stt = ssm.mlstm_decode(tp, torch.from_numpy(x[:, :1]), _t(st))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    _close(stt, sj)
    # prefill 10 tokens chunkwise, decode the 11th: the 11th output of the
    # whole-sequence recurrence
    y_all, _ = ssm.mlstm_forward(tp, torch.from_numpy(x))
    _, st10 = ssm.mlstm_forward_chunked(tp, torch.from_numpy(x[:, :10]))
    y_last, _ = ssm.mlstm_decode(tp, torch.from_numpy(x[:, 10:11]), st10)
    np.testing.assert_allclose(y_last[:, 0].numpy(), y_all[:, 10].numpy(),
                               **TOL)


@pytest.mark.parametrize("with_state", [False, True], ids=["empty", "state"])
def test_slstm_forward_matches_jax(slstm_params, with_state):
    jp, tp = slstm_params
    x = _x(8, 29)
    st = _slstm_state(8) if with_state else None
    yj, sj = jax.jit(jssm.slstm_forward)(
        jp, jnp.asarray(x), None if st is None else _j(st))
    yt, stt = ssm.slstm_forward(tp, torch.from_numpy(x),
                                None if st is None else _t(st))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    _close(stt, sj)


def test_slstm_decode_matches_jax_and_continues_forward(slstm_params):
    jp, tp = slstm_params
    x = _x(9, 11)
    st = _slstm_state(9)
    yj, sj = jax.jit(jssm.slstm_decode)(jp, jnp.asarray(x[:, :1]), _j(st))
    yt, stt = ssm.slstm_decode(tp, torch.from_numpy(x[:, :1]), _t(st))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    _close(stt, sj)
    y_all, _ = ssm.slstm_forward(tp, torch.from_numpy(x))
    _, st10 = ssm.slstm_forward(tp, torch.from_numpy(x[:, :10]))
    y_last, _ = ssm.slstm_decode(tp, torch.from_numpy(x[:, 10:11]), st10)
    np.testing.assert_allclose(y_last[:, 0].numpy(), y_all[:, 10].numpy(),
                               **TOL)


@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_init_layouts_match_jax(block):
    """``init_mlstm``/``init_slstm`` at bfloat16 build JAX's keys, shapes
    and per-leaf dtypes (gates, biases, recurrent matrices and head norms
    float32)."""
    jinit, init = getattr(jssm, f"init_{block}"), getattr(ssm, f"init_{block}")
    jp = jinit(jax.random.PRNGKey(0), D, H, HD, jnp.bfloat16)
    mine = init(torch.Generator().manual_seed(0), D, H, HD, torch.bfloat16)
    assert set(mine) == set(jp)
    for key, leaf in mine.items():
        assert tuple(leaf.shape) == jp[key].shape, key
        assert str(leaf.dtype).split(".")[-1] == jp[key].dtype.name, key


def test_rms_head_norm_matches_jax():
    rng = np.random.default_rng(10)
    h = rng.standard_normal((B, 5, H, HD)).astype(np.float32)
    w = rng.standard_normal((H, HD)).astype(np.float32)
    got = ssm.rms_head_norm(torch.from_numpy(h), torch.from_numpy(w))
    want = jssm.rms_head_norm(jnp.asarray(h), jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
