"""The port's Mamba2 mixer (``repro_torch.models.ssm``) against the JAX
package's (CPU, float32).

Parameters come from the JAX ``init_mamba2`` (with a seeded step bias and
conv bias, so that neither is zero) through ``params_from_jax``; inputs,
states and conv states are drawn from a numpy seed.  Compared within
2e-5: the per-step form ``mamba2_forward``, the chunkwise form
``mamba2_forward_chunked`` at an S that the chunk divides and one it does
not, from the zero state and from a given state and conv state, and
``mamba2_decode`` continuing a chunked prefill token by token (output,
final state and conv state each).  ``init_mamba2``'s layout and dtypes
equal JAX's, the decay logs, step biases, skip and norm scales float32 at
bfloat16 weights, and a bfloat16 bridge keeps them float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jax_ssm
from repro_torch.models import ssm
from repro_torch.models.params import params_from_jax

TOL = dict(atol=2e-5, rtol=2e-5)
D_MODEL, D_STATE, CONV = 128, 16, 4
#: Mamba2's float32 leaves whatever the weights' dtype
F32_LEAVES = ("a_log", "dt_bias", "d_skip", "norm_w")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    jp = jax.tree.map(np.asarray, jax_ssm.init_mamba2(
        jax.random.PRNGKey(0), D_MODEL, D_STATE, CONV, jnp.float32))
    rng = np.random.default_rng(7)
    jp["dt_bias"] = (rng.standard_normal(jp["dt_bias"].shape) * 0.5).astype(
        np.float32)
    jp["conv_b"] = (rng.standard_normal(jp["conv_b"].shape) * 0.1).astype(
        np.float32)
    return jp, params_from_jax(jp, "cpu")


def _inputs(seed, b, s, with_state):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, D_MODEL)).astype(np.float32)
    if not with_state:
        return x, None, None
    d_inner, p, h, n = ssm.mamba2_dims(D_MODEL, D_STATE)
    st = (rng.standard_normal((b, h, p, n)) * 0.1).astype(np.float32)
    conv = rng.standard_normal((b, CONV - 1, d_inner + 2 * n)).astype(
        np.float32)
    return x, st, conv


def _run(fn_jax, fn_torch, jp, tp, x, st, conv, **kw):
    tj = (lambda a: None if a is None else jnp.asarray(a))
    tt = (lambda a: None if a is None else torch.from_numpy(a))
    yj, (hj, cj) = fn_jax(jp, tj(x), tj(st), tj(conv), **kw)
    yt, (ht, ct) = fn_torch(tp, tt(x), tt(st), tt(conv), **kw)
    for got, want, name in ((yt, yj, "y"), (ht, hj, "state"),
                            (ct, cj, "conv state")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=name)
    return yt, (ht, ct)


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["zero_state", "given_state"])
def test_forward_matches_jax(params, with_state):
    jp, tp = params
    x, st, conv = _inputs(1, 2, 24, with_state)
    _run(jax_ssm.mamba2_forward, ssm.mamba2_forward, jp, tp, x, st, conv)


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["zero_state", "given_state"])
@pytest.mark.parametrize("s,chunk", [(64, 16), (70, 16), (45, 512)],
                         ids=["divisible", "snapped", "one_chunk"])
def test_chunked_matches_jax(params, s, chunk, with_state):
    """S 64 in chunks of 16, S 70 (JAX's rule snaps the chunk to 14) and
    S 45 in one chunk; the chunked form also equals the per-step form."""
    jp, tp = params
    x, st, conv = _inputs(s, 2, s, with_state)
    yt, (ht, _) = _run(jax_ssm.mamba2_forward_chunked,
                       ssm.mamba2_forward_chunked, jp, tp, x, st, conv,
                       chunk=chunk)
    ys, (hs, _) = ssm.mamba2_forward(
        tp, torch.from_numpy(x), None if st is None else torch.from_numpy(st),
        None if conv is None else torch.from_numpy(conv))
    torch.testing.assert_close(yt, ys, **TOL)
    torch.testing.assert_close(ht, hs, **TOL)


def test_decode_continues_chunked_prefill(params):
    """A 40-token chunked prefill, then 6 decode tokens one at a time from
    its state and conv state, against JAX's chain; the chain equals the
    per-step form over all 46 tokens."""
    jp, tp = params
    x, _, _ = _inputs(3, 2, 46, False)
    _, (ht, ct) = _run(jax_ssm.mamba2_forward_chunked,
                       ssm.mamba2_forward_chunked, jp, tp, x[:, :40], None,
                       None, chunk=16)
    hj, cj = ht.numpy(), ct.numpy()
    ys = []
    for t in range(40, 46):
        x1 = x[:, t:t + 1]
        yj, (hj, cj) = jax_ssm.mamba2_decode(jp, jnp.asarray(x1),
                                             jnp.asarray(hj), jnp.asarray(cj))
        yt, (ht, ct) = ssm.mamba2_decode(tp, torch.from_numpy(x1), ht, ct)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **TOL)
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **TOL)
        ys.append(yt)
    whole, (h_all, _) = ssm.mamba2_forward(tp, torch.from_numpy(x))
    torch.testing.assert_close(torch.cat(ys, dim=1), whole[:, 40:], **TOL)
    torch.testing.assert_close(ht, h_all, **TOL)


def test_init_state_matches_jax(params):
    jp, tp = params
    want = jax_ssm.mamba2_init_state(jp, 3, D_MODEL)
    got = ssm.mamba2_init_state(tp, 3, D_MODEL)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        assert not bool(g.any())


def test_init_layout_and_f32_leaves_match_jax():
    """``init_mamba2`` at bfloat16 weights builds JAX's keys, shapes and
    dtypes, with a stacked leading shape too; a bfloat16 bridge of JAX's
    float32 tree keeps the float32 leaves."""
    want = jax_ssm.init_mamba2(jax.random.PRNGKey(0), D_MODEL, D_STATE,
                               CONV, jnp.bfloat16)
    gen = torch.Generator().manual_seed(0)
    got = ssm.init_mamba2(gen, D_MODEL, D_STATE, CONV, torch.bfloat16,
                          "cpu", lead=(2, 3))
    assert set(got) == set(want)
    for key, w in want.items():
        assert tuple(got[key].shape) == (2, 3, *w.shape), key
        assert str(got[key].dtype).split(".")[-1] == str(w.dtype), key
    for key in F32_LEAVES:
        assert got[key].dtype == torch.float32
    torch.testing.assert_close(
        got["a_log"][1, 2], torch.from_numpy(np.array(want["a_log"])))
    f32 = jax.tree.map(np.asarray, jax_ssm.init_mamba2(
        jax.random.PRNGKey(0), D_MODEL, D_STATE, CONV, jnp.float32))
    bridged = params_from_jax({"mamba": f32}, "cpu", torch.bfloat16)["mamba"]
    assert {k: v.dtype for k, v in bridged.items()} == \
        {k: got[k].dtype for k in got}
