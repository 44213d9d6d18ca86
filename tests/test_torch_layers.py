"""Parity of the port's dense layers (``repro_torch.models.layers``) with
their JAX twins (``repro.models.layers``) on the same seeded numpy inputs.

Tolerance: 1e-5 absolute and relative at float32.  Both sides compute in
f32; the sums run in other orders in XLA and PyTorch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.models import layers as tl

TOL = dict(atol=1e-5, rtol=1e-5)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(arr):
    return jnp.asarray(arr), torch.from_numpy(np.array(arr))


def _close(j, t):
    np.testing.assert_allclose(np.asarray(j), t.detach().numpy(), **TOL)


def test_rms_norm():
    rng = np.random.default_rng(0)
    xj, xt = _both(_rand(rng, 2, 5, 32))
    wj, wt = _both(_rand(rng, 32))
    _close(jl.rms_norm(xj, wj, 1e-5), tl.rms_norm(xt, wt, 1e-5))


@pytest.mark.parametrize("hd,theta", [(32, 1e4), (64, 5e5)])
def test_rope(hd, theta):
    rng = np.random.default_rng(1)
    _close(jl.rope_freqs(hd, theta), tl.rope_freqs(hd, theta))
    xj, xt = _both(_rand(rng, 2, 7, 3, hd))
    pos = rng.integers(0, 300, (2, 7)).astype(np.int32)
    pj, pt = _both(pos)
    _close(jl.apply_rope(xj, pj, theta), tl.apply_rope(xt, pt, theta))


def _attn_inputs(rng, b, s, t, nh, nkv, hd):
    q = _rand(rng, b, s, nh, hd)
    k = _rand(rng, b, t, nkv, hd)
    v = _rand(rng, b, t, nkv, hd)
    return _both(q), _both(k), _both(v)


ATTN_CASES = {
    "causal": dict(),
    "window": dict(window=5),
    "offset": dict(causal_offset=3),
    "cache_masks": "cache",
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
@pytest.mark.parametrize("nh,nkv", [(4, 2), (4, 1), (4, 4)])
def test_gqa_attention(case, nh, nkv):
    rng = np.random.default_rng(2)
    b, hd = 2, 32
    kw = ATTN_CASES[case]
    if kw == "cache":
        s, t = 3, 24
        (qj, qt), (kj, kt), (vj, vt) = _attn_inputs(rng, b, s, t, nh, nkv, hd)
        kvp = np.where(rng.random((b, t)) < 0.7,
                       rng.integers(0, 30, (b, t)), -1).astype(np.int32)
        qpos = rng.integers(10, 30, (b, s)).astype(np.int32)
        (kpj, kpt), (qpj, qpt) = _both(kvp), _both(qpos)
        out_j = jl.gqa_attention(qj, kj, vj, q_positions=qpj,
                                 kv_positions=kpj, kv_valid=kpj >= 0,
                                 window=8)
        out_t = tl.gqa_attention(qt, kt, vt, q_positions=qpt,
                                 kv_positions=kpt, kv_valid=kpt >= 0,
                                 window=8)
    else:
        s = t = 12
        (qj, qt), (kj, kt), (vj, vt) = _attn_inputs(rng, b, s, t, nh, nkv, hd)
        out_j = jl.gqa_attention(qj, kj, vj, **kw)
        out_t = tl.gqa_attention(qt, kt, vt, **kw)
    _close(out_j, out_t)


@pytest.mark.parametrize("window", [0, 7])
def test_chunked_gqa_attention(window):
    rng = np.random.default_rng(3)
    b, s, t, nh, nkv, hd = 2, 24, 40, 4, 2, 32
    (qj, qt), (kj, kt), (vj, vt) = _attn_inputs(rng, b, s, t, nh, nkv, hd)
    kvp = np.tile(np.arange(t, dtype=np.int32), (b, 1))
    kvp[1, 30:] = -1
    qpos = (np.arange(s, dtype=np.int32) + 10)[None].repeat(b, 0)
    (kpj, kpt), (qpj, qpt) = _both(kvp), _both(qpos)
    kw_j = dict(window=window, q_positions=qpj, kv_positions=kpj,
                kv_valid=kpj >= 0, chunk_q=8, chunk_k=16)
    kw_t = dict(window=window, q_positions=qpt, kv_positions=kpt,
                kv_valid=kpt >= 0, chunk_q=8, chunk_k=16)
    _close(jl.chunked_gqa_attention(qj, kj, vj, **kw_j),
           tl.chunked_gqa_attention(qt, kt, vt, **kw_t))


@pytest.mark.parametrize("threshold", [2048, 8])
def test_attention_any_dispatch(threshold):
    """Both sides of the S*T threshold (a tiny threshold forces the chunked
    loop)."""
    rng = np.random.default_rng(4)
    (qj, qt), (kj, kt), (vj, vt) = _attn_inputs(rng, 1, 16, 16, 4, 2, 32)
    _close(jl.attention_any(qj, kj, vj, full_threshold=threshold),
           tl.attention_any(qt, kt, vt, full_threshold=threshold))


@pytest.mark.parametrize("use_rope", [True, False])
def test_attention_projections(use_rope):
    rng = np.random.default_rng(5)
    d, nh, nkv, hd = 64, 4, 2, 16
    p = {"wq": _rand(rng, d, nh, hd, scale=d ** -0.5),
         "wk": _rand(rng, d, nkv, hd, scale=d ** -0.5),
         "wv": _rand(rng, d, nkv, hd, scale=d ** -0.5),
         "wo": _rand(rng, nh, hd, d, scale=d ** -0.5)}
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    xj, xt = _both(_rand(rng, 2, 5, d))
    pos = np.tile(np.arange(5, dtype=np.int32), (2, 1))
    posj, post = _both(pos)
    for a, b in zip(jl.attention_qkv(pj, xj, posj, 1e4, use_rope),
                    tl.attention_qkv(pt, xt, post, 1e4, use_rope)):
        _close(a, b)
    oj, ot = _both(_rand(rng, 2, 5, nh, hd))
    _close(jl.attention_out(pj, oj), tl.attention_out(pt, ot))


def test_gated_mlp():
    rng = np.random.default_rng(6)
    d, f = 64, 128
    p = {"w1": _rand(rng, d, f, scale=d ** -0.5),
         "w3": _rand(rng, d, f, scale=d ** -0.5),
         "w2": _rand(rng, f, d, scale=f ** -0.5)}
    xj, xt = _both(_rand(rng, 2, 5, d))
    _close(jl.gated_mlp({k: jnp.asarray(v) for k, v in p.items()}, xj),
           tl.gated_mlp({k: torch.from_numpy(v) for k, v in p.items()}, xt))
