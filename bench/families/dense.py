"""The dense GQA family: what the benchmark needs to run a configuration of
it, found by the configuration file's ``"family": "dense"``.

* ``port_fields``: the port's ``ModelConfig`` fields that the file's sizes
  set (Hugging Face key names in, the port's names out), which the
  harness holds against the port's registry entry;
* ``params``: random weights made on the device from the run's seed, in
  the port's parameter layout (a dict of layer-stacked ``(L, ...)``
  tensors, as ``repro_torch``'s ``Model.init`` returns);
* ``prefill_flops``, ``decode_flops``: the useful FLOPs of one prompt and
  of one decode token (``roofline.py``).

The benchmark makes the weights, not the program, so that the plain
reference (``reference/dense.py``) is handed the very tensors the program
serves with.  Each stacked leaf is drawn by one ``torch.randn`` call of a
generator on the device, in the type it is served in, and scaled in
place: a few large calls, nothing on the host.  The scales are those of
the port's ``Model.init``.
"""

from __future__ import annotations

import torch

from roofline import decode_flops, prefill_flops  # noqa: F401


def port_fields(cfg: dict) -> dict:
    """The port's ``ModelConfig`` fields of ``cfg`` (a benchmark
    configuration, Hugging Face key names)."""
    d, nh = int(cfg["hidden_size"]), int(cfg["num_attention_heads"])
    return dict(
        n_layers=int(cfg["num_hidden_layers"]), d_model=d, n_heads=nh,
        n_kv_heads=int(cfg["num_key_value_heads"]),
        d_ff=int(cfg["intermediate_size"]), vocab=int(cfg["vocab_size"]),
        head_dim=d // nh, rope_theta=float(cfg["rope_theta"]),
        sliding_window=int(cfg.get("sliding_window") or 0),
        norm_eps=float(cfg["rms_norm_eps"]),
        tie_embeddings=bool(cfg.get("tie_word_embeddings")),
        dtype=cfg["dtype"],
    )


def params(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """``cfg``: a benchmark configuration (Hugging Face key names)."""
    d, f = int(cfg["hidden_size"]), int(cfg["intermediate_size"])
    n_layers, vocab = int(cfg["num_hidden_layers"]), int(cfg["vocab_size"])
    nh, n_kv = int(cfg["num_attention_heads"]), int(
        cfg["num_key_value_heads"])
    hd = d // nh
    gen = torch.Generator(device=device).manual_seed(int(seed))

    def normal(shape, scale):
        out = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        return out.mul_(scale)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    params = {
        "embed": normal((vocab, d), 0.02),
        "final_norm": ones(d),
        "blocks": {
            "ln1": ones(n_layers, d),
            "attn": {
                "wq": normal((n_layers, d, nh, hd), d ** -0.5),
                "wk": normal((n_layers, d, n_kv, hd), d ** -0.5),
                "wv": normal((n_layers, d, n_kv, hd), d ** -0.5),
                "wo": normal((n_layers, nh, hd, d), d ** -0.5),
            },
            "ln2": ones(n_layers, d),
            "mlp": {
                "w1": normal((n_layers, d, f), d ** -0.5),
                "w3": normal((n_layers, d, f), d ** -0.5),
                "w2": normal((n_layers, f, d), f ** -0.5),
            },
        },
    }
    if not cfg.get("tie_word_embeddings"):
        params["lm_head"] = normal((d, vocab), d ** -0.5)
    return params
