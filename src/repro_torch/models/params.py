"""Parameter bridge: the JAX package's parameter tree -> the port's tensors.

Torch cannot reproduce JAX's PRNG, so the parity tests build parameters
with the JAX ``Model.init``, pull them to numpy, and hand them here.  The
port keeps the JAX pytree's layout key for key (layer-stacked ``(L, ...)``
leaves included), so the bridge is a copy.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

#: leaves that ``Model.init`` keeps in float32 whatever the compute dtype:
#: the norm scales, and the xLSTM gate projections, gate biases and
#: per-head norm scales
F32_KEYS = frozenset(
    {"ln1", "ln2", "ln_x", "ln_m", "ln_s", "ln", "final_norm",
     "enc_final_norm", "w_if", "b_if", "norm_w"}
)
#: (parent, leaf) pairs kept in float32: the sLSTM's recurrent matrices and
#: bias (names too short to be unambiguous on their own)
F32_PATHS = frozenset({("slstm", "r"), ("slstm", "b")})


def _keeps_f32(path: tuple) -> bool:
    return bool(path) and (path[-1] in F32_KEYS or path[-2:] in F32_PATHS)


def _to_tensor(arr, device, dtype: Optional[torch.dtype], path: tuple):
    arr = np.asarray(arr)
    # numpy has no bfloat16: JAX hands out ml_dtypes' bfloat16, which widens
    # exactly to float32 and narrows back exactly
    bf16 = arr.dtype.name == "bfloat16"
    t = torch.from_numpy(np.array(arr, dtype=np.float32 if bf16 else None))
    if bf16:
        t = t.to(torch.bfloat16)
    if dtype is not None and t.is_floating_point() and not _keeps_f32(path):
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(tree: Any, device, dtype: Optional[torch.dtype] = None,
                    _path: tuple = ()) -> Any:
    """Copy a (nested dict) tree of numpy arrays into torch tensors on
    ``device``.  ``dtype``, when given, is the weights' dtype; the leaves
    that the JAX ``Model.init`` keeps in float32 (``F32_KEYS``,
    ``F32_PATHS``) stay float32.  With ``dtype=None`` every leaf keeps its
    own dtype."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype, _path + (k,))
                for k, v in tree.items()}
    return _to_tensor(tree, device, dtype, _path)
