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

#: norm scales: kept in float32 whatever the compute dtype, as Model.init
#: makes them
NORM_KEYS = frozenset(
    {"ln1", "ln2", "ln_x", "ln_m", "ln_s", "ln", "final_norm",
     "enc_final_norm"}
)


def _to_tensor(arr, device, dtype: Optional[torch.dtype], key: str):
    arr = np.asarray(arr)
    # numpy has no bfloat16: JAX hands out ml_dtypes' bfloat16, which widens
    # exactly to float32 and narrows back exactly
    bf16 = arr.dtype.name == "bfloat16"
    t = torch.from_numpy(np.array(arr, dtype=np.float32 if bf16 else None))
    if bf16:
        t = t.to(torch.bfloat16)
    if dtype is not None and t.is_floating_point() and key not in NORM_KEYS:
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(tree: Any, device, dtype: Optional[torch.dtype] = None,
                    _key: str = "") -> Any:
    """Copy a (nested dict) tree of numpy arrays into torch tensors on
    ``device``.  ``dtype``, when given, is the weights' dtype; norm scales
    stay float32.  With ``dtype=None`` every leaf keeps its own dtype."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype, k)
                for k, v in tree.items()}
    return _to_tensor(tree, device, dtype, _key)
