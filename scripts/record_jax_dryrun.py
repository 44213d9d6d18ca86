"""Write the record of the JAX dry-run that the port's dry-run is held to.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/record_jax_dryrun.py

On 8 forced host devices it lowers and compiles, through the JAX
package's ``build_dryrun`` -> ``lower_plan`` -> ``compile``, the five
reduced cases of ``tests/test_dryrun_machinery.py`` (``CASES``, reduced by
``reduce_cfg``), and records per case the mode, the per-device FLOPs and
collective bytes of ``hlo_analysis.total_stats`` and the per-device
argument bytes of ``memory_analysis``.  On a 1x1 mesh it compiles every
assigned arch x shape at the same reduction (``SIZES``: sequence and
batch per shape) and records the unsharded ``total_stats`` FLOPs, the
logical count the port's op analysis is compared with.  It writes
``tests/torch_dryrun_jax.json``, which ``tests/test_torch_dryrun.py``
reads: the port's tests never run JAX's compile themselves.

The module's constants and ``reduce_cfg`` import nothing of JAX, so the
port's tests import them from here.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RECORD = ROOT / "tests" / "torch_dryrun_jax.json"

#: (arch, shape, seq, batch, mesh shape, mesh axes, optimized), as in
#: tests/test_dryrun_machinery.py
CASES = [
    ("granite-3-2b", "train_4k", 256, 8, (2, 4), ("data", "model"), False),
    ("mixtral-8x7b", "decode_32k", 512, 8, (2, 4), ("data", "model"), False),
    ("zamba2-2.7b", "long_500k", 2048, 1, (2, 4), ("data", "model"), False),
    ("whisper-tiny", "prefill_32k", 512, 4, (2, 2, 2),
     ("pod", "data", "model"), False),
    ("granite-3-2b", "decode_32k", 512, 8, (2, 4), ("data", "model"), True),
]

#: shape -> (seq, batch) of the unsharded records
SIZES = {"train_4k": (256, 8), "prefill_32k": (512, 4),
         "decode_32k": (512, 8), "long_500k": (2048, 1)}


def case_key(arch, shape, mshape, opt) -> str:
    return f"{arch}|{shape}|{'x'.join(map(str, mshape))}|opt={opt}"


def reduce_cfg(cfg0):
    """The reduction of tests/test_dryrun_machinery.py (either package's
    ``ModelConfig``)."""
    return dataclasses.replace(
        cfg0, n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
        head_dim=64, d_ff=512 if cfg0.d_ff else 0, max_position=8192,
        n_enc_layers=2 if cfg0.n_enc_layers else 0,
        n_audio_frames=16 if cfg0.n_enc_layers else 1500,
        sliding_window=256 if cfg0.sliding_window else 0,
        attn_every=min(cfg0.attn_every, 2) if cfg0.attn_every else 0,
        n_experts=min(cfg0.n_experts, 4) if cfg0.n_experts else 0,
        top_k=min(cfg0.top_k, 2) if cfg0.top_k else 0,
        ssm_state=min(cfg0.ssm_state, 16) if cfg0.ssm_state else 0,
        dtype="float32",
    )


def build_record() -> dict:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from repro.configs import ASSIGNED_ARCHS, get_config, supports_shape
    from repro.launch.hlo_analysis import total_stats
    from repro.launch.specs import build_dryrun, lower_plan

    def compile_case(arch, shape, seq, b, mshape, axes, opt):
        cfg = reduce_cfg(get_config(arch, shape=shape))
        n = int(np.prod(mshape))
        mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(mshape), axes)
        plan = build_dryrun(arch, shape, mesh, batch_override=b,
                            cfg_override=cfg, seq_override=seq,
                            optimized=opt)
        compiled = lower_plan(plan, mesh).compile()
        return plan, compiled, total_stats(compiled.as_text())

    cases = {}
    for case in CASES:
        plan, compiled, st = compile_case(*case)
        key = case_key(case[0], case[1], case[4], case[6])
        cases[key] = {
            "mode": plan.mode,
            "flops": st.flops,
            "coll_bytes": st.coll_bytes,
            "args": compiled.memory_analysis().argument_size_in_bytes,
        }
        print("case", key, cases[key], flush=True)
    unsharded = {}
    for arch in ASSIGNED_ARCHS:
        for shape, (seq, b) in SIZES.items():
            if not supports_shape(arch, shape):
                continue
            _, _, st = compile_case(arch, shape, seq, b, (1, 1),
                                    ("data", "model"), False)
            unsharded[f"{arch}|{shape}"] = st.flops
            print("unsharded", arch, shape, st.flops, flush=True)
    return {"cases": cases, "unsharded_flops": unsharded}


def main() -> None:
    if "jax" in sys.modules:
        raise RuntimeError("run this script in a fresh process: it sets "
                           "XLA_FLAGS before importing jax")
    RECORD.write_text(json.dumps(build_record(), indent=1, sort_keys=True)
                      + "\n")
    print(f"wrote {RECORD}")


if __name__ == "__main__":
    main()
