#!/usr/bin/env python3
"""Compare the SASS of two trees' CUDA kernels, function by function.

    python3 scripts/sass_diff.py OLD_TREE NEW_TREE [SOURCE ...]

Builds each named source (default: flash_attention.cu and mlstm_chunk.cu)
of both trees' ``src/repro_torch/kernels/csrc`` with the port's own nvcc
flags into ``build/sass_diff/``, disassembles the libraries with
``cuobjdump -sass`` and holds every kernel function that both trees have
against the other's, instruction by instruction.  Functions are matched by
their demangled name up to the parameter list (``flash_tc_kernel<64, 4>``),
which masks the hash and path that nvcc puts into an anonymous namespace's
mangled name and a change of the parameter list.  Prints one line per
function (``same``, ``DIFFERS`` or only in one tree) and exits 1 when a
function of both trees differs.  Needs nvcc and cuobjdump: run it on the
machine with the card.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import ops  # noqa: E402

DEFAULT_SOURCES = ("flash_attention.cu", "mlstm_chunk.cu")


def _tool(name: str) -> str:
    found = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not Path(found).is_file():
        raise SystemExit(f"sass_diff: {name} not found")
    return found


def build(tree: Path, source: str, out: Path) -> Path:
    out.mkdir(parents=True, exist_ok=True)
    lib = out / (Path(source).stem + ".so")
    src = tree / "src" / "repro_torch" / "kernels" / "csrc" / source
    subprocess.run([ops._nvcc(), *ops.NVCC_FLAGS, "-o", str(lib), str(src)],
                   check=True, capture_output=True, text=True)
    return lib


def functions(lib: Path) -> dict:
    """{demangled name up to its parameters: [instruction lines]}"""
    sass = subprocess.run([_tool("cuobjdump"), "-sass", str(lib)],
                          check=True, capture_output=True, text=True).stdout
    bodies, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            bodies[name] = []
        elif name is not None and line.strip():
            bodies[name].append(line.strip())
    names = list(bodies)
    shown = subprocess.run([_tool("c++filt")], input="\n".join(names),
                           check=True, capture_output=True,
                           text=True).stdout.splitlines()
    return {short.replace("(anonymous namespace)", "").split("(", 1)[0]:
            bodies[n] for short, n in zip(shown, names)}


def main(argv: list) -> int:
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    old, new = (Path(a).resolve() for a in argv[:2])
    sources = argv[2:] or DEFAULT_SOURCES
    out = ROOT / "build" / "sass_diff"
    differs = 0
    for source in sources:
        a = functions(build(old, source, out / "old"))
        b = functions(build(new, source, out / "new"))
        for fn in sorted(set(a) | set(b)):
            if fn not in b:
                verdict = "only in the old tree"
            elif fn not in a:
                verdict = f"only in the new tree ({len(b[fn])} lines)"
            elif a[fn] == b[fn]:
                verdict = f"same ({len(a[fn])} lines)"
            else:
                differs += 1
                verdict = "DIFFERS"
            print(f"{source}: {fn}: {verdict}", flush=True)
    return 1 if differs else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
