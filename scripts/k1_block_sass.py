#!/usr/bin/env python3
"""Whether the kernels of ``amcpy_tpu_torch/csrc/features.cu`` compile to
the same machine code as those of another version of that source.

    python3 scripts/k1_block_sass.py REFERENCE.cu [--work DIR]

Builds the package's source and ``REFERENCE.cu`` with the package's nvcc
flags, lists each library's SASS with ``cuobjdump -sass`` and compares, by
name, every function the two define: equal listings (instructions and
their encodings), different ones, and functions that only one defines (a
new kernel, or a device function that was not inlined). Prints one JSON
line and exits 1 if a function of both differs. Needs nvcc and cuobjdump
(the CUDA toolkit), not a card.

Example: the block route of K1 (``fused_kernel``) and K2 against the
parent commit's source, unpacked with ``git archive``.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


#: the anonymous namespace of a mangled name, which carries a hash of the
#: source's path: ``_ZN44_GLOBAL__N__fb0c68f9_11_features_cu_2c109583...``
_ANON = re.compile(r"\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}")


def sass_functions(lib: Path, cuobjdump: Path) -> dict[str, list[str]]:
    """{mangled function name, its anonymous namespace as ``(anon)``: its
    SASS lines} of a built library."""
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    funcs: dict[str, list[str]] = {}
    name = None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = _ANON.sub("(anon)", m.group(1))
            funcs[name] = []
        elif name is not None and line.strip():
            funcs[name].append(line.strip())
    return funcs


def build(source: Path, out_dir: Path) -> Path:
    from amcpy_tpu_torch.ops import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libfeatures.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(source)],
                   check=True, capture_output=True, text=True)
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("reference", type=Path)
    ap.add_argument("--work", type=Path, default=ROOT / "build" / "k1_block_sass")
    args = ap.parse_args()
    from amcpy_tpu_torch.ops import _build

    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    ref = sass_functions(build(args.reference, args.work / "reference"), cuobjdump)
    new = sass_functions(build(_build.CSRC / "features.cu", args.work / "package"), cuobjdump)
    both = sorted(set(ref) & set(new))
    differ = [f for f in both if ref[f] != new[f]]
    print(json.dumps({
        "identical": {f: len(new[f]) for f in both if f not in differ},
        "differ": {f: [len(ref[f]), len(new[f])] for f in differ},
        "only_reference": sorted(set(ref) - set(new)),
        "only_package": sorted(set(new) - set(ref)),
    }), flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
