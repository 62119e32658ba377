"""Instruction counts of the loops of the port's CUDA kernels, from SASS.

    python3 tools/sass_loops.py [source ...]

Builds the named sources of `mvsmplfitting_tpu_torch/csrc` (default:
`sdf_grid_fast` and `sdf_grid`) with the package's nvcc flags
(`ops/cuda_build.py`), disassembles each library with `cuobjdump -sass`
and prints one JSON line per loop, a backward branch: the kernel, the
loop's first and last offsets, whether it holds no other loop
(`innermost`), its instruction count and the count of each opcode.
A loop's instructions per (voxel, triangle) pair are its count over the
pairs one trip evaluates, which the source's unrolling decides.  Needs
the CUDA toolkit, so it runs on the machine with the card.
"""

from __future__ import annotations

import collections
import json
import os
import re
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                  r"([^;]*);")
FUNC = re.compile(r"Function : (\S+)")


def cuobjdump() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "cuobjdump")
    return path if os.path.exists(path) else (shutil.which("cuobjdump")
                                              or "cuobjdump")


def functions(sass: str):
    """{mangled name: [(offset, opcode, operands)]} from cuobjdump -sass."""
    out, cur = {}, None
    for line in sass.splitlines():
        f = FUNC.search(line)
        if f:
            cur = out.setdefault(f.group(1), [])
            continue
        m = INSN.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2), m.group(3)))
    return out


def loops(insns):
    """(start, end) offsets of every backward branch's loop."""
    found = []
    for off, op, args in insns:
        if op.split(".")[0] == "BRA":
            t = re.search(r"0x([0-9a-f]+)", args)
            if t and int(t.group(1), 16) <= off:
                found.append((int(t.group(1), 16), off))
    return sorted(set(found))


def main(argv) -> int:
    from mvsmplfitting_tpu_torch.ops import cuda_build
    names = argv or ["sdf_grid_fast", "sdf_grid"]
    cuda_build.build(names)
    for name in names:
        sass = subprocess.run([cuobjdump(), "-sass",
                               str(cuda_build.library_path(name))],
                              capture_output=True, text=True,
                              check=True).stdout
        for fn, insns in functions(sass).items():
            found = loops(insns)
            for start, end in found:
                body = [op for off, op, _ in insns if start <= off <= end]
                inner = not any(start <= s and e <= end
                                and (s, e) != (start, end) for s, e in found)
                ops = collections.Counter(op.split(".")[0] for op in body)
                print(json.dumps({
                    "source": name, "kernel": fn, "start": hex(start),
                    "end": hex(end), "innermost": inner,
                    "instructions": len(body),
                    "opcodes": dict(ops.most_common())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
