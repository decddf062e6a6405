#!/usr/bin/env python3
"""Count the instructions of the port's kernels from their SASS.

    python3 scripts/torch_sass_ops.py [--sass FILE] [--kernel SUBSTRING]

Disassembles the built library (``cuobjdump -sass``; or reads a saved
dump with --sass) and prints, per kernel, one JSON line per loop: the
loop's body (a backward branch's target up to the branch) with its
instruction count, its count by class (integer ALU, tensor-core mma,
shared-memory load or store, global load or store, other) and its
opcodes. The innermost loops are the main loops the kernels' operation
counts per byte column come from (PERF.md divides a body's count by the
columns and rows it covers). Two last lines, ``mxu_per_16_columns``,
give the tensor-core kernel's counts per 16 columns (one m-tile) and row
group at RS(10,4) (``mxu_counts``), on wgmma and on mma.sync. It needs
the CUDA toolkit's cuobjdump unless --sass is given.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)"
                  r"([^;]*);")


def classify(op: str) -> str:
    base = op.split(".")[0]
    if base in ("IMMA", "HMMA", "IGMMA", "HGMMA", "QGMMA"):
        return "mma"
    if base in ("LDS", "STS", "LDSM", "ATOMS"):
        return "shared"
    if base in ("LDG", "STG", "LD", "ST", "RED", "ATOMG", "LDL", "STL"):
        return "global_or_local"
    if base in ("BRA", "EXIT", "BAR", "BSYNC", "BSSY", "WARPSYNC", "NOP",
                "RET", "CALL", "YIELD"):
        return "control"
    return "alu"


def kernels(sass: str) -> dict:
    out = {}
    for chunk in re.split(r"\n\s*Function : ", sass)[1:]:
        name = chunk.split("\n", 1)[0].strip()
        out[name] = [(int(a, 16), op, rest)
                     for a, _, op, rest in INSN.findall(chunk)]
    return out


def loops(insns: list) -> list:
    """(start, end) address ranges of the loops: a backward BRA to a
    target inside the function."""
    found = []
    for addr, op, rest in insns:
        if op.startswith("BRA"):
            m = re.search(r"0x([0-9a-f]+)", rest)
            if m and int(m.group(1), 16) < addr:
                found.append((int(m.group(1), 16), addr))
    return sorted(set(found))


def mxu_counts(sass: str, k_tiles: int = 3, wgmma: bool = True) -> dict:
    """The tensor-core kernel's instructions per 16 columns and row group,
    by class, for its instantiation with `k_tiles` k-tiles (3: C = 9..12,
    RS(10,4)) on wgmma or mma.sync: the body of its whole-span loop (the
    loop with the most mma and no byte loads) divided by the 16-column
    m-tiles it covers, each of which issues k_tiles + 4 wgmma or
    4 * k_tiles + 4 mma.sync (the GF product's k-tiles, times its 4
    n-tiles on mma.sync, and one repack product per output row)."""
    insns = next(v for k, v in kernels(sass).items()
                 if f"gf_mxu_kernelILi{k_tiles}ELb{int(wgmma)}E" in k)

    def body(span):
        return [op for a, op, _ in insns if span[0] <= a <= span[1]]

    whole = [sp for sp in loops(insns)
             if any(classify(op) == "mma" for op in body(sp))
             and not any(op.startswith("LDG") and ".U8" in op
                         for op in body(sp))]
    span = max(whole, key=lambda sp: sum(classify(op) == "mma"
                                         for op in body(sp)))
    by_class = collections.Counter(classify(op) for op in body(span))
    m_tiles = by_class["mma"] / (k_tiles + 4 if wgmma else 4 * k_tiles + 4)
    return {"k_tiles": k_tiles, "instr": "wgmma" if wgmma else "mma.sync",
            "loop": [hex(span[0]), hex(span[1])],
            "columns_per_loop": 16 * m_tiles,
            **{cls: by_class[cls] / m_tiles for cls in
               ("mma", "alu", "global_or_local", "shared", "control")}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sass", help="a saved cuobjdump -sass dump")
    ap.add_argument("--kernel", default="", help="kernel name substring")
    args = ap.parse_args()
    if args.sass:
        sass = Path(args.sass).read_text()
    else:
        from seaweedfs_torch.ops import _build
        lib = _build.build()
        cuobjdump = Path(_build.nvcc()).with_name("cuobjdump")
        sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                              capture_output=True, text=True,
                              check=True).stdout
    for name, insns in kernels(sass).items():
        if args.kernel not in name:
            continue
        for start, end in loops(insns):
            body = [op for a, op, _ in insns if start <= a <= end]
            by_class = collections.Counter(classify(op) for op in body)
            print(json.dumps({
                "kernel": name, "loop": [hex(start), hex(end)],
                "instructions": len(body), "by_class": dict(by_class),
                "opcodes": dict(collections.Counter(
                    op.split(".")[0] for op in body).most_common())}))
    if "gf_mxu_kernel" in sass:
        for wgmma in (True, False):
            print(json.dumps({"mxu_per_16_columns": mxu_counts(
                sass, wgmma=wgmma)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
