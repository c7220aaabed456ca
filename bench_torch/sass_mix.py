#!/usr/bin/env python3
"""Registers, local memory and the static SASS instruction mix of the
port's CUDA kernels, so that two trees' builds of one kernel can be set
side by side.

    python3 bench_torch/sass_mix.py [--src DIR ...] [--lib NAME]
                                    [--match TEXT] [--json PATH]

Each ``--src`` names a ``src`` directory whose ``repro_torch`` builds
``csrc/<NAME>.cu`` (default ``masked_wire``) into its own ``build/``
(default: this checkout's ``src``); the builds run side by side. For
every kernel whose demangled name holds ``--match`` (default: every
kernel) it prints, a tree at a time, the registers, stack and local
bytes (``cuobjdump -res-usage``: local bytes are spills) and the count
of each memory instruction (global, shared, local, constant loads and
stores, with their widths) and of the integer, float and branch
instructions in the kernel's SASS (``cuobjdump -sass``). The counts are
static: an instruction inside a loop counts once. Needs ``nvcc`` and
``cuobjdump``, no card.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MEMORY = ("LDG", "STG", "LDS", "STS", "LDL", "STL", "LDC", "ULDC", "LDGSTS",
          "RED", "ATOM", "ATOMS")
CLASSES = {"int": ("IMAD", "IADD3", "LOP3", "SHF", "ISETP", "IABS", "LEA",
                   "PRMT", "IMNMX", "SEL", "VIMNMX"),
           "float": ("FADD", "FMUL", "FFMA", "FSETP", "FMNMX", "FSEL", "F2I",
                     "I2F", "MUFU", "FCHK"),
           "branch": ("BRA", "BSSY", "BSYNC", "EXIT", "RET", "CALL", "WARPSYNC",
                      "BAR")}


def build(src: Path, name: str) -> Path:
    """Build csrc/<name>.cu of the tree under ``src`` in a process of its
    own (each tree's ``repro_torch`` is a different package)."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from repro_torch.kernels import build; "
            "print(build.build(sys.argv[2]))")
    out = subprocess.run([sys.executable, "-c", code, str(src), name],
                         capture_output=True, text=True, check=True)
    return Path(out.stdout.strip().splitlines()[-1])


def _tool(nvcc: str, name: str) -> str:
    return str(Path(nvcc).parent / name)


def _demangle(nvcc: str, names: list[str]) -> dict[str, str]:
    out = subprocess.run([_tool(nvcc, "cu++filt")], input="\n".join(names),
                         capture_output=True, text=True, check=True).stdout
    return dict(zip(names, out.splitlines()))


def usage(nvcc: str, lib: Path) -> dict[str, dict]:
    """{mangled: {"REG": n, "STACK": n, "LOCAL": n, "SHARED": n}}."""
    text = subprocess.run([_tool(nvcc, "cuobjdump"), "-res-usage", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    found, fn = {}, None
    for line in text.splitlines():
        head = re.match(r"\s*Function (\S+):", line)
        if head:
            fn = head.group(1)
        elif fn and "REG:" in line:
            found[fn] = {k: int(v) for k, v in re.findall(
                r"(REG|STACK|SHARED|LOCAL):(\d+)", line)}
            fn = None
    return found


def mix(nvcc: str, lib: Path) -> dict[str, Counter]:
    """{mangled: Counter of opcodes}: memory opcodes with their modifiers
    (``LDG.E.128``), the rest by stem, plus "total"."""
    text = subprocess.run([_tool(nvcc, "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    found, fn = {}, None
    for line in text.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            fn = head.group(1)
            found[fn] = Counter()
            continue
        op = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                      line)
        if fn is None or not op:
            continue
        full = op.group(1)
        stem = full.split(".")[0]
        if stem == "NOP":
            continue
        found[fn][full if stem in MEMORY else stem] += 1
        found[fn]["total"] += 1
    return found


def report(tag: str, nvcc: str, lib: Path, match: str) -> list[dict]:
    use, ops = usage(nvcc, lib), mix(nvcc, lib)
    names = _demangle(nvcc, sorted(ops))
    rows = []
    for mangled in sorted(ops, key=lambda m: names[m]):
        if match not in names[mangled]:
            continue
        counts = ops[mangled]
        memory = {k: v for k, v in sorted(counts.items())
                  if k.split(".")[0] in MEMORY}
        classes = {c: sum(v for k, v in counts.items() if k in stems)
                   for c, stems in CLASSES.items()}
        row = {"tree": tag, "kernel": names[mangled],
               **use.get(mangled, {}), "memory": memory, **classes,
               "total": counts["total"]}
        rows.append(row)
        print(f"{tag}: {names[mangled]}: registers {row.get('REG')}, stack "
              f"{row.get('STACK')} B, local {row.get('LOCAL')} B; "
              + ", ".join(f"{k} {v}" for k, v in memory.items())
              + f"; int {classes['int']}, float {classes['float']}, "
              f"branch {classes['branch']}; {row['total']} instructions",
              flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", action="append", type=Path,
                    help="a src directory (repeatable; default ./src)")
    ap.add_argument("--lib", default="masked_wire")
    ap.add_argument("--match", default="")
    ap.add_argument("--json", type=Path)
    args = ap.parse_args()
    srcs = args.src or [ROOT / "src"]
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build as kbuild
    nvcc = kbuild.nvcc()
    with ThreadPoolExecutor(len(srcs)) as pool:
        libs = list(pool.map(lambda s: build(s, args.lib), srcs))
    rows = []
    for src, lib in zip(srcs, libs):
        rows += report(str(src), nvcc, lib, args.match)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
