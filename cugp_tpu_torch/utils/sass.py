"""Instruction census of the built kernel library (``cuobjdump -sass``).

    python -m cugp_tpu_torch.utils.sass cov_matvec     # kernels matching
    python -m cugp_tpu_torch.utils.sass cov_matvec dump.txt  # a saved dump
    python -m cugp_tpu_torch.utils.sass cov_tile --list  # and their code

For every kernel whose (mangled) name contains the pattern, prints its
instruction count by opcode and, for each loop (a branch back to an
earlier address), the loop body's length and opcode mix, innermost
first; with --list, every instruction too. Needs the CUDA toolkit's
``cuobjdump`` and a built library (it builds one if the sources have
none).
"""

from __future__ import annotations

import collections
import pathlib
import re
import shutil
import subprocess
import sys

from cugp_tpu_torch.ops import _build

_FUNC = re.compile(r"Function : (\S+)")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRA = re.compile(r"\bBRA\b.*?0x([0-9a-f]+)")


def cuobjdump_path():
    found = shutil.which("cuobjdump")
    if found:
        return found
    return str(pathlib.Path(_build.nvcc_path()).with_name("cuobjdump"))


def disassemble(text=None):
    """{kernel name: [(address, instruction text)]} of the library (or of
    `text`, a saved ``cuobjdump -sass`` listing)."""
    if text is None:
        text = subprocess.run([cuobjdump_path(), "-sass",
                               str(_build.build())], capture_output=True,
                              text=True, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _INSN.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2)))
    return funcs


def opcode(insn):
    """'@!P0 FFMA.FTZ R1, ...' -> 'FFMA.FTZ'."""
    parts = insn.split()
    if parts and parts[0].startswith("@"):
        parts = parts[1:]
    return parts[0] if parts else "?"


def histogram(insns):
    return collections.Counter(opcode(i) for _, i in insns)


def loops(insns):
    """(start, end, body) for each backward branch, shortest first."""
    found = []
    for addr, insn in insns:
        m = _BRA.search(insn)
        if m and opcode(insn) == "BRA":
            target = int(m.group(1), 16)
            if target < addr:
                body = [(a, i) for a, i in insns if target <= a <= addr]
                found.append((target, addr, body))
    return sorted(found, key=lambda t: len(t[2]))


def fmt(hist, top=14):
    return " ".join(f"{k}:{v}" for k, v in hist.most_common(top))


def main(argv):
    listing = "--list" in argv
    argv = [a for a in argv if a != "--list"]
    pattern = argv[0] if argv else ""
    text = pathlib.Path(argv[1]).read_text() if len(argv) > 1 else None
    for name, insns in sorted(disassemble(text).items()):
        if pattern not in name:
            continue
        print(f"### {name} instructions={len(insns)}")
        print(f"  all: {fmt(histogram(insns))}")
        for start, end, body in loops(insns):
            print(f"  loop 0x{start:x}-0x{end:x} len={len(body)}: "
                  f"{fmt(histogram(body))}")
        if listing:
            for addr, insn in insns:
                print(f"  {addr:05x} {insn}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
