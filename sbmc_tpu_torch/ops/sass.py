"""The SASS of the port's kernels by loop and basic block: what one pass of
a kernel's loop issues.

    python -m sbmc_tpu_torch.ops.sass trace_hits.cu [--kernel tiles]

Builds the CUDA sources as the ops do (``_build.load_cuda``), disassembles
the library of the named source with the toolkit's ``cuobjdump -sass`` and
prints, for each kernel whose mangled name contains ``--kernel``, every
innermost loop (a branch back to a lower address, around no other such
branch) cut into basic blocks: each
block's address range, its instruction count and how many of them are
float32 arithmetic (FFMA, FMUL, FADD), float32 compares (FSETP), MUFU,
shared-memory loads (LDS) and branches. Needs the CUDA toolkit (nvcc and
cuobjdump), not a card.
"""

import argparse
import os
import re
import subprocess

__all__ = ["parse", "blocks", "loops", "report"]

_FUNCTION = re.compile(r"^\s*Function : (\S+)")
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_TARGET = re.compile(r"\bBRA\b.*?(0x[0-9a-f]+)")
#: Opcode classes counted per block.
CLASSES = (("fp32", ("FFMA", "FMUL", "FADD")), ("compare", ("FSETP",)),
           ("mufu", ("MUFU",)), ("lds", ("LDS",)), ("branch", ("BRA",)))


def parse(text):
    """``{kernel: [(address, opcode, instruction), ...]}`` of a
    ``cuobjdump -sass`` listing (the opcode without its predicate and
    modifiers)."""
    kernels, current = {}, None
    for line in text.splitlines():
        m = _FUNCTION.match(line)
        if m:
            current = kernels.setdefault(m.group(1), [])
            continue
        m = _INSTR.search(line)
        if m and current is not None:
            instr = m.group(2)
            op = instr.split()[0]
            if op.startswith("@"):
                op = instr.split()[1]
            current.append((int(m.group(1), 16), op.split(".")[0], instr))
    return kernels


def _target(instr):
    m = _TARGET.search(instr)
    return int(m.group(1), 16) if m else None


def loops(instrs):
    """``[(start, end)]`` address ranges of the innermost loops: a branch at
    ``end`` back to ``start``, with no other such range inside."""
    found = {(_target(i), a) for a, op, i in instrs
             if op == "BRA" and _target(i) is not None and _target(i) < a}
    return sorted(r for r in found if not any(
        o != r and r[0] <= o[0] and o[1] <= r[1] for o in found))


def blocks(instrs, start, end):
    """Basic blocks of the instructions in ``[start, end]``: a block starts
    at a branch target and after a branch or EXIT."""
    inside = [(a, op, i) for a, op, i in instrs if start <= a <= end]
    targets = {_target(i) for _, op, i in inside if op == "BRA"}
    out, cur = [], []
    for a, op, i in inside:
        if cur and a in targets:
            out.append(cur)
            cur = []
        cur.append((a, op, i))
        if op in ("BRA", "EXIT"):
            out.append(cur)
            cur = []
    if cur:
        out.append(cur)
    return out


def _counts(block):
    return {name: sum(op in ops for _, op, _ in block)
            for name, ops in CLASSES}


def report(text, kernel=""):
    """Lines of the loop-by-block report (see the module's docstring)."""
    lines = []
    for name, instrs in parse(text).items():
        if kernel not in name:
            continue
        lines.append("%s: %d instructions" % (name, len(instrs)))
        for start, end in loops(instrs):
            lines.append("  loop 0x%04x-0x%04x" % (start, end))
            for b in blocks(instrs, start, end):
                lines.append("    0x%04x-0x%04x %4d instructions %s" % (
                    b[0][0], b[-1][0], len(b), " ".join(
                        "%s %d" % kv for kv in _counts(b).items())))
    return lines


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("source", help="a CUDA source under csrc/, e.g. "
                        "trace_hits.cu")
    parser.add_argument("--kernel", default="",
                        help="report the kernels whose name contains this")
    args = parser.parse_args(argv)
    from sbmc_tpu_torch.ops import _build
    _build.load_cuda()
    lib = os.path.join(_build.BUILD_DIR, "lib%s_%s.so" % (
        os.path.splitext(args.source)[0], _build._digest(_build.NVCC_FLAGS)))
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    print("\n".join(report(text, args.kernel)))


if __name__ == "__main__":
    main()
