"""Static SASS instruction mix of the kernels, one line per instantiation.

    python -m anet_torch.kernels.sass_mix [--loops] [source ...]

Builds each ``csrc/<source>.cu`` (by default the four with an int8
instantiation; a shared header's name, ``search_core`` or ``demod_core``,
stands for the sources that include it) as the kernels are built,
disassembles the library with
``cuobjdump -sass`` and prints, for each kernel function, its instruction
count and the count of each opcode (the part before the first dot) as one
JSON object. The counts are static (instructions in the code, not executed
ones): enough to set one instantiation's inner loop beside another's, e.g.
the int8 and bfloat16 loads and conversions, or that the tensor-core
kernels (``search_core``: ``HMMA`` and no float32 product loop,
``FFMA``; ``demod_core``, whose walk runs in ``demod_at``,
``demod_at_energies`` and ``tone_energies``, whose products with a
runtime geometry run in ``filterbank_any``, ``frame_tm_any`` and ``demod_at_any``, and whose products and
``cp.async`` helpers ``decide_frame_tm`` and ``demod_probe`` take:
``HMMA`` in the bfloat16 and float32 and ``IMMA`` in the int8
tensor-core kernels, ``FFMA`` only in the CUDA-core ones). Each row also
counts the global loads and stores by their whole opcode (``"global":
{"LDG.E.128": ..., "STG.E.128": ...}``), which shows
their width: ``gather_rows`` loads and stores 16 bytes a lane, and the
registers a thread and stack bytes the compiler gave the function
(``cuobjdump --dump-resource-usage``), which with the kernel's shared
memory set its blocks an SM, and its STL and LDL instructions
(``"spill_ops"``: 0, with 0 stack bytes, where nothing spills). With
``--loops`` each row also lists the
function's loops of at least ``LOOP_MIN`` instructions (a backward branch
and its target, innermost first) as ``[first, last address, static
instructions, instructions off sincosf's slow path]``: the second count
leaves out the blocks that a branch on ``|x| >= 105615`` skips (the
Payne-Hanek argument reduction, which no angle of the OFDM equalizer
reaches), so it is what one trip issues. Needs the CUDA toolkit, no card.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

from anet_torch.kernels.build import build_all, library_path, nvcc_path

INT8_SOURCES = ("decide_frame_tm", "demod_at", "demod_at_energies", "demod_probe")
HEADERS = {  # a shared device header -> the sources built on it
    "search_core": ("sync_search", "search_blockmax", "correlate"),
    "demod_core": ("demod_at", "demod_at_energies", "tone_energies", "decide_frame_tm", "demod_probe",
                   "filterbank_any", "frame_tm_any", "demod_at_any"),
}
_FUNCTION = re.compile(r"^\s*Function : (\S+)")
_INSTRUCTION = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")
_GLOBAL = ("LDG", "STG")  # opcodes counted with their modifiers too
_RESOURCES = re.compile(r"REG:(\d+) STACK:(\d+)")
_ADDRESSED = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_TARGET = re.compile(r"BRA\b.*?0x([0-9a-f]+)")
_SLOW_SINCOS = "105615"  # sincosf's fast reduction holds below this |x|
LOOP_MIN = 100


def _demangle(names: list[str]) -> list[str]:
    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    if tool is None:
        return names
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True, check=True)
    return out.stdout.splitlines()


def _instructions(sass: str) -> list[tuple[str, list[str]]]:
    """(mangled function name, its whole opcodes, modifiers kept) of each
    function in the text that ``cuobjdump -sass`` prints; a predicate (@P0,
    @!UP1) is not part of the opcode."""
    functions: list[tuple[str, list[str]]] = []
    for line in sass.splitlines():
        m = _FUNCTION.match(line)
        if m:
            functions.append((m.group(1), []))
            continue
        m = _INSTRUCTION.match(line)
        if m and functions:
            functions[-1][1].append(m.group(1))
    return functions


def parse_sass(sass: str) -> list[tuple[str, Counter]]:
    """(mangled function name, opcode counts) of each function in the text
    that ``cuobjdump -sass`` prints; the opcode is the part before the
    first dot."""
    return [(name, Counter(op.split(".")[0] for op in ops)) for name, ops in _instructions(sass)]


def global_ops(sass: str) -> list[Counter]:
    """The whole-opcode counts (LDG.E.128, STG.E.U8, ...) of each function's
    global loads and stores, in parse_sass's order."""
    return [Counter(op for op in ops if op.split(".")[0] in _GLOBAL) for _, ops in _instructions(sass)]


def loops(sass: str) -> list[list[list[int]]]:
    """Each function's loops of at least LOOP_MIN instructions, in
    parse_sass's order: [first address, last address, static instructions,
    instructions off sincosf's slow path], innermost loops only."""
    out = []
    for chunk in re.split(r"\n\s*Function : ", sass)[1:]:
        ins = [(int(m.group(1), 16), m.group(2)) for m in map(_ADDRESSED.match, chunk.splitlines()) if m]
        slow = []  # [start, end) of each block a branch on |x| >= 105615 skips
        for i, (a, text) in enumerate(ins):
            m = _TARGET.search(text)
            if (m and text.startswith("@") and int(m.group(1), 16) > a
                    and any(_SLOW_SINCOS in t for _, t in ins[max(0, i - 20):i])):
                slow.append((a + 16, int(m.group(1), 16)))
        spans = sorted((int(m.group(1), 16), a) for a, text in ins
                       if (m := _TARGET.search(text)) and int(m.group(1), 16) < a)
        found = []
        for lo, hi in spans:
            body = [a for a, _ in ins if lo <= a <= hi]
            inner = any(lo <= l2 and h2 <= hi and (l2, h2) != (lo, hi) and
                        sum(1 for a, _ in ins if l2 <= a <= h2) >= LOOP_MIN for l2, h2 in spans)
            if len(body) >= LOOP_MIN and not inner:
                fast = sum(1 for a in body if not any(s <= a < e for s, e in slow))
                found.append([lo, hi, len(body), fast])
        out.append(found)
    return out


def resource_usage(text: str) -> dict[str, tuple[int, int]]:
    """{mangled function name: (registers a thread, stack bytes)} from the
    text that ``cuobjdump --dump-resource-usage`` prints: a "Function
    name:" line, then its "REG:... STACK:..." line."""
    usage, name = {}, None
    for line in text.splitlines():
        m = re.match(r"^\s*Function (\S+):", line)
        if m:
            name = m.group(1)
            continue
        m = _RESOURCES.search(line)
        if m and name is not None:
            usage[name] = (int(m.group(1)), int(m.group(2)))
            name = None
    return usage


def instruction_mix(source: str, with_loops: bool = False) -> list[dict]:
    """[{"source", "function", "instructions", "ops": {opcode: count},
    "global": {whole opcode: count}, "registers", "stack", "spill_ops"}] of
    every kernel function in the library of ``source`` ("spill_ops": its
    STL and LDL instructions, 0 with 0 stack bytes where nothing spills),
    with "loops" where ``with_loops``."""
    build_all((source,))
    cuobjdump = Path(nvcc_path()).with_name("cuobjdump")
    lib = str(library_path(source))
    sass = subprocess.run([str(cuobjdump), "-sass", lib], capture_output=True, text=True, check=True).stdout
    usage = resource_usage(subprocess.run(
        [str(cuobjdump), "--dump-resource-usage", lib], capture_output=True, text=True, check=True
    ).stdout)
    functions = parse_sass(sass)
    names = _demangle([f for f, _ in functions])
    rows = [
        {"source": source, "function": name, "instructions": sum(ops.values()),
         "ops": dict(ops.most_common()), "global": dict(wide.most_common()),
         "registers": usage.get(mangled, (None, None))[0], "stack": usage.get(mangled, (None, None))[1],
         "spill_ops": ops["STL"] + ops["LDL"]}
        for name, (mangled, ops), wide in zip(names, functions, global_ops(sass))
    ]
    if with_loops:
        for row, found in zip(rows, loops(sass)):
            row["loops"] = found
    return rows


def main(argv: list[str]) -> int:
    with_loops = argv[:1] == ["--loops"]
    names = argv[1:] if with_loops else argv
    sources = [s for name in names or INT8_SOURCES for s in HEADERS.get(name, (name,))]
    for source in sources:
        for row in instruction_mix(source, with_loops):
            print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
