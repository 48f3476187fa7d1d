#!/usr/bin/env python3
"""Tensor-core instructions and spills of the panel and E-step tile kernels,
from their SASS.

    cuobjdump -sass spd_panel_f32.o > f32.sass
    python3 tools/torch_panel_sass.py f32.sass [f64.sass ...]

For every ``spd_panel_kernel<T, WANT>``, ``spd_estep_tile_kernel<T, KP,
WANT, SLAB>`` (the tile's blocked body, SLAB true where G comes as slabs)
and ``spd_estep_small_kernel<T, KP, WANT>``
(its one-block body) in the listings it prints the count
of HMMA instructions with TF32 operands and of DMMA instructions, the local
memory (spill) loads and stores in the whole kernel, and for each run of
tensor-core instructions (consecutive ones less than GAP instructions apart:
one warp's product of a block) its length and the spill accesses inside it,
so that a spill in a product's inner loop shows.  cuobjdump ships with the
CUDA toolkit; the objects come from SKILL.md's ptxas command.
"""

from __future__ import annotations

import re
import sys

GAP = 120
_FUNCTION = re.compile(r"Function : (\S+)")
_PANEL = re.compile(r"spd_panel_kernelI([fd])Li(\d)E")
_TILE = re.compile(r"spd_estep_(tile|small)_kernelI([fd])Li(\d+)ELi(\d)E(?:Lb([01])E)?")


def kernels(path: str):
    """(name, [instruction text]) per function in a cuobjdump listing."""
    name, body = None, []
    with open(path) as f:
        for line in f:
            m = _FUNCTION.search(line)
            if m:
                if name:
                    yield name, body
                name, body = m.group(1), []
            elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
                body.append(line.split("*/", 1)[1])
    if name:
        yield name, body


def summary(body):
    mma = [i for i, ins in enumerate(body) if "HMMA" in ins or "DMMA" in ins]
    spills = [i for i, ins in enumerate(body) if re.search(r"\b(LDL|STL)\b", ins)]
    runs, start = [], None
    for a, b in zip([None] + mma, mma + [None]):
        if start is None:
            start = b
        elif b is None or b - a >= GAP:
            runs.append((start, a))
            start = b
    inside = [(sum(1 for i in mma if lo <= i <= hi), sum(1 for i in spills if lo <= i <= hi))
              for lo, hi in runs]
    tf32 = sum(1 for ins in body if "HMMA" in ins and "TF32" in ins)
    dmma = sum(1 for ins in body if "DMMA" in ins)
    return tf32, dmma, len(spills), inside


def main(paths) -> int:
    for path in paths:
        for name, body in kernels(path):
            m, t = _PANEL.search(name), _TILE.search(name)
            if m:
                dtype = "float" if m.group(1) == "f" else "double"
                label = f"spd_panel_kernel<{dtype}, {m.group(2)}>"
            elif t:
                dtype = "float" if t.group(2) == "f" else "double"
                layout = "" if t.group(5) is None else (", true" if t.group(5) == "1" else ", false")
                label = (f"spd_estep_{t.group(1)}_kernel<{dtype}, {t.group(3)}, {t.group(4)}"
                         f"{layout}>")
            else:
                continue
            tf32, dmma, spills, inside = summary(body)
            runs = ", ".join(f"{n} mma/{s} spill" for n, s in inside)
            print(f"{label}: HMMA.TF32 {tf32}, DMMA {dmma}, "
                  f"local loads+stores {spills}; runs: {runs}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
