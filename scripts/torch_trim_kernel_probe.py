#!/usr/bin/env python3
"""What the compiler made of the port's three tile kernels, ``trim_bits``,
``trim_degrees`` and ``trim_adjacency``.

    python3 scripts/torch_trim_kernel_probe.py

Builds ``csrc/trim_bits.cu``, ``csrc/trim_degrees.cu`` and
``csrc/trim_adjacency.cu`` as the package does and prints, one JSON line per
library:

* what ptxas reports (registers, shared memory, spills);
* from ``cuobjdump -sass``, for each kernel, its instruction count and every
  loop (a backward branch and its target) with its instructions by opcode,
  and from those the pairs a lane evaluates in one pass of the loop, which
  give instructions per unordered pair. The pairs are counted by an opcode
  that the pair function issues a fixed number of times:
  - ``trim_bits``, ``trim_degrees``: ``FMUL / 8`` (the sqrt-free predicate
    has 8 multiplies beside its one fused multiply-add);
  - ``trim_adjacency``: ``MUFU / 2`` (each of the two Gram-form distances
    takes one square root, one special-function instruction; its multiplies
    are no fixed count, since the square root issues some of its own).

Needs ``nvcc`` and ``cuobjdump`` (no card); exits non-zero without them. The
kernels' times and exact checks are ``chip_smoke.py``'s.
"""

from __future__ import annotations

import collections
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)([.\w]*)\s*(.*?);")

# library -> (opcode, its count per pair) that counts the pairs of a loop
PAIR_MARKERS = {
    "trim_bits": ("FMUL", 8),
    "trim_degrees": ("FMUL", 8),
    "trim_adjacency": ("MUFU", 2),
}


def sass_loops(tool: str, so: Path, marker: tuple) -> dict:
    """{kernel: {"instructions": n, "loops": [{"length", "opcodes", ...}]}}."""
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    opcode, per_pair = marker
    out = {}
    for chunk in text.split("Function : ")[1:]:
        instrs = [(int(m.group(1), 16), m.group(2), m.group(4))
                  for m in _INSTR.finditer(chunk)]
        loops = []
        for addr, op, operands in instrs:
            target = re.search(r"0x([0-9a-f]+)", operands) if op == "BRA" else None
            if target and int(target.group(1), 16) <= addr:
                ops = collections.Counter(
                    o for a, o, _ in instrs if int(target.group(1), 16) <= a <= addr)
                length = sum(ops.values())
                pairs = ops[opcode] / per_pair
                loops.append(dict(
                    length=length, opcodes=dict(ops.most_common()), pairs_a_lane=pairs,
                    pairs_counted_by=f"{opcode} / {per_pair}",
                    instructions_a_pair=length / pairs if pairs else None))
        out[chunk.split()[0]] = dict(instructions=len(instrs), loops=loops)
    return out


def main() -> int:
    from teaserpp_tpu_torch.ops import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        print("torch_trim_kernel_probe: cuobjdump not found", file=sys.stderr)
        return 1
    for name, marker in PAIR_MARKERS.items():
        so = _build.build(name)
        log = Path(str(so) + ".log").read_text()
        ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(json.dumps(dict(library=name, ptxas=ptxas, sass=sass_loops(tool, so, marker))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
