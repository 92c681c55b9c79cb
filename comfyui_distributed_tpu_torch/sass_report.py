"""What ptxas made of the attention kernels: registers, spills, whether
it serialised a wgmma pipeline, and the SASS instruction mix.

    python -m comfyui_distributed_tpu_torch.sass_report [--csrc DIR]

Compiles `csrc/flash_attention.cu` (or the one in DIR) with the flags
`_build.py` uses into `build/sass_report/`, then prints ptxas's
register and spill lines, each C7514 note (ptxas serialised the wgmma
instructions of a kernel, so their pipeline no longer overlaps), and
for each wgmma kernel, from `cuobjdump -sass`: its HGMMA and
WARPGROUP.DEPBAR counts (a DEPBAR after every HGMMA is a serialised
pipeline) and the opcodes of its main loop, taken as the instructions
from the loop's first Q·K^T up to the last tile's P·V. Static counts:
the loop's ragged-key branch is counted though only the last tile takes
it. Needs the CUDA toolkit (nvcc, cuobjdump); no GPU.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import subprocess
import sys

from . import _build

_OPCODE = re.compile(r"\s*/\*([0-9a-f]+)\*/\s*(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)")
_WGMMA_KEYS = re.compile(r"flash_attention_fwd_wgmma_kernelILi(\d+)E")


def wgmma_loop_mix(sass: str) -> list[tuple[int, int, int, collections.Counter]]:
    """(key tile, HGMMA count, DEPBAR count, loop opcode counts) of each
    wgmma kernel in a `cuobjdump -sass` listing. The kernel issues 4
    HGMMAs of Q·K^T in its prologue, then per loop tile 4 of Q·K^T and
    2 * KEYS / 16 of P·V: the loop is HGMMA 4 up to HGMMA 8 + KEYS / 8."""
    out = []
    for block in sass.split("Function : ")[1:]:
        match = _WGMMA_KEYS.search(block.split("\n", 1)[0])
        if not match:
            continue
        keys = int(match.group(1))
        ops = [m.group(2) for m in map(_OPCODE.match, block.splitlines()) if m]
        hgmma = [i for i, op in enumerate(ops) if op == "HGMMA"]
        depbar = block.count("WARPGROUP.DEPBAR")
        last = 8 + keys // 8
        loop = ops[hgmma[4]:hgmma[last]] if len(hgmma) > last else []
        out.append((keys, len(hgmma), depbar, collections.Counter(loop)))
    return sorted(out)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--csrc", default=_build.CSRC_DIR, help="directory of the sources")
    args = parser.parse_args(argv)
    out_dir = os.path.join(_build.BUILD_DIR, "sass_report")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libflash_attention.so")
    src = os.path.join(args.csrc, "flash_attention.cu")
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib, src],
                          capture_output=True, text=True, check=False)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        print(log, file=sys.stderr)
        return 1
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "C7514" in line:
            print(f"[ptxas] {line.strip()[:160]}")
    print(f"[ptxas] {log.count('C7514')} C7514 notes for {src}")
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    for keys, hgmma, depbar, loop in wgmma_loop_mix(sass):
        mix = ", ".join(f"{op} {n}" for op, n in loop.most_common(12))
        print(f"[sass] wgmma k{keys}: HGMMA {hgmma}, WARPGROUP.DEPBAR {depbar}; "
              f"loop {sum(loop.values())} instructions: {mix}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
