"""What ptxas made of the attention kernels: registers, spills, whether
it serialised a wgmma pipeline, and the SASS instruction mix.

    python -m comfyui_distributed_tpu_torch.sass_report [--csrc DIR]

Compiles `csrc/flash_attention.cu` (or the one in DIR) with the flags
`_build.py` uses into `build/sass_report/`, then prints ptxas's
register and spill lines, each C75xx note and their count (C7513 and
C7514: ptxas serialised the wgmma instructions of a kernel, so their
pipeline no longer overlaps; C7508: it ignored a setmaxnreg), and
for each wgmma kernel (D=64 and D=512), from `cuobjdump -sass`: its HGMMA and
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
_WGMMA_KERNEL = re.compile(r"flash_attention_fwd_(wgmma|wgmma512)_kernelILi(\d+)E")
# Q·K^T k-steps of one consumer warpgroup per key tile, by instance: D=64
# in one warpgroup, D=512 split over two of 256 dims each
_SCORE_STEPS = {"wgmma": 4, "wgmma512": 16}


def ptxas_notes(log: str) -> collections.Counter:
    """ptxas's C75xx performance notes in a build log, by code."""
    return collections.Counter(re.findall(r"\((C75\d\d)\)", log))


def wgmma_loop_mix(sass: str) -> list[tuple[str, int, int, int, collections.Counter]]:
    """(instance, key tile, HGMMA count, DEPBAR count, loop opcode counts)
    of each wgmma kernel in a `cuobjdump -sass` listing. A consumer issues
    S HGMMAs of Q·K^T in its prologue (S = 4 at D=64, 16 at D=512), then
    per loop tile S of Q·K^T and 2 * KEYS / 16 of P·V: the loop is HGMMA
    S up to HGMMA 2 S + KEYS / 8."""
    out = []
    for block in sass.split("Function : ")[1:]:
        match = _WGMMA_KERNEL.search(block.split("\n", 1)[0])
        if not match:
            continue
        instance, keys = match.group(1), int(match.group(2))
        steps = _SCORE_STEPS[instance]
        ops = [m.group(2) for m in map(_OPCODE.match, block.splitlines()) if m]
        hgmma = [i for i, op in enumerate(ops) if op == "HGMMA"]
        depbar = block.count("WARPGROUP.DEPBAR")
        last = 2 * steps + keys // 8
        loop = ops[hgmma[steps]:hgmma[last]] if len(hgmma) > last else []
        out.append((instance, keys, len(hgmma), depbar, collections.Counter(loop)))
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
        if "registers" in line or "spill" in line or "C75" in line:
            print(f"[ptxas] {line.strip()[:160]}")
    notes = ptxas_notes(log)
    print(f"[ptxas] C75xx notes for {src}: "
          + (", ".join(f"{code} x{n}" for code, n in sorted(notes.items())) or "none"))
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    for instance, keys, hgmma, depbar, loop in wgmma_loop_mix(sass):
        mix = ", ".join(f"{op} {n}" for op, n in loop.most_common(12))
        print(f"[sass] {instance} k{keys}: HGMMA {hgmma}, WARPGROUP.DEPBAR {depbar}; "
              f"loop {sum(loop.values())} instructions: {mix}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
