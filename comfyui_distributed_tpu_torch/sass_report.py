"""What ptxas made of the attention kernels: registers, spills, whether
it serialised a wgmma pipeline, and the SASS instruction mix.

    python -m comfyui_distributed_tpu_torch.sass_report [--csrc DIR]

Compiles `csrc/flash_attention.cu` (or the one in DIR) with the flags
`_build.py` uses into `build/sass_report/`, then prints ptxas's
register and spill lines, each C75xx note and their count (C7513 and
C7514: ptxas serialised the wgmma instructions of a kernel, so their
pipeline no longer overlaps; C7508: it ignored a setmaxnreg), and
for each wgmma kernel (the `wgmma` instance at D=40, 64, 80 and 160,
each key tile and consumer count, and `wgmma512`), from `cuobjdump
-sass`: its HGMMA and WARPGROUP.DEPBAR counts (a DEPBAR after every
HGMMA is a serialised pipeline) and the opcodes of its main loop, taken
as the instructions from the loop's first Q·K^T up to the last tile's
P·V. Static counts: the loop's ragged-key branch is counted though only
the last tile takes it. Needs the CUDA toolkit (nvcc, cuobjdump); no
GPU.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import os
import re
import subprocess
import sys

from . import _build

_OPCODE = re.compile(r"\s*/\*([0-9a-f]+)\*/\s*(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)")
# the mangled template arguments: <D, KEYS, CONSUMERS> of the wgmma
# instance, <KEYS> of wgmma512
_WGMMA_KERNEL = re.compile(r"flash_attention_fwd_(wgmma|wgmma512)_kernelI((?:Li\d+E)+)E")
# Q·K^T k-steps of one consumer warpgroup per key tile: 16 columns each,
# over the head dim's chunks (D=40 runs 48 columns); D=512's consumers
# take 256 dims each
_SCORE_STEPS = {40: 3, 64: 4, 80: 5, 160: 10, 512: 16}
# P·V's wgmma groups per k-step: one per run of chunks of one width
_PV_GROUPS = {40: 2, 64: 1, 80: 2, 160: 2, 512: 1}


@dataclasses.dataclass(frozen=True)
class WgmmaKernel:
    """One compiled wgmma kernel and what its SASS holds."""

    instance: str
    head_dim: int
    keys: int
    consumers: int
    hgmma: int
    depbar: int
    loop: collections.Counter

    @property
    def label(self) -> str:
        return f"{self.instance} D{self.head_dim} k{self.keys} c{self.consumers}"


def ptxas_notes(log: str) -> collections.Counter:
    """ptxas's C75xx performance notes in a build log, by code."""
    return collections.Counter(re.findall(r"\((C75\d\d)\)", log))


def wgmma_loop_mix(sass: str) -> list[WgmmaKernel]:
    """Each wgmma kernel in a `cuobjdump -sass` listing, sorted. A
    consumer issues S HGMMAs of Q·K^T in its prologue (S = _SCORE_STEPS),
    then per loop tile S of Q·K^T and, for each of P·V's G groups, 2 *
    KEYS / 16 (P in two bf16): the loop is HGMMA S up to HGMMA 2 S + G *
    KEYS / 8."""
    out = []
    for block in sass.split("Function : ")[1:]:
        match = _WGMMA_KERNEL.search(block.split("\n", 1)[0])
        if not match:
            continue
        instance = match.group(1)
        args = [int(x) for x in re.findall(r"Li(\d+)E", match.group(2))]
        head_dim, keys, consumers = args if instance == "wgmma" else (512, args[0], 2)
        steps = _SCORE_STEPS[head_dim]
        ops = [m.group(2) for m in map(_OPCODE.match, block.splitlines()) if m]
        hgmma = [i for i, op in enumerate(ops) if op == "HGMMA"]
        depbar = block.count("WARPGROUP.DEPBAR")
        last = 2 * steps + _PV_GROUPS[head_dim] * keys // 8
        loop = ops[hgmma[steps]:hgmma[last]] if len(hgmma) > last else []
        out.append(WgmmaKernel(instance, head_dim, keys, consumers, len(hgmma), depbar,
                               collections.Counter(loop)))
    return sorted(out, key=lambda k: (k.instance, k.head_dim, k.keys, k.consumers))


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
        if any(word in line for word in ("entry function", "registers", "spill", "C75")):
            print(f"[ptxas] {line.strip()[:160]}")
    notes = ptxas_notes(log)
    print(f"[ptxas] C75xx notes for {src}: "
          + (", ".join(f"{code} x{n}" for code, n in sorted(notes.items())) or "none"))
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    for kernel in wgmma_loop_mix(sass):
        mix = ", ".join(f"{op} {n}" for op, n in kernel.loop.most_common(12))
        print(f"[sass] {kernel.label}: HGMMA {kernel.hgmma}, WARPGROUP.DEPBAR {kernel.depbar}; "
              f"loop {sum(kernel.loop.values())} instructions: {mix}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
