"""What ptxas made of the attention kernels: registers, spills, whether
it serialised a wgmma pipeline, and the SASS instruction mix.

    python -m comfyui_distributed_tpu_torch.sass_report [--csrc DIR]

Compiles `csrc/flash_attention.cu` (or the one in DIR) with the flags
`_build.py` uses into `build/sass_report/`, then prints ptxas's
register and spill lines, each under the kernel it is about, each
C75xx note and their count (C7513 and C7514: ptxas serialised the wgmma
instructions of a kernel, so their pipeline no longer overlaps; C7508:
it ignored a setmaxnreg), and for each wgmma kernel (the `wgmma`
instance at D=40, 64, 80, 128 and 160, each key tile and consumer count,
"bf16P" where P enters P·V as one bf16, and `wgmma512`), from `cuobjdump
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
# the mangled template arguments: <D, KEYS, CONSUMERS, SPLIT_P> of the
# wgmma instance, <KEYS> of wgmma512
_WGMMA_KERNEL = re.compile(r"flash_attention_fwd_(wgmma|wgmma512)_kernelI((?:L[ib]\d+E)+)E")
_ENTRY = re.compile(r"entry function '([^']+)'")
# the FMA kernel's <T, D> (T bf16 or f32) and the D=512 merge kernel
_FMA_KERNEL = re.compile(r"flash_attention_fwd_kernelI(13__nv_bfloat16|f)Li(\d+)EE")
_MERGE_KERNEL = "flash_attention_fwd_merge_kernel"
# Q·K^T k-steps of one consumer warpgroup per key tile: 16 columns each,
# over the head dim's chunks (D=40 runs 48 columns); D=512's consumers
# take 256 dims each
_SCORE_STEPS = {40: 3, 64: 4, 80: 5, 128: 8, 160: 10, 512: 16}
# P·V's wgmma groups per k-step: one per run of chunks of one width
_PV_GROUPS = {40: 2, 64: 1, 80: 2, 128: 1, 160: 2, 512: 1}


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
    split_p: bool = True  # P enters P·V as two bf16; else as one

    @property
    def label(self) -> str:
        return kernel_label(self.instance, self.head_dim, self.keys, self.consumers,
                            self.split_p)


def kernel_label(instance: str, head_dim: int, keys: int, consumers: int,
                 split_p: bool = True) -> str:
    label = f"{instance} D{head_dim} k{keys} c{consumers}"
    return label if split_p else label + " bf16P"


def _template_args(name: str):
    """(instance, D, KEYS, CONSUMERS, SPLIT_P) of a wgmma kernel's mangled
    name, or None for any other function."""
    match = _WGMMA_KERNEL.search(name)
    if not match:
        return None
    instance = match.group(1)
    args = [int(x) for x in re.findall(r"L[ib](\d+)E", match.group(2))]
    if instance == "wgmma512":
        return instance, 512, args[0], 2, True
    head_dim, keys, consumers, *rest = args
    return instance, head_dim, keys, consumers, bool(rest[0]) if rest else True


def entry_label(name: str) -> str:
    """A kernel's label from its mangled name: `kernel_label` for the
    wgmma kernels, "fma <dtype> D<head dim>", "merge", else the name."""
    args = _template_args(name)
    if args:
        return kernel_label(*args)
    fma = _FMA_KERNEL.search(name)
    if fma:
        return f"fma {'f32' if fma.group(1) == 'f' else 'bf16'} D{fma.group(2)}"
    return "merge" if _MERGE_KERNEL in name else name


def ptxas_kernel_lines(log: str) -> list[tuple[str, str]]:
    """ptxas's register and spill lines in a build log, each with the
    label of the kernel it is about (`entry_label`)."""
    out, kernel = [], None
    for line in log.splitlines():
        entry = _ENTRY.search(line)
        if entry:
            kernel = entry_label(entry.group(1))
        elif kernel and ("registers" in line or "spill" in line):
            out.append((kernel, line.strip()))
    return out


def ptxas_notes(log: str) -> collections.Counter:
    """ptxas's C75xx performance notes in a build log, by code."""
    return collections.Counter(re.findall(r"\((C75\d\d)\)", log))


def wgmma_loop_mix(sass: str) -> list[WgmmaKernel]:
    """Each wgmma kernel in a `cuobjdump -sass` listing, sorted. A
    consumer issues S HGMMAs of Q·K^T in its prologue (S = _SCORE_STEPS),
    then per loop tile S of Q·K^T and, for each of P·V's G groups, KEYS /
    16 for each part of P (two where P is split in two bf16, else one):
    the loop is HGMMA S up to HGMMA 2 S + G * parts * KEYS / 16."""
    out = []
    for block in sass.split("Function : ")[1:]:
        args = _template_args(block.split("\n", 1)[0])
        if not args:
            continue
        instance, head_dim, keys, consumers, split_p = args
        steps = _SCORE_STEPS[head_dim]
        ops = [m.group(2) for m in map(_OPCODE.match, block.splitlines()) if m]
        hgmma = [i for i, op in enumerate(ops) if op == "HGMMA"]
        depbar = block.count("WARPGROUP.DEPBAR")
        last = 2 * steps + _PV_GROUPS[head_dim] * (2 if split_p else 1) * keys // 16
        loop = ops[hgmma[steps]:hgmma[last]] if len(hgmma) > last else []
        out.append(WgmmaKernel(instance, head_dim, keys, consumers, len(hgmma), depbar,
                               collections.Counter(loop), split_p))
    return sorted(out, key=lambda k: (k.instance, k.head_dim, k.keys, k.consumers, k.split_p))


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
    for kernel, line in ptxas_kernel_lines(log):
        print(f"[ptxas] {kernel}: {line}")
    for line in log.splitlines():
        if "C75" in line:
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
