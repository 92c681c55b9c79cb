"""sass_report's reading of a `cuobjdump -sass` listing, on the CPU."""

from comfyui_distributed_tpu_torch import sass_report

_KERNEL = "_ZN5_GLOBAL32flash_attention_fwd_wgmma_kernelILi80EEEv14CUtensorMap_st"


def _listing(body):
    lines = [f"        /*{16 * i:04x}*/    {op} ;" for i, op in enumerate(body)]
    return f"\t\tFunction : {_KERNEL}\n" + "\n".join(lines) + "\n"


def test_loop_runs_from_the_first_loop_product_to_the_last_tiles():
    # k80: 4 prologue HGMMAs, then per loop tile 4 + 10; the loop's mix is
    # everything from HGMMA 4 up to HGMMA 18 (the last tile's P V)
    prologue = ["HGMMA.64x80x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT, gsb0"] * 4
    loop = ["HGMMA.64x80x16.F32.BF16 R24, gdesc[UR4], R24, gsb0"] * 4 + ["FADD R1, R2, R3"] * 3
    loop += ["HGMMA.64x64x16.F32.BF16 R96, R192, gdesc[UR4].tnspB, R96, gsb0"] * 10
    loop += ["@!P0 MUFU.EX2 R5, R5", "WARPGROUP.DEPBAR.LE gsb0, 0x0"]
    last = ["HGMMA.64x64x16.F32.BF16 R96, R192, gdesc[UR4].tnspB, R96, gsb0"] * 10
    ((keys, hgmma, depbar, mix),) = sass_report.wgmma_loop_mix(_listing(prologue + loop + last))
    assert (keys, hgmma, depbar) == (80, 28, 1)
    assert mix == {"HGMMA": 14, "FADD": 3, "MUFU": 1, "WARPGROUP": 1}


def test_other_kernels_are_skipped():
    assert sass_report.wgmma_loop_mix("\t\tFunction : _Z3fooPf\n  /*0000*/ FADD R1, R2, R3 ;\n") == []
