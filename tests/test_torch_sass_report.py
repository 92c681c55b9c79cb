"""sass_report's reading of a `cuobjdump -sass` listing, on the CPU."""

from comfyui_distributed_tpu_torch import sass_report

_KERNEL = "_ZN5_GLOBAL32flash_attention_fwd_wgmma_kernelILi80EEEv14CUtensorMap_st"
_KERNEL_512 = "_ZN5_GLOBAL35flash_attention_fwd_wgmma512_kernelILi32EEEv14CUtensorMap_st"


def _listing(body, kernel=_KERNEL):
    lines = [f"        /*{16 * i:04x}*/    {op} ;" for i, op in enumerate(body)]
    return f"\t\tFunction : {kernel}\n" + "\n".join(lines) + "\n"


def test_loop_runs_from_the_first_loop_product_to_the_last_tiles():
    # k80: 4 prologue HGMMAs, then per loop tile 4 + 10; the loop's mix is
    # everything from HGMMA 4 up to HGMMA 18 (the last tile's P V)
    prologue = ["HGMMA.64x80x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT, gsb0"] * 4
    loop = ["HGMMA.64x80x16.F32.BF16 R24, gdesc[UR4], R24, gsb0"] * 4 + ["FADD R1, R2, R3"] * 3
    loop += ["HGMMA.64x64x16.F32.BF16 R96, R192, gdesc[UR4].tnspB, R96, gsb0"] * 10
    loop += ["@!P0 MUFU.EX2 R5, R5", "WARPGROUP.DEPBAR.LE gsb0, 0x0"]
    last = ["HGMMA.64x64x16.F32.BF16 R96, R192, gdesc[UR4].tnspB, R96, gsb0"] * 10
    ((instance, keys, hgmma, depbar, mix),) = sass_report.wgmma_loop_mix(
        _listing(prologue + loop + last))
    assert (instance, keys, hgmma, depbar) == ("wgmma", 80, 28, 1)
    assert mix == {"HGMMA": 14, "FADD": 3, "MUFU": 1, "WARPGROUP": 1}


def test_d512_loop_runs_from_the_first_loop_product_to_the_last_tiles():
    # k32 at D=512: 16 prologue HGMMAs of Q·K^T, then per loop tile 16 of
    # Q·K^T and 4 of P·V (m64n256k16, P in two halves); the last tile's 4
    s_step = "HGMMA.64x32x16.F32.BF16 R24, gdesc[UR4], R24, gsb0"
    pv_step = "HGMMA.64x256x16.F32.BF16 R40, R192, gdesc[UR8].tnspB, R40, gsb0"
    loop = [s_step] * 16 + ["BAR.SYNC.DEFER_BLOCKING 0x1, 0x100", "FMNMX R1, R2, R3"] + [pv_step] * 4
    body = [s_step] * 16 + loop + loop + [pv_step] * 4
    ((instance, keys, hgmma, depbar, mix),) = sass_report.wgmma_loop_mix(
        _listing(body, _KERNEL_512))
    assert (instance, keys, hgmma, depbar) == ("wgmma512", 32, 60, 0)
    # from HGMMA 16 up to HGMMA 36: one whole loop tile
    assert mix == {"HGMMA": 20, "BAR": 1, "FMNMX": 1}


def test_other_kernels_are_skipped():
    assert sass_report.wgmma_loop_mix("\t\tFunction : _Z3fooPf\n  /*0000*/ FADD R1, R2, R3 ;\n") == []


def test_ptxas_notes_are_counted_by_code():
    log = (
        "ptxas info    : (C7513) Potential Performance Loss: wgmma.mma_async instructions are "
        "serialized due to non wgmma instructions defining input registers\n"
        "ptxas info    : Used 168 registers, used 2 barriers, 80 bytes smem\n"
        "ptxas info    : (C7514) Potential Performance Loss: wgmma.mma_async ... serialized\n"
        "ptxas info    : (C7513) again\n"
    )
    assert sass_report.ptxas_notes(log) == {"C7513": 2, "C7514": 1}
    assert sass_report.ptxas_notes("ptxas info    : Used 128 registers") == {}
