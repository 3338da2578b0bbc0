"""The port's measuring tools: ``python -m sbmc_tpu_torch.ops.sass`` (its
listing parser, on a canned ``cuobjdump -sass`` excerpt: this machine has
no CUDA toolkit) and ``python -m sbmc_tpu_torch.compare_datagen`` (the
datagen CLI in two checkouts in turns, here the same checkout twice, on the
CPU, at a tiny size)."""

from sbmc_tpu_torch import compare_datagen
from sbmc_tpu_torch.ops import sass

#: A kernel with a setup block, a loop of two blocks (a branch inside it)
#: and an exit; addresses as cuobjdump prints them.
LISTING = """
        Function : _Z6kernelPf
        .headerflags    @"EF_CUDA_SM90"
        /*0000*/                   MOV R1, c[0x0][0x28] ;    /* 0x00000a00 */
        /*0010*/                   LDS.128 R4, [R2] ;        /* 0x00000a00 */
        /*0020*/                   FFMA R3, R4, R5, R3 ;     /* 0x00000a00 */
        /*0030*/                   FSETP.GT.AND P0, PT, R3, 1, PT ; /* 0x0 */
        /*0040*/               @P0 BRA 0x70 ;                /* 0x00000a00 */
        /*0050*/                   MUFU.RCP R6, R3 ;         /* 0x00000a00 */
        /*0060*/                   FMUL R3, R3, R6 ;         /* 0x00000a00 */
        /*0070*/                   IADD3 R2, R2, 0x10, RZ ;  /* 0x00000a00 */
        /*0080*/              @!P1 BRA 0x10 ;                /* 0x00000a00 */
        /*0090*/                   EXIT ;                    /* 0x00000a00 */
        /*00a0*/                   BRA 0xa0;                 /* 0x00000a00 */
"""


def test_sass_report_cuts_loops_into_blocks():
    kernels = sass.parse(LISTING)
    instrs = kernels["_Z6kernelPf"]
    assert len(instrs) == 11
    assert [op for _, op, _ in instrs[:5]] == ["MOV", "LDS", "FFMA",
                                               "FSETP", "BRA"]
    # The branch to itself (a trap) is no loop; the loop is 0x10-0x80.
    assert sass.loops(instrs) == [(0x10, 0x80)]
    blocks = sass.blocks(instrs, 0x10, 0x80)
    assert [(b[0][0], b[-1][0], len(b)) for b in blocks] == [
        (0x10, 0x40, 4), (0x50, 0x60, 2), (0x70, 0x80, 2)]
    lines = sass.report(LISTING, "kernel")
    assert lines[0] == "_Z6kernelPf: 11 instructions"
    assert lines[2].split()[:3] == ["0x0010-0x0040", "4", "instructions"]
    assert "fp32 1 compare 1 mufu 0 lds 1 branch 1" in lines[2]
    assert "fp32 1 compare 0 mufu 1 lds 0 branch 0" in lines[3]
    assert sass.report(LISTING, "other") == []


def test_compare_datagen_runs_both_checkouts_in_turns(capsys):
    times = compare_datagen.main([
        compare_datagen.ROOT, "--rounds", "1", "--device", "cpu", "--",
        "--renderer", "wavefront", "--count", "1", "--width", "16",
        "--height", "16", "--tile_size", "16", "--spp", "1", "--gt_spp",
        "2"])
    out = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in out[:-1]] == [
        "parent (builds its kernels)", "change (builds its kernels)",
        "parent", "change", "change", "parent"]
    assert len(times["parent"]) == 2 and len(times["change"]) == 2
    assert all(t > 0 for side in times.values() for t in side)
