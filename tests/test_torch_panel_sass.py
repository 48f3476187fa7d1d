"""tools/torch_panel_sass.py: the tensor-core and spill counts of the panel
and tile kernels (the E-step's variants and spd_chol's) read from a
cuobjdump listing (a small hand-made
listing here; the real one is made on the card, SKILL.md's ptxas command)."""

import importlib.util
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("torch_panel_sass", ROOT / "tools" / "torch_panel_sass.py")
sass = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(sass)

LISTING = """
	code for sm_90a
		Function : _ZN4ppca5panel16spd_panel_kernelIfLi0EEEvPKT_xS4_S4_S4_S4_PS2_S5_S5_S5_S5_xi
	.headerflags	@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   STL [R1], R2 ;
        /*0020*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;
        /*0030*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;
        /*0040*/                   LDL R2, [R1] ;
        /*0050*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;
        /*0060*/                   EXIT ;
		Function : _ZN4ppca5panel16spd_panel_kernelIdLi5EEEvPKT_xS4_S4_S4_S4_PS2_S5_S5_S5_S5_xi
        /*0000*/                   DMMA.8x8x4 R4, R8, R12, R4 ;
        /*0010*/                   DMMA.8x8x4 R4, R8, R12, R4 ;
        /*0020*/                   EXIT ;
		Function : _ZN4ppca4tile21spd_estep_tile_kernelIfLi64ELi5EEEvPKT_xS4_S4_S4_S4_PS2_S5_S5_S5_xi
        /*0000*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;
        /*0010*/                   EXIT ;
		Function : _ZN4ppca4tile9stage_rowIfEEvPT_PKS2_iiii
        /*0000*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;
		Function : _ZN4ppca4tile21spd_estep_tile_kernelIfLi64ELi0EEEvPKT_xS4_S4_S4_S4_PS2_S5_S5_S5_xi
        /*0000*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;
        /*0010*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;
        /*0020*/                   EXIT ;
		Function : _ZN4ppca4tile22spd_estep_small_kernelIdLi16ELi2EEEvPKT_xS4_S4_S4_S4_PS2_S5_S5_S5_xi
        /*0000*/                   SHFL.IDX R4, R8, R12, R4 ;
        /*0010*/                   EXIT ;
"""


def test_counts_per_panel_kernel(tmp_path, capsys):
    path = tmp_path / "listing.sass"
    path.write_text(LISTING)
    sass.main([str(path)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 5  # a function that is no kernel of either design is not counted
    assert lines[0].startswith("spd_panel_kernel<float, 0>: HMMA.TF32 3, DMMA 0, local loads+stores 2")
    assert "runs: 3 mma/1 spill" in lines[0]  # the LDL between the products
    assert lines[1].startswith("spd_panel_kernel<double, 5>: HMMA.TF32 0, DMMA 2, local loads+stores 0")
    assert "runs: 2 mma/0 spill" in lines[1]


def test_runs_split_at_long_gaps():
    body = ["HMMA.1688.F32.TF32 ;"] * 2 + ["IADD3 ;"] * sass.GAP + ["HMMA.1688.F32.TF32 ;", "STL ;"]
    tf32, dmma, spills, runs = sass.summary(body)
    assert (tf32, dmma, spills) == (3, 0, 1)
    assert runs == [(2, 0), (1, 0)]  # the STL after the last product lies outside its run


def test_counts_per_estep_tile_kernel(tmp_path, capsys):
    """The tile's blocked body (float, KP=64: spd_chol's want 5 and fullt)
    and one-block body (double, KP=16, llk) are reported by their template
    arguments."""
    path = tmp_path / "listing.sass"
    path.write_text(LISTING)
    sass.main([str(path)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[2].startswith("spd_estep_tile_kernel<float, 64, 5>: HMMA.TF32 1, DMMA 0, "
                               "local loads+stores 0")
    assert "runs: 1 mma/0 spill" in lines[2]
    assert lines[3].startswith("spd_estep_tile_kernel<float, 64, 0>: HMMA.TF32 2, DMMA 0, "
                               "local loads+stores 0")
    assert "runs: 2 mma/0 spill" in lines[3]
    assert lines[4].startswith("spd_estep_small_kernel<double, 16, 2>: HMMA.TF32 0, DMMA 0, "
                               "local loads+stores 0")
