"""The plain reference: masked PPCA and PPCA mixtures in plain PyTorch.

It imports nothing of ``ppca_rs_tpu_torch`` and takes nothing the program
made: it gets the rows, masks and parameters the benchmark made from the
seed, and works everything else out again.  It runs in float64
(:data:`linalg.F64`), and as the control in TF32 (:data:`linalg.TF32`).
"""
