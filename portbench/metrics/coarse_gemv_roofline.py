"""coarse_gemv_roofline: percent of its bound that the product with the
stored coarse inverse reaches: its mean device time a call under the graph
launches in the trace against yardstick.coarse_gemv_work."""

import readers
import yardstick

#: cuBLAS's kernels for the bf16 inverse times a vector, as the traces of an
#: H100 (torch 2.11, CUDA 12.8) name them: the cuBLASLt kernel at dim 7,776
#: (Kuhn) and the bf16 gemv at dim 20,250 (5-tet)
NVJET = ("nvjet_tst_64x8_64x16_2x1_v_bz_TNT",)
GEMV = "gemv2T_kernel_val<"
BF16 = "__nv_bfloat16"


def is_gemv(name: str) -> bool:
    return name in NVJET or (GEMV in name and BF16 in name)


def read(run):
    return readers.roofline(run, is_gemv, yardstick.coarse_gemv_work,
                            run.config["coarse"]["storage"])
