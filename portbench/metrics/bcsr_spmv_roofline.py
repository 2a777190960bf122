"""bcsr_spmv_roofline: percent of its f64 bound that the BCSR product B10
reaches: its mean device time a call under the graph launches in the
trace against bcsr_yardstick.spmv_work."""

import bcsr_yardstick
import readers

#: B10 is `spmv_kernel<T>` (fea_large_tpu_torch/csrc/bcsr_kernels.cu), in an
#: anonymous namespace; the f64 route runs its double instance alone
KERNEL = "spmv_kernel<"


def read(run):
    return readers.roofline(run, lambda name: KERNEL in name, bcsr_yardstick.spmv_work,
                            "float64")
