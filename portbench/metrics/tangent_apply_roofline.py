"""tangent_apply_roofline: percent of its bound that the f32 tangent action
reaches (B1 on the Kuhn lattice, B6 on unstructured meshes): its mean
device time a call under the graph launches in the trace against
yardstick.tangent_apply_work."""

import readers
import yardstick

#: B1 is `apply_kernel<float, Q, NPE, T>` (csrc/struct_kernels.cu), B6
#: `apply_kernel<Q, NPE>` (csrc/elem_kernels.cu), each in an anonymous
#: namespace
KERNEL = "apply_kernel<"


def read(run):
    return readers.roofline(run, lambda name: KERNEL in name,
                            yardstick.tangent_apply_work, "float32")
