"""assembly_ms: device milliseconds of one assembly of the global f64 BCSR
stiffness (the element stiffness and force, the slot sums and the nodal
sum) per assembly, from the program's `stiffness` and `assemble` spans."""

import program_spans


def read(run):
    return program_spans.per_run_ms(program_spans.device_totals(), ("stiffness", "assemble"),
                                    "assemble")
