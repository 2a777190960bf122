"""assembly_roofline: percent of its f64 bound that one assembly of the
global BCSR stiffness reaches: its device milliseconds, the spans
`stiffness` and `assemble` over the `assemble` runs (what assembly_ms
reads), against assembly_yardstick.assembly_work."""

import assembly_yardstick
import program_spans
import yardstick


def read(run):
    ms = program_spans.per_run_ms(program_spans.device_totals(), ("stiffness", "assemble"),
                                  "assemble")
    if not ms:
        return None
    return yardstick.roofline_share(assembly_yardstick.assembly_work(run.config), "float64",
                                    1e-3 * ms)
