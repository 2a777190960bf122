"""pcg_iter_ms: device milliseconds of one PCG iteration (the device loop's
cg body, the PCG chunk's step body), from the program's `pcg_iteration`
span."""

import program_spans


def read(run):
    return program_spans.per_run_ms(program_spans.device_totals(), ("pcg_iteration",),
                                    "pcg_iteration")
