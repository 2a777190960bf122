"""newton_head_ms: device milliseconds of a Newton iteration's head in the
device loop (freeze, the residual, the stop test and forcing, block-Jacobi,
pcg_init) per head, from the program's spans."""

import program_spans


def read(run):
    return program_spans.per_run_ms(program_spans.device_totals(), program_spans.NEWTON_HEAD,
                                    "freeze")
