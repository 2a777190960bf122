"""step_prepare_ms: device milliseconds of a step's eager set-up
(`_mixed_prepare`: the f64 residual, the freeze, block-Jacobi, the operand
copies and the chunk's start) from its first stamp to the PCG chunk's
first body, per step, from the program's spans."""

import program_spans


def read(run):
    return program_spans.per_run_ms(program_spans.device_totals(), program_spans.STEP_PREPARE,
                                    "step_refresh")
