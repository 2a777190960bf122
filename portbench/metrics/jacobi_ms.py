"""jacobi_ms: device milliseconds of a block-Jacobi set-up (the diagonal
blocks of the frozen tangent and their inverse) per run, from the
program's `jacobi` span."""

import program_spans


def read(run):
    return program_spans.per_run_ms(program_spans.device_totals(), ("jacobi",), "jacobi")
