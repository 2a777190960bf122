"""solver_setup_s: host seconds of the solver's set-up (`setup.solver`: the
element tables, the coarse space) and of its graphs' captures
(`setup.capture`), each ending in a synchronise, from the program's
set-up spans."""

import program_spans


def read(run):
    return program_spans.setup_seconds()
