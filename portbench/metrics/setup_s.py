"""setup_s: seconds from the process's start to the window's (loading,
building, the solver's set-up, warm-up and capture)."""


def read(run):
    return run.setup_s
