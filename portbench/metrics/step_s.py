"""step_s: the window's seconds over the steps it completed."""


def read(run):
    done = run.completed
    return run.window_s / len(done) if done else None
