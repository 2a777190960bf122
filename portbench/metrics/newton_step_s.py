"""newton_step_s: the window's seconds over its Newton steps (the
upstream benchmark's seconds per Newton step, as a layer view)."""


def read(run):
    steps = sum(r["newton"] for r in run.records if r["newton"] is not None)
    return run.window_s / steps if steps else None
