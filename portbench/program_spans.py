"""The program's own spans, as the per-layer readers read them: the only
way from metrics/<name>.py into fea_large_tpu_torch's span registry
(utils/profiling.py). The totals are cumulative over the process (the
warm-up included); a device span's runs and nanoseconds come from the
card's `%globaltimer`, read by a one-thread stamp kernel the program
launches at each boundary, and reach the host in the batched fetch each
request already makes. Where the program keeps no such registry (a
checkout older than its spans) or no card ran it, the readers get None.
"""

from __future__ import annotations

import torch

from fea_large_tpu_torch.utils import profiling

#: the spans of a Newton iteration's head in the device loop, up to its CG
#: iterations: `pre` (freeze), the f32 or f64 residual, `post` (the stop
#: test and forcing, the block-Jacobi set-up, pcg_init)
NEWTON_HEAD = ("freeze", "residual32", "residual64", "newton_check", "jacobi", "pcg_init")
#: the spans of a step's eager set-up (`_mixed_prepare`) up to its PCG
#: chunk's first body
STEP_PREPARE = ("residual64", "freeze", "jacobi", "step_refresh")
#: the set-up phases that `solver_setup_s` sums (setup.coarse is a child of
#: setup.solver)
SOLVER_SETUP = ("setup.solver", "setup.capture")


def device_totals() -> dict | None:
    """{span: (runs, nanoseconds)} of the program's device spans so far,
    or None where it keeps none or ran on no card."""
    totals = getattr(profiling, "SPAN_TOTALS", None)
    if not totals or not torch.cuda.is_available():
        return None
    return {name: (int(v[0]), int(v[1])) for name, v in totals.items()}


def per_run_ms(totals: dict | None, names, per: str) -> float | None:
    """Milliseconds of the spans `names` over the runs of span `per`; None
    where there are no totals or `per` never ran."""
    if totals is None or totals.get(per, (0, 0))[0] <= 0:
        return None
    return 1e-6 * sum(totals.get(n, (0, 0))[1] for n in names) / totals[per][0]


def setup_seconds(names=SOLVER_SETUP) -> float | None:
    """Host seconds of the set-up phases `names`; None where none ran."""
    setup = getattr(profiling, "SETUP", None)
    found = [setup.totals[n] for n in names if setup is not None and n in setup.totals]
    return float(sum(found)) if found else None
