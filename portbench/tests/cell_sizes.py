"""Each cell's size in the CPU tests, a file of its own:
portbench/tests/cells/<cell>.json holds the overrides (`harness.Cell`) that
the cell's CPU runs take ({"mesh": {"n": 3}}; a "traffic" entry changes
the mix), and under "faults" what the runs with a fault planted add to
them. A cell whose configuration has `ranks` > 1 runs in
test_portbench_sharded.py, every other in test_portbench_cells.py; a cell
is added with its file alone.

kuhn-sharded: one x-cell layer a rank and fewer cells across, as in config
5's box; the mix's warm-up cut to its first three requests, which build and
capture (the rest carries the cards past their slow start, which the CPU
has not); a faulty solve's PCG stopped at 200 iterations (a fault that
breaks the exchange runs every Newton iteration to pcg_maxiter)."""

import portbench_paths  # noqa: F401  (first: the paths)
import json

import harness

PORTBENCH = portbench_paths.PORTBENCH
DIR = PORTBENCH / "tests" / "cells"


def sizes() -> dict:
    """{cell: its file's contents} of every file under tests/cells/."""
    return {p.stem: json.loads(p.read_text()) for p in sorted(DIR.glob("*.json"))}


def overrides(cell: str, fault: bool = False) -> dict:
    """The overrides of the cell's CPU runs; with `fault`, those of its
    runs with a fault planted."""
    size = dict(sizes()[cell])
    faults = size.pop("faults", {})
    if fault:
        size.update({group: {**size.get(group, {}), **changes}
                     for group, changes in faults.items()})
    return size


def cell(name: str, fault: bool = False) -> "harness.Cell":
    """The cell at its CPU size (`overrides`)."""
    return harness.Cell(PORTBENCH.parent, name, overrides(name, fault))


def ranks(cell: str) -> int:
    """The ranks of the cell's configuration (1 for a name that
    BENCHMARK.json does not have: the coverage test names it)."""
    try:
        return harness.Cell(PORTBENCH.parent, cell).config.get("ranks", 1)
    except harness.CellError:
        return 1


ONE_CARD = [c for c in sizes() if ranks(c) == 1]
SHARDED = [c for c in sizes() if ranks(c) > 1]
