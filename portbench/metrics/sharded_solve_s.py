"""sharded_solve_s: solve_s's reading (metrics/solve_s.py), the window's
seconds over the increments it converged, on the sharded solver's ranks
(rank 0's clock)."""

import harness

read = harness.reader("solve_s").read
