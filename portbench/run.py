"""The benchmark of fea_large_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Sets up the cell's configuration on the card,
warms up the shapes its traffic uses, serves requests for `--seconds`,
(with `--trace 1` profiles a few more), checks the sampled answers against
the plain f64 reference, and prints one JSON line last on standard output:
correct, attempted, failed, metrics (the cell's end-to-end metrics, or with
`--trace 1` its per-layer metrics), device and, traced, breakdown; the
numbers compared, each beside its limit, come last in it and as the last
lines on standard error. Without a CUDA card, or with fewer than the cell
asks for, it exits 2 and prints no result; it exits 3 if a JAX module or
the JAX package is loaded once the window has closed, in this process or in
any rank of a cell over several cards.
"""

import os
import pathlib
import sys
import time


def process_age() -> float:
    """Seconds since this process started (Linux; 0 elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 0.0
    return max(uptime - ticks / os.sysconf("SC_CLK_TCK"), 0.0)


T_START = time.perf_counter() - process_age()
HERE = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]


def main(argv=None) -> int:
    import argparse
    import json

    import harness

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        out = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), T_START)
    except harness.CellError as e:
        print(e, file=sys.stderr)
        return 2
    except harness.Forbidden as e:
        print(e, file=sys.stderr)
        return 3
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    if out["setup_built_kernels_s"]:
        print(f"portbench: set-up built the program's kernels ({out['setup_built_kernels_s']:.1f} s "
              f"of nvcc): the checkout's first run", file=sys.stderr)
    for name, c in out["checked"].items():
        print(f"checked {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
