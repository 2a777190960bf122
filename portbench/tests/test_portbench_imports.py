"""What a run may load: no JAX and not the JAX package, anywhere in the
benchmark; and the reference nothing of the program."""

import portbench_paths  # noqa: F401  (first: the paths)
import json
import pathlib
import subprocess
import sys

PORTBENCH = portbench_paths.PORTBENCH

LOAD_ALL = """
import importlib, json, pathlib, sys
root = pathlib.Path(sys.argv[1])
sys.path[:0] = [str(root), str(root.parent)]
import harness
for path in sorted(root.rglob("*.py")):
    rel = path.relative_to(root)
    if rel.parts[0] == "tests":
        continue
    if rel.parts[0] == "metrics":
        harness.reader(path.stem)
    else:
        importlib.import_module(".".join(rel.with_suffix("").parts).removesuffix(".__init__"))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE_ONLY = """
import json, pathlib, sys
root = pathlib.Path(sys.argv[1])
sys.path[:0] = [str(root), str(root.parent)]
import reference, reference.fem, reference.mesh, judge
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level(script):
    out = subprocess.run([sys.executable, "-c", script, str(PORTBENCH)], capture_output=True,
                         text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_no_file_of_the_benchmark_loads_jax_or_the_jax_package():
    loaded = _top_level(LOAD_ALL)
    assert "fea_large_tpu_torch" in loaded  # the program is there, under its own name
    assert not loaded & {"jax", "jaxlib", "flax", "fea_large_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    loaded = _top_level(REFERENCE_ONLY)
    assert not loaded & {"jax", "jaxlib", "flax", "fea_large_tpu", "fea_large_tpu_torch"}


def test_the_harness_names_forbidden_modules_by_their_top_level_name():
    import harness

    sys.modules["fea_large_tpu.fake"] = sys.modules[__name__]
    try:
        assert harness.forbidden_modules() == ["fea_large_tpu"]
    finally:
        del sys.modules["fea_large_tpu.fake"]
    assert "fea_large_tpu_torch" not in harness.FORBIDDEN
