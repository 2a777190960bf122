"""PyTorch port: every public name the reference's package and subpackage
`__init__` files export is importable from the port's counterpart.

The reference's names are read from its `__init__.py` sources (the names
of its `from ... import ...` statements), so nothing of JAX is imported.
Left out, by name: `compiled_cost` (XLA's cost analysis of a jitted
function; no PyTorch counterpart) and the pytree hooks (`tree_flatten`,
`tree_unflatten`). Importing the port's package builds or loads no CUDA
library.
"""

import ast
import importlib
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXCLUDED = {"compiled_cost", "tree_flatten", "tree_unflatten"}
PACKAGES = ["", "assembly", "elements", "mesh", "ops", "solvers", "utils", "io", "dist",
            "materials"]


def _exported(package: str) -> set:
    """The names the reference's `package` `__init__.py` imports."""
    path = ROOT / "fea_large_tpu" / package / "__init__.py"
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return names - EXCLUDED


@pytest.mark.parametrize("package", PACKAGES, ids=lambda p: p or "top")
def test_reference_exports_are_importable(package):
    names = _exported(package)
    assert names, f"no exports read from fea_large_tpu/{package}/__init__.py"
    module = importlib.import_module(".".join(filter(None, ["fea_large_tpu_torch", package])))
    missing = sorted(n for n in names if not hasattr(module, n))
    assert not missing, f"fea_large_tpu_torch.{package} lacks {missing}"


def test_package_import_loads_no_cuda_library():
    code = ("import sys, fea_large_tpu_torch, fea_large_tpu_torch.solvers, "
            "fea_large_tpu_torch.assembly, fea_large_tpu_torch.io; "
            "from fea_large_tpu_torch.ops import cuda_build; "
            "assert not cuda_build._LOADED, cuda_build._LOADED; "
            "assert 'jax' not in sys.modules and 'fea_large_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=300)
