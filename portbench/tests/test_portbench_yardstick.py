"""The work counted for the rooflines, pinned at full width."""

import portbench_paths  # noqa: F401  (first: the paths)
import json
import pathlib

import yardstick

CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "configs"


def _config(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_tangent_apply_bytes():
    # B1, Kuhn n=35: C = 42,875 cells, rows 2*81 + 3*216 + 2*24 = 858 f32
    # a cell, plus 3,864 B of tables
    assert yardstick.tangent_apply_work(_config("kuhn-tet10-1m"))[0] == 858 * 4 * 42_875 + 3_864
    assert yardstick.tangent_apply_work(_config("kuhn-tet10-1m"))[0] == 147_150_864
    # B6, 5-tet n=36: E = 233,280 tets, 300 f32 each
    assert yardstick.tangent_apply_work(_config("5tet-tet10-1m"))[0] == 279_936_000


def test_coarse_gemv_bytes():
    assert yardstick.coarse_gemv_work(_config("kuhn-tet10-1m"))[0] == 2 * (7_776**2 + 2 * 7_776)
    assert yardstick.coarse_gemv_work(_config("5tet-tet10-1m"))[0] == 2 * (20_250**2 + 2 * 20_250)
    assert round(7_776**2 * 2 / 1e6) == 121 and round(20_250**2 * 2 / 1e6) == 820


def test_bounds_are_bytes_bound():
    for name in ("kuhn-tet10-1m", "5tet-tet10-1m"):
        c = _config(name)
        nbytes, flops = yardstick.tangent_apply_work(c)
        assert yardstick.bound_s((nbytes, flops), "float32") == nbytes / yardstick.HBM_BYTES_S
        nbytes, flops = yardstick.coarse_gemv_work(c)
        assert yardstick.bound_s((nbytes, flops), "bfloat16") == nbytes / yardstick.HBM_BYTES_S
    assert abs(yardstick.bound_s((147_150_864, 0), "float32") * 1e3 - 0.0439) < 1e-4
