"""Imported first by the benchmark's CPU tests (`python -m pytest
portbench/tests -q`): puts portbench/ and the checkout on sys.path, as
portbench/run.py does, and keeps each test process to one thread of
PyTorch (the runs here are small, and workers run side by side)."""

import pathlib
import sys

PORTBENCH = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(PORTBENCH), str(PORTBENCH.parent)]

import torch  # noqa: E402

torch.set_num_threads(1)
