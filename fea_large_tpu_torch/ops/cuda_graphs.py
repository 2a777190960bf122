"""CUDA graphs with IF nodes over bodies captured by PyTorch (the binding of
csrc/graph_kernels.cu).

`Body(fn)` captures one call of `fn` into a CUDA graph of its own (a
private memory pool, kept as long as the Body lives: the programs built
from it use its addresses). `Program(items)` composes a chain of bodies,
each either run or run under IF(flag), a 0-d bool tensor on the card read
when the chain reaches it, and instantiates it; `launch()` runs it on the
current stream. The device-resident Newton loop (solvers/device_loop.py)
is built from these. A failed capture, composition or launch raises;
nothing runs eagerly in its place.
"""

from __future__ import annotations

import ctypes

import torch

from fea_large_tpu_torch.ops import cuda_build

SOURCE = cuda_build.CSRC / "graph_kernels.cu"
_READY: set = set()


def _library():
    P = ctypes.c_void_p
    lib = cuda_build.load(SOURCE, {
        "fea_graph_init": [],
        "fea_graph_compose": [ctypes.c_int, P, P, P, P],
        "fea_graph_launch": [P, P],
        "fea_graph_node_count": [P, P],
        "fea_graph_destroy": [P, P],
    })
    if SOURCE not in _READY:
        _check("fea_graph_init", lib.fea_graph_init())
        _READY.add(SOURCE)
    return lib


def _check(fn: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{fn} failed: CUDA error {err}")


class Body:
    """One call of `fn` captured into a CUDA graph (PyTorch's capture, on a
    side stream; `fn` must read and write only tensors that outlive the
    Body, or allocate inside the capture). `nodes` is its node count."""

    def __init__(self, fn):
        _library()
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(self.graph):
            fn()
        count = ctypes.c_size_t()
        _check("fea_graph_node_count", _library().fea_graph_node_count(
            ctypes.c_void_p(self.graph.raw_cuda_graph()), ctypes.byref(count)))
        self.nodes = count.value


class Program:
    """A chain of `(body, flag)` items, flag None (always) or a 0-d bool CUDA
    tensor (IF node). `nodes` counts every node it runs when all flags are
    set: the bodies' nodes and, per IF, its set kernel and the IF node."""

    def __init__(self, items):
        self._items = list(items)  # the bodies and flags must outlive the graph
        for _, flag in self._items:
            if flag is not None and (flag.dtype != torch.bool or flag.numel() != 1
                                     or flag.device.type != "cuda"):
                raise ValueError("an IF flag is a 0-d bool tensor on the card")
        n = len(self._items)
        bodies = (ctypes.c_void_p * n)(*(b.graph.raw_cuda_graph() for b, _ in self._items))
        flags = (ctypes.c_void_p * n)(*(None if f is None else f.data_ptr() for _, f in self._items))
        self._graph, self._exec = ctypes.c_void_p(), ctypes.c_void_p()
        _check("fea_graph_compose", _library().fea_graph_compose(
            n, bodies, flags, ctypes.byref(self._graph), ctypes.byref(self._exec)))
        self.nodes = sum(b.nodes + (0 if f is None else 2) for b, f in self._items)

    def launch(self) -> None:
        stream = torch.cuda.current_stream().cuda_stream
        _check("fea_graph_launch", _library().fea_graph_launch(self._exec, ctypes.c_void_p(stream)))

    def __del__(self):
        if getattr(self, "_exec", None) and self._exec.value:
            _library().fea_graph_destroy(self._graph, self._exec)
