"""CUDA graphs with IF and WHILE nodes over bodies captured by PyTorch (the
binding of csrc/graph_kernels.cu).

`Body(fn)` captures one call of `fn` into a CUDA graph of its own (a
private memory pool, kept as long as the Body lives: the programs built
from it use its addresses). `Program(items)` composes a chain of bodies,
each run once, under IF(flag) or under `While(flag)`, a flag being a 0-d
bool tensor on the card read when the chain reaches it (and, for WHILE,
again after each run of the body), and instantiates it; `launch()` runs it
on the current stream. The device-resident Newton loop
(solvers/device_loop.py) and the PCG chunks (solvers/linear.py) are built
from these. A failed capture, composition or launch raises; nothing runs
eagerly in its place.

Launch counts: the kernel wrappers count a launch when they are called. A
capture calls them and launches nothing, so `Body` records the counts its
capture added (`Body.launches`) and takes them back; what the replays
launch is added to `REPLAYED` by `tally`, from the bodies' runs that the
programs count on the card.
"""

from __future__ import annotations

import ctypes
import gc

import torch

from fea_large_tpu_torch.ops import bcsr_kernels as bk
from fea_large_tpu_torch.ops import cuda_build
from fea_large_tpu_torch.ops import elem_kernels as ek
from fea_large_tpu_torch.ops import struct_kernels as sk

SOURCE = cuda_build.CSRC / "graph_kernels.cu"
_READY: set = set()

#: the kernel wrappers' launch counters, by kernel family
_COUNTERS = {"struct": sk.LAUNCHES, "elem": ek.LAUNCHES, "bcsr": bk.LAUNCHES}
#: kernel launches made by replayed graphs (launches per capture x runs),
#: by name ("struct_apply", ...)
REPLAYED = {f"{p}_{k}": 0 for p, c in _COUNTERS.items() for k in c}

#: item kinds of `fea_graph_compose`
_ALWAYS, _IF, _WHILE = 0, 1, 2


def launch_counts() -> dict:
    """The kernel wrappers' launch counters, by name ("struct_apply", ...)."""
    return {f"{p}_{k}": v for p, c in _COUNTERS.items() for k, v in c.items()}


def _set_counts(counts: dict) -> None:
    for p, c in _COUNTERS.items():
        for k in c:
            c[k] = counts[f"{p}_{k}"]


def collect_garbage() -> None:
    """Collect unreachable objects now, before a capture: a graph or a graph
    pool that the cyclic collector frees in the middle of a capture (its
    cudaGraphExecDestroy, its pool's cudaFree) invalidates that capture."""
    gc.collect()


def tally(per_capture: dict, runs: dict) -> None:
    """Add to `REPLAYED` what `runs[body]` replays of each body launched,
    given each body's launches per capture (`per_capture[body]`)."""
    for body, counts in per_capture.items():
        for kernel, c in counts.items():
            REPLAYED[kernel] += c * runs[body]


def _library():
    P = ctypes.c_void_p
    lib = cuda_build.load(SOURCE, {
        "fea_graph_init": [],
        "fea_graph_compose": [ctypes.c_int, P, P, P, P, P],
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
    side stream, with the cyclic garbage collector paused; `fn` must read
    and write only tensors that outlive the Body, or allocate inside the
    capture). `nodes` is its node count, `launches` the kernel launches one
    replay makes, by name."""

    def __init__(self, fn):
        _library()
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        before = launch_counts()
        collecting = gc.isenabled()
        gc.disable()  # no graph may be freed inside the capture (`collect_garbage`)
        try:
            with torch.cuda.graph(self.graph):
                fn()
        finally:
            if collecting:
                gc.enable()
            after = launch_counts()
            _set_counts(before)
        self.launches = {k: after[k] - before[k] for k in after if after[k] > before[k]}
        count = ctypes.c_size_t()
        _check("fea_graph_node_count", _library().fea_graph_node_count(
            ctypes.c_void_p(self.graph.raw_cuda_graph()), ctypes.byref(count)))
        self.nodes = count.value


class While:
    """The condition of a WHILE item: its body runs while `flag` is set,
    tested before the first run and after each."""

    def __init__(self, flag: torch.Tensor):
        self.flag = flag


class Program:
    """A chain of `(body, cond)` items: cond None (run once), a 0-d bool
    CUDA tensor (IF node) or `While(flag)` (WHILE node). `nodes` counts the
    nodes of one pass with every condition set and every loop run once:
    the bodies' nodes, per IF its set kernel and the IF node, per WHILE
    two set kernels and the WHILE node."""

    def __init__(self, items):
        self._items = list(items)  # the bodies and flags must outlive the graph
        kinds, flags = [], []
        for _, cond in self._items:
            flag = cond.flag if isinstance(cond, While) else cond
            if flag is not None and (flag.dtype != torch.bool or flag.numel() != 1
                                     or flag.device.type != "cuda"):
                raise ValueError("an IF or WHILE flag is a 0-d bool tensor on the card")
            kinds.append(_ALWAYS if cond is None else _WHILE if isinstance(cond, While) else _IF)
            flags.append(None if flag is None else flag.data_ptr())
        n = len(self._items)
        bodies = (ctypes.c_void_p * n)(*(b.graph.raw_cuda_graph() for b, _ in self._items))
        flag_ptrs = (ctypes.c_void_p * n)(*flags)
        kind_arr = (ctypes.c_int * n)(*kinds)
        self._graph, self._exec = ctypes.c_void_p(), ctypes.c_void_p()
        _check("fea_graph_compose", _library().fea_graph_compose(
            n, bodies, flag_ptrs, kind_arr, ctypes.byref(self._graph), ctypes.byref(self._exec)))
        self.nodes = sum(b.nodes + (0, 2, 3)[k] for (b, _), k in zip(self._items, kinds))

    def launch(self) -> None:
        stream = torch.cuda.current_stream().cuda_stream
        _check("fea_graph_launch", _library().fea_graph_launch(self._exec, ctypes.c_void_p(stream)))

    def __del__(self):
        if getattr(self, "_exec", None) and self._exec.value:
            _library().fea_graph_destroy(self._graph, self._exec)
