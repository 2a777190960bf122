"""CUDA graphs with IF and WHILE nodes over bodies captured by PyTorch (the
binding of csrc/graph_kernels.cu), and the one host of the port's captured
programs.

`Body(fn)` captures one call of `fn` into a CUDA graph of its own (a
private memory pool, kept as long as the Body lives: the programs built
from it use its addresses). `Program(items)` composes a chain of items,
each a body or a chain of items in its own right, run once, under
IF(flag) or under `While(flag)`, a flag being a 0-d bool tensor on the card
read when the chain reaches it (and, for WHILE, again after each run of
its chain), and instantiates it; conditionals nest. `launch()` runs it on
the current stream.

`Host` holds one set of named bodies and the programs made of them: the
device-resident Newton loop (solvers/device_loop.py), each PCG chunk
(solvers/linear.py), and a sharded rank, whose programs its route's chunk
runs over the rank's bodies and its own (dist/sharded.py). Each writes its
bodies as functions and its programs as chains of (kind, flag, what)
items; the host stamps each body, counts its runs on the device, captures
the bodies on the card, composes the chains into `Program`s and launches
them, or runs the chains eagerly with the functions (the CPU's route).
`fetch` is the one batched fetch after a launch. A failed capture,
composition or launch raises; nothing runs eagerly in its place.

Launch counts: the kernel wrappers count a launch when they are called. A
capture calls them and launches nothing, so `Body` records the counts its
capture added (`Body.launches`) and takes them back; what the replays
launch is added to `REPLAYED` by `fetch`, from the bodies' runs that the
programs count on the card.

`stamp` launches the span stamp of utils/profiling.py (one thread, in
csrc/graph_kernels.cu beside the set kernel); no launch counter counts it.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import time

import torch

from fea_large_tpu_torch.ops import bcsr_kernels as bk
from fea_large_tpu_torch.ops import cuda_build
from fea_large_tpu_torch.ops import elem_kernels as ek
from fea_large_tpu_torch.ops import struct_kernels as sk
from fea_large_tpu_torch.utils import profiling

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


def _library():
    P = ctypes.c_void_p
    lib = cuda_build.load(SOURCE, {
        "fea_graph_init": [],
        "fea_graph_compose": [ctypes.c_int, P, P, P, P, P, P],
        "fea_graph_try_child": [P],
        "fea_graph_refused": [P, ctypes.c_char_p, ctypes.c_int],
        "fea_graph_launch": [P, P],
        "fea_graph_node_count": [P, P],
        "fea_graph_destroy": [P, P],
        "fea_span_stamp": [P, P, ctypes.c_int, P, P],
    })
    if SOURCE not in _READY:
        _check("fea_graph_init", lib.fea_graph_init())
        _READY.add(SOURCE)
    return lib


def stamp(table: torch.Tensor, open_: torch.Tensor, nxt: int, runs_ptr: int | None) -> None:
    """Launch the span stamp on the current stream: close the span open
    in `open_` into `table`, open span `nxt` (-1: none), and add one to the
    int64 at `runs_ptr` where it is given (utils/profiling.py)."""
    stream = torch.cuda.current_stream(table.device).cuda_stream
    _check("fea_span_stamp", _library().fea_span_stamp(
        ctypes.c_void_p(table.data_ptr()), ctypes.c_void_p(open_.data_ptr()), nxt,
        ctypes.c_void_p(runs_ptr), ctypes.c_void_p(stream)))


def _check(fn: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{fn} failed: CUDA error {err}")


class Body:
    """One call of `fn` captured into a CUDA graph (PyTorch's capture, on a
    side stream, with the cyclic garbage collector paused; `fn` must read
    and write only tensors that outlive the Body, or allocate inside the
    capture). `nodes` is its node count, `launches` the kernel launches one
    replay makes, by name, and `refused` the name of the first node type in
    it that a conditional node's body does not take ("" where none; the
    collectives of a sharded rank are captured into its bodies).

    The capture's error mode is "thread_local": it refuses the unsafe CUDA
    calls of this thread only, so that another thread's (the process
    group's watchdog querying its events) does not end it."""

    def __init__(self, fn):
        lib = _library()
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        before = launch_counts()
        collecting = gc.isenabled()
        gc.disable()  # no graph may be freed inside the capture (`collect_garbage`)
        try:
            with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
                fn()
        finally:
            if collecting:
                gc.enable()
            after = launch_counts()
            _set_counts(before)
        self.launches = {k: after[k] - before[k] for k in after if after[k] > before[k]}
        count = ctypes.c_size_t()
        raw = ctypes.c_void_p(self.graph.raw_cuda_graph())
        _check("fea_graph_node_count", lib.fea_graph_node_count(raw, ctypes.byref(count)))
        self.nodes = count.value
        name = ctypes.create_string_buffer(64)
        _check("fea_graph_refused", lib.fea_graph_refused(raw, name, len(name)))
        self.refused = name.value.decode()


class While:
    """The condition of a WHILE item: its body runs while `flag` is set,
    tested before the first run and after each."""

    def __init__(self, flag: torch.Tensor):
        self.flag = flag


class Program:
    """A chain of `(what, cond)` items: `what` a `Body` or a chain of
    items (a list or tuple of them), cond None (run once), a 0-d bool CUDA
    tensor (IF node) or `While(flag)` (WHILE node). Conditionals nest: a
    conditional's chain is appended into its node's own body graph. `nodes`
    counts the nodes of one pass with every condition set and every loop
    run once, the nested ones included: the bodies' nodes, per IF its set
    kernel and the IF node, per WHILE two set kernels and the WHILE node.
    A failed composition raises, and so does a body under a conditional
    that holds a node type CUDA refuses there (`Body.refused`), naming it."""

    def __init__(self, items):
        self._items = list(items)  # the bodies and flags must outlive the graph
        flat = []  # (parent, kind, body, flag pointer), in pre-order
        self.nodes = self._flatten(self._items, -1, flat)
        for parent, _, body, _ in flat:
            if body is not None and parent >= 0 and body.refused:
                raise RuntimeError(f"a body under an IF or WHILE node holds a {body.refused} "
                                   "node, which CUDA does not take in a conditional's body")
        n = len(flat)
        parents = (ctypes.c_int * n)(*(f[0] for f in flat))
        kinds = (ctypes.c_int * n)(*(f[1] for f in flat))
        bodies = (ctypes.c_void_p * n)(*(None if f[2] is None else f[2].graph.raw_cuda_graph()
                                         for f in flat))
        flags = (ctypes.c_void_p * n)(*(f[3] for f in flat))
        self._graph, self._exec = ctypes.c_void_p(), ctypes.c_void_p()
        _check("fea_graph_compose", _library().fea_graph_compose(
            n, bodies, flags, kinds, parents, ctypes.byref(self._graph),
            ctypes.byref(self._exec)))

    @staticmethod
    def _flatten(items, parent, flat) -> int:
        """Append `items` under `parent` to `flat`; returns their nodes."""
        nodes = 0
        for what, cond in items:
            if cond is None:
                if isinstance(what, Body):
                    flat.append((parent, _ALWAYS, what, None))
                    nodes += what.nodes
                else:
                    nodes += Program._flatten(what, parent, flat)
                continue
            flag = cond.flag if isinstance(cond, While) else cond
            if flag.dtype != torch.bool or flag.numel() != 1 or flag.device.type != "cuda":
                raise ValueError("an IF or WHILE flag is a 0-d bool tensor on the card")
            kind = _WHILE if isinstance(cond, While) else _IF
            here = len(flat)
            flat.append((parent, kind, None, flag.data_ptr()))
            chain = [(what, None)] if isinstance(what, Body) else what
            nodes += (0, 2, 3)[kind] + Program._flatten(chain, here, flat)
        return nodes

    def launch(self) -> None:
        stream = torch.cuda.current_stream().cuda_stream
        _check("fea_graph_launch", _library().fea_graph_launch(self._exec, ctypes.c_void_p(stream)))

    def __del__(self):
        if getattr(self, "_exec", None) and self._exec.value:
            _library().fea_graph_destroy(self._graph, self._exec)


def child_graph_error(program: Program) -> int:
    """The CUDA error of appending `program`'s composed graph to another
    graph as a child-graph node (0: taken). CUDA refuses a child graph that
    holds a conditional node, which is why nested chains are appended into
    the conditional nodes' own body graphs."""
    return _library().fea_graph_try_child(program._graph)


def _items(chain, bodies: dict, flags: dict) -> list:
    """A chain of (kind, flag, what) items as `Program` items."""
    out = []
    for kind, name, what in chain:
        what = bodies[what] if isinstance(what, str) else _items(what, bodies, flags)
        cond = None if kind is None else flags[name]
        out.append((what, While(cond) if kind == "while" else cond))
    return out


def _run_eager(chain, fns: dict, flags: dict) -> None:
    """A chain with the bodies' functions run eagerly, a Python `while` or
    `if` on each flag in place of its node (one host read of the flag per
    test)."""
    for kind, name, what in chain:
        while kind is None or bool(flags[name]):
            if isinstance(what, str):
                fns[what]()
            else:
                _run_eager(what, fns, flags)
            if kind != "while":
                break


class Host:
    """Named bodies and the programs made of them.

    Body i is the span stamp that opens `spans[i]` (utils/profiling.py)
    and adds one to `runs[i]` (int64, on the device), then the i-th
    function of `fns`. The programs, `chains` by name, are chains of
    (kind, flag, what) items: kind None (run once), "if" or "while"; flag
    the name of a 0-d bool tensor of `flags` (None where kind is None);
    what the name of a body, or a nested chain. After `join(other,
    chains)` the chains may name `other`'s bodies and flags too.

    `launch(prog)` runs the chain eagerly until `capture` (the CPU's
    route; on the card, a comparison), then one graph, composed at its
    first launch unless `compose` made it before (`programs`, their
    `graph_nodes`). `per_capture` is each body's kernel launches a replay,
    `capture_s` the seconds of the capture and the compositions."""

    def __init__(self, device, fns: dict, spans, flags: dict, chains: dict):
        self.device = torch.device(device)
        self.runs = torch.zeros(len(fns), dtype=torch.int64, device=self.device)
        self.spans = tuple(spans)
        self.fns = self._stamped(fns)
        self.flags, self.chains, self.others = dict(flags), dict(chains), ()
        self.bodies = None
        self.per_capture, self.programs, self.graph_nodes = {}, {}, {}
        self.capture_s = 0.0
        self._seen = [0] * len(fns)

    def _stamped(self, fns: dict) -> dict:
        """The bodies of the functions `fns` (the closures hold the tensors,
        not the host: a holder without a reference cycle goes, with its
        graphs, when its last reference does)."""
        device, runs = self.device, self.runs

        def body(i, span, fn):
            def count():  # the body's span opens; its runs count
                profiling.stamp(device, span, runs, i)
                fn()
            return count

        return {name: body(i, span, fn)
                for i, ((name, fn), span) in enumerate(zip(fns.items(), self.spans))}

    @property
    def captured(self) -> bool:
        return self.bodies is not None

    def join(self, other: "Host", chains: dict) -> None:
        self.others += (other,)
        self.chains.update(chains)

    def _merged(self, attr: str) -> dict:
        return {k: v for h in (self, *self.others) for k, v in getattr(h, attr).items()}

    def _on_device(self):
        """The host's card as the current CUDA device (a no-op on the CPU)."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def capture(self, warm=None, then=None) -> None:
        """Warm every body up (`_warm_up`; `warm()`, where given, makes the
        functions to warm up in place of `fns`: the same bodies on a
        scratch state, which goes before the capture), then run `then()`
        where given (a process group's first collectives), then capture
        each body. The warm-up's runs are taken back."""
        t0 = time.perf_counter()
        with self._on_device():
            self._warm_up(self.fns if warm is None else self._stamped(warm()))
            if then is not None:
                then()
            self.bodies = {name: Body(fn) for name, fn in self.fns.items()}
            self.per_capture = {name: b.launches for name, b in self.bodies.items()}
            self.runs.zero_()
            torch.cuda.synchronize(self.device)
        self.capture_s += time.perf_counter() - t0

    def _warm_up(self, fns: dict) -> None:
        """Run each body of `fns` once, in order, on a side stream, after
        collecting garbage (`collect_garbage`), and wait for the device: the
        first runs a capture needs (the allocator's blocks, the kernels'
        libraries, a process group's connections). The device's open span
        is closed before and after: no span covers the capture's host
        time."""
        device = self.device
        profiling.close_span(device)
        collect_garbage()
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for fn in fns.values():
                fn()
            profiling.close_span(device)
        current.wait_stream(side)
        torch.cuda.synchronize(device)

    def compose(self, prog: str) -> None:
        """Compose the chain `prog` of captured bodies into its `Program`."""
        t0 = time.perf_counter()
        with self._on_device():
            self.programs[prog] = Program(_items(self.chains[prog], self._merged("bodies"),
                                                 self._merged("flags")))
        self.graph_nodes[prog] = self.programs[prog].nodes
        self.capture_s += time.perf_counter() - t0

    def launch(self, prog: str) -> None:
        """Run the program `prog`: one launch of its graph once captured
        (composed first where it is not yet), else its chain eagerly."""
        if self.bodies is None:
            _run_eager(self.chains[prog], self._merged("fns"), self._merged("flags"))
        else:
            if prog not in self.programs:
                self.compose(prog)
            with self._on_device():
                self.programs[prog].launch()
        profiling.close_span(self.device)


class Hosted:
    """The capture's record of an object that runs its programs on a `Host`
    (`self.host`)."""

    captured = property(lambda self: self.host.captured)
    capture_s = property(lambda self: self.host.capture_s)
    per_capture = property(lambda self: self.host.per_capture)
    graph_nodes = property(lambda self: self.host.graph_nodes)


def fetch(tensors, *hosts: Host) -> tuple[list, list]:
    """The one batched fetch after a launch on `hosts` (on one device):
    the tensors' values, each host's `runs` and the device's span table in
    one `.tolist()`. Reads the span table (`profiling.read_spans`) and adds
    to `REPLAYED` what each host's bodies replayed since its last fetch.
    Returns (the tensors' values as floats, flattened in order; per host,
    its bodies' runs since its last fetch, by name)."""
    device, f64 = hosts[0].device, torch.float64
    parts = [t.reshape(-1).to(f64) for t in tensors]
    vals = torch.cat([*parts, *(h.runs.to(f64) for h in hosts),
                      profiling.span_table(device).to(f64)]).tolist()
    at = n = sum(p.numel() for p in parts)
    ran = []
    for h in hosts:
        runs = [int(v) for v in vals[at:at + len(h._seen)]]
        at += len(runs)
        delta = {name: r - seen for name, r, seen in zip(h.fns, runs, h._seen)}
        for body, counts in h.per_capture.items():
            for kernel, c in counts.items():
                REPLAYED[kernel] += c * delta[body]
        h._seen = runs
        ran.append(delta)
    profiling.read_spans(device, vals[at:])
    return vals[:n], ran
