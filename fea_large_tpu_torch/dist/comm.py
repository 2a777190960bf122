"""The collectives of the sharded solvers over a `torch.distributed` process
group, one process per shard (the counterparts of the reference's
`lax.ppermute` and `lax.psum` inside `shard_map`).

  * `hop(x, k)`: ring hop by k; this rank sends x to rank + k and returns
    what rank - k sent (mod size). The halo gather hops forward, the halo
    reduce backward (k < 0). Off gloo the result is a persistent buffer,
    valid only until the next hop of the same k, shape and dtype: use it
    at once or clone it;
  * `all_sum(x)`: a FIXED-ORDER sum over the ranks: an all-gather of the
    partials, then their sum in rank order on every rank. Every rank holds
    the bitwise-same value, whatever algorithm the backend picks, so
    repeated solves are bitwise equal and the ranks' control flow agrees.

The backend follows from the devices: NCCL where every rank has a CUDA card
of its own; gloo where the ranks are on the CPU or share a card (NCCL
refuses two ranks on one device). gloo takes host tensors, so every gloo
collective of a CUDA tensor goes through a host copy and back, the same
way for every collective: a fixed-order sum is then added on the host and
copied to the device once. Float adds round the same on the host and on
the card, so the same adds in the same order give both backends the same
bits.

On NCCL the collectives can run inside a captured CUDA graph
(`capturable`): a hop sends x and receives into a persistent buffer, and
the sum all-gathers into a persistent [size, ...] buffer and adds its rows
in rank order on the card, so that a capture holds fixed addresses and
no host step. A one-rank comm exchanges nothing and is capturable too;
gloo, which stages through the host, is not. `warm()` runs every
collective met so far once more before a capture: NCCL connects its
peers lazily, at a collective's first run, which a capture cannot hold.

With `profile` set, each collective first waits for the device and then
adds its host seconds to `seconds` and its count to `calls` ("hop",
"sum"), so that the exchange's own time can be told from the kernels'.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist


def backend_for(devices) -> str:
    """"nccl" where every rank has a CUDA device of its own, else "gloo"."""
    devs = [torch.device(d) for d in devices]
    cuda = all(d.type == "cuda" for d in devs)
    distinct = len({(d.type, d.index) for d in devs}) == len(devs)
    return "nccl" if cuda and distinct and len(devs) > 1 else "gloo"


class Comm:
    """The process group of one sharded run, seen from one rank."""

    def __init__(self, rank: int, size: int, device, backend: str, group=None):
        self.rank = int(rank)
        self.size = int(size)
        self.device = torch.device(device)
        self.backend = backend
        self.group = group
        self.profile = False
        self.seconds = {"hop": 0.0, "sum": 0.0}
        self.calls = {"hop": 0, "sum": 0}
        #: persistent receive buffers by (kind, k, shape, dtype), in the
        #: order met (the same on every rank)
        self._met = {}

    @property
    def capturable(self) -> bool:
        """Whether the collectives can run inside a captured CUDA graph:
        NCCL's, or one rank's (no exchange); not gloo's (host staging)."""
        return self.backend == "nccl" or self.size == 1

    # -- staging ----------------------------------------------------------
    def _staged(self) -> bool:
        return self.backend == "gloo" and self.device.type == "cuda"

    def _buffer(self, kind: str, k: int, shape, dtype) -> torch.Tensor:
        """The persistent buffer of one collective shape (made at its first
        use), and the shape recorded for `warm`."""
        key = (kind, k, tuple(shape), dtype)
        if key not in self._met:
            rows = (self.size,) if kind == "sum" else ()
            self._met[key] = torch.zeros(rows + tuple(shape), dtype=dtype, device=self.device)
        return self._met[key]

    def _out(self, x: torch.Tensor) -> torch.Tensor:
        """x as the backend takes it (a host copy of a CUDA tensor for gloo)."""
        x = x.contiguous()
        return x.cpu() if self._staged() else x

    def _back(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.device) if self._staged() else x

    def _start(self):
        if self.profile and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def _stop(self, key: str, t0: float) -> None:
        if self.profile:
            self.seconds[key] += time.perf_counter() - t0
            self.calls[key] += 1

    def reset_profile(self) -> None:
        self.seconds = {"hop": 0.0, "sum": 0.0}
        self.calls = {"hop": 0, "sum": 0}

    # -- collectives ------------------------------------------------------
    def hop(self, x: torch.Tensor, k: int = 1) -> torch.Tensor:
        """Send x to rank + k, return what rank - k sent (ring, mod size).
        Off gloo the result is the persistent receive buffer of (k, shape,
        dtype), which the next such hop overwrites: use it at once or
        clone it."""
        dst, src = (self.rank + k) % self.size, (self.rank - k) % self.size
        if dst == self.rank:
            return x.clone()
        t0 = self._start()
        send = self._out(x)
        # gloo's staged receive is a fresh host tensor; elsewhere the
        # persistent buffer, valid until the next hop of its shape
        recv = (torch.empty_like(send) if self._staged()
                else self._buffer("hop", k, send.shape, send.dtype))
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, dst, group=self.group),
            dist.P2POp(dist.irecv, recv, src, group=self.group),
        ])
        for r in reqs:
            r.wait()
        out = self._back(recv)
        self._stop("hop", t0)
        return out

    def _gather(self, x: torch.Tensor) -> list:
        """Every rank's x (equal shapes), in rank order, where the backend
        delivers them (the host for a staged gloo collective)."""
        send = self._out(x)
        parts = [torch.empty_like(send) for _ in range(self.size)]
        dist.all_gather(parts, send, group=self.group)
        return parts

    def gather(self, x: torch.Tensor) -> list:
        """Every rank's x (equal shapes), in rank order, on this device."""
        if self.size == 1:
            return [x]
        return [self._back(p) for p in self._gather(x)]

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """sum over ranks of x, added in rank order (bitwise-same on every
        rank)."""
        if self.size == 1:
            return x
        t0 = self._start()
        if self.backend == "nccl":
            flat = self._buffer("sum", 0, (x.numel(),), x.dtype)
            dist.all_gather_into_tensor(flat, x.reshape(-1).contiguous(), group=self.group)
            parts = flat.view(self.size, *x.shape)
        else:
            parts = self._gather(x)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        out = self._back(out)
        self._stop("sum", t0)
        return out

    def warm(self) -> None:
        """Run every hop and sum met so far once more, on zeros of its shape
        and in the order met (the same on every rank), then wait for the
        device: the collectives' first runs before a capture."""
        for kind, k, shape, dtype in list(self._met):
            z = torch.zeros(shape, dtype=dtype, device=self.device)
            if kind == "hop":
                self.hop(z, k)
            else:
                self.all_sum(z)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def broadcast(self, x: torch.Tensor | None, shape, dtype, src: int = 0) -> torch.Tensor:
        """Rank `src`'s x on every rank (others pass None, and the shape and
        dtype to receive)."""
        if self.size == 1:
            return x
        if self.rank == src:
            buf = self._out(x)
        else:
            buf = torch.empty(shape, dtype=dtype,
                              device="cpu" if self._staged() else self.device)
        dist.broadcast(buf, src, group=self.group)
        return self._back(buf) if self.rank != src else x


class LocalComm(Comm):
    """A one-rank `Comm` with no process group: the sharded solvers with
    one shard, in the calling process."""

    def __init__(self, device="cpu"):
        super().__init__(0, 1, device, "none")
