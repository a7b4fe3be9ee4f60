"""One device program per chunk of a driver's work (counterpart of
tpu_multigrid/utils/compile.py, of which the drivers take only this: the
JAX package runs each chunk of cycles or Krylov steps as one compiled
program, and the host reads back its small result).

`CapturedChunk` holds a driver's state (the right-hand side's solution
fields, the Krylov vectors, ...) in buffers at fixed addresses. On CUDA
tensors each body run on that state is captured once as a CUDA graph
(torch.cuda.CUDAGraph) and then replayed: the capture ends by copying the
body's new state into the buffers, so replays chain on the card with no
host step between them. The graphs live as long as the object: the
hierarchy's tensors that a body reads are read where they lie, and a
graph must not outlive them. Most drivers make one per call and close it
before they return; solve_ir keeps its program with the hierarchy it
reads (driver.py), so that a repeat call loads its new right-hand side
and only replays. On CPU tensors the body runs eagerly, as the caller
asked for the CPU.

The launch counters of ops.cuda_stencil count launches that ran: a
wrapper adds to them when it is called under capture, where nothing
runs, so a capture's additions are taken out again and added once per
replay. The warm-up before a capture runs the body (or one step of it)
once on copies of the state, on a side stream, as torch's graph recipe
asks (the libraries' lazy set-up and the kernels' first-call queries
stay out of the capture); its launches ran and stay counted. A capture
runs under torch.cuda's sync debug mode "error", so a host sync inside a
body raises. Nothing is caught: a capture or a replay that fails raises
its error. `close` drops the graphs; a driver calls it once it has read
what it returns (solve_ir, when it replaces its kept program).

Spans (profiling.span): chunk.warm_up, chunk.capture and chunk.release
once a key, chunk.replay once a replay; chunk.reuse, opened by a driver,
once a call that replays a kept program. The warm-up's time on the side
stream, between a pair of CUDA events, is read at `report_warm_ups` (by
then the driver's read-backs have waited for the card) and added to the
open root's chunk.warm_up: the stream's elapsed time, the warm-up's
device work where the card runs it slower than the host launches it.

The disk cache, the scoped-VMEM options and the ahead-of-time keying of
the JAX package's `aot_call` belong to the TPU and are not ported.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, Hashable

import torch

from .. import profiling
from ..ops import cuda_stencil

_WARM_UP = profiling.span("chunk.warm_up")
_CAPTURE = profiling.span("chunk.capture")
_REPLAY = profiling.span("chunk.replay")
_RELEASE = profiling.span("chunk.release")
REUSE = profiling.span("chunk.reuse")


def _counts() -> dict:
    """The launch counters as one flat dict (a copy)."""
    out = {("launches", k): v for k, v in cuda_stencil.launches.items()}
    out.update({("group", k): v
                for k, v in cuda_stencil.group_launches.items()})
    out.update({("band", k, m): v
                for k, modes in cuda_stencil.band_launches.items()
                for m, v in modes.items()})
    out.update({("rb", k): v for k, v in cuda_stencil.rb_sweeps.items()})
    return out


def _add(delta: dict, times: int) -> None:
    """Add `times` x delta to the launch counters."""
    for key, v in delta.items():
        if key[0] == "launches":
            cuda_stencil.launches[key[1]] += times * v
        elif key[0] == "group":
            cuda_stencil.group_launches[key[1]] += times * v
        elif key[0] == "rb":
            cuda_stencil.rb_sweeps[key[1]] += times * v
        else:
            cuda_stencil.band_launches[key[1]][key[2]] += times * v


@contextlib.contextmanager
def _counted_out():
    """Yield a dict that, when the block ends (also by an error), holds
    what the block added to the launch counters, which are set back to
    their values before it."""
    before = _counts()
    delta: dict = {}
    try:
        yield delta
    finally:
        after = _counts()
        delta.update({k: after[k] - before[k] for k in after
                      if after[k] != before[k]})
        _add(delta, -1)


@functools.cache
def _capture_pool(index: int):
    """(pool, side stream, anchor) of every warm-up and capture on card
    `index`, for the life of the process (torch's own graph trees share a
    pool in the same way). A graph's memory goes back to the pool when the
    graph dies and serves the next capture on the same stream; a pool of
    its own to each graph would leave that memory reserved, and unusable,
    until torch.cuda.empty_cache, which torch.cuda.graph calls before every
    capture at the cost of a synchronized card and an emptied cache. The
    anchor, a graph of one fill that is never replayed, holds the pool
    (torch frees a pool that no live graph holds)."""
    side = torch.cuda.Stream(index)
    anchor = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        anchor.capture_begin(capture_error_mode="thread_local")
        torch.zeros((), device=torch.device("cuda", index))
        anchor.capture_end()
    return anchor.pool(), side, anchor


class CapturedChunk:
    """State tensors in static buffers, and bodies run on them.

    A body is body(*state) -> (new_state, out): new_state a sequence of
    tensors of the state's shapes and dtypes (an entry may be the state
    tensor itself, which is then left as it is; no entry may be a view of
    another), out what the host reads back (a tensor, a tuple of them or
    None). `chunk(key, body)` runs it once: on CUDA the first call with a
    key warms it up and captures it, and every call replays that graph,
    the body given later under the same key being ignored. `warm_up`, a
    body of the same operations on the same shapes (one step of a body
    of several), is what the warm-up runs (default: body). The returned
    out lives in the graph's memory: the next replay of the same key
    overwrites it.

    The graphs of a card all capture into one memory pool, also while
    other chunks' graphs live (a kept program lives across other
    drivers' calls). A capture may be given the blocks a live graph
    freed during its own capture, its intermediates, which that graph
    writes afresh in each replay before it reads them; the state
    buffers lie outside the pool, and a live graph's out is never given
    away. The port keeps to this: a chunk's out is read before any other
    chunk replays (and before `close`), and nothing a body writes outside
    its state buffers and its out is read across another chunk's replay.
    """

    def __init__(self, *state: torch.Tensor):
        self.cuda = state[0].is_cuda
        self._state = tuple(t.clone() for t in state) if self.cuda else state
        self._graphs: dict = {}
        self._warm_events: list = []

    @property
    def state(self) -> tuple:
        """The current state (on CUDA, the static buffers themselves)."""
        return self._state

    def load(self, *values: torch.Tensor) -> None:
        """Set the values of the state's first len(values) tensors (copied
        into the static buffers)."""
        if not self.cuda:
            self._state = tuple(values) + self._state[len(values):]
            return
        for s, v in zip(self._state, values):
            s.copy_(v)

    def __call__(self, key: Hashable, body: Callable,
                 warm_up: Callable | None = None):
        if not self.cuda:
            new, out = body(*self._state)
            self._state = tuple(new)
            return out
        if key not in self._graphs:
            with _WARM_UP:
                self._warm_up(warm_up or body)
            with _CAPTURE, _counted_out() as delta:
                graph, out = self._capture(body)
            self._graphs[key] = (graph, out, delta)
        graph, out, delta = self._graphs[key]
        with _REPLAY:
            graph.replay()
        _add(delta, 1)
        return out

    def close(self) -> None:
        """Destroy the graphs (their memory goes back to the shared pool;
        the outs they returned are void) and report the warm-ups. The
        state stays."""
        for key in list(self._graphs):
            with _RELEASE:
                self._graphs.pop(key)[0].reset()
        self.report_warm_ups()

    def report_warm_ups(self) -> None:
        """Add the ms between each warm-up's events to the open root, once
        (a driver that keeps the chunk past its call calls this before it
        returns)."""
        for start, end in self._warm_events:
            # complete after any read-back that followed the warm-up;
            # else its time is left out rather than waited for
            if end.query():
                profiling.add_device_ms("chunk.warm_up",
                                        start.elapsed_time(end))
        self._warm_events.clear()

    def _warm_up(self, body: Callable) -> None:
        """body on copies of the state, on the side stream, between a pair
        of timing events. The main stream waits for it, so that its
        kernels never run beside a replay's (a cooperative launch needs the
        whole card)."""
        main = torch.cuda.current_stream(self._state[0].device)
        side = _capture_pool(self._state[0].device.index)[1]
        side.wait_stream(main)
        events = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        with torch.cuda.stream(side):
            events[0].record()
            body(*(t.clone() for t in self._state))
            events[1].record()
        self._warm_events.append(events)
        main.wait_stream(side)

    def _capture(self, body: Callable):
        """(graph, out): body on the state buffers, its new state copied
        into them, captured on the side stream into the shared pool, with
        host syncs refused. The host captures while the card may still run
        the warm-up. thread_local: another thread's calls (the watchdog of
        a NCCL process group polls its events) do not void the capture."""
        pool, side, _ = _capture_pool(self._state[0].device.index)
        graph = torch.cuda.CUDAGraph()
        sync_mode = torch.cuda.get_sync_debug_mode()
        with torch.cuda.stream(side):
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                torch.cuda.set_sync_debug_mode("error")
                new, out = body(*self._state)
                for s, t in zip(self._state, new):
                    if t is not s:
                        s.copy_(t)
            finally:
                torch.cuda.set_sync_debug_mode(sync_mode)
                graph.capture_end()
        return graph, out


def run_steps(chunk: CapturedChunk, n: int, block: int,
              body_of: Callable[[int], Callable]):
    """n steps on `chunk`: replays of the body of `block` steps
    (body_of(block), under key block), then one of the n % block steps
    left (n = 0: the body of no steps, once); each warmed up by one step.
    Returns the last replay's out."""
    if n == 0:
        return chunk(0, body_of(0))
    out = None
    for _ in range(n // block):
        out = chunk(block, body_of(block), body_of(1))
    if n % block:
        out = chunk(n % block, body_of(n % block), body_of(1))
    return out
