"""CUDA graphs for the port's compiled programs: capture once, replay.

The reference compiles its hot programs with ``jax.jit`` (the executor's
solve program and its ``lax.scan`` body, batched evaluation, the surrogate
trainer's step and validation).  On the card the port records each as a
CUDA graph over static buffers and replays it; on the host the same
closures run eagerly.

* :func:`captures` says whether a device takes the graph route (a CUDA
  device does).
* :func:`building` serializes warm-ups and captures in the process and
  runs them on one side stream a device: first calls are rare, a stream
  that is capturing must carry no other thread's work, and every stream a
  program's GEMMs run on keeps a cuBLAS workspace for good.
* :func:`warm_up` runs a closure once eagerly there (it builds the
  kernels' library, makes the cuBLAS handles and warms autograd); its
  launches are not counted, since no caller sees its result.
* :func:`capture` records a closure as one :class:`Captured` graph, whose
  wrapper counts go to a tally that each replay adds again
  (``platform.deferred_counts``).  A closure that syncs with the host
  cannot be captured: the capture raises with the line it stopped at, and
  nothing runs eagerly in the graph's place.
* :class:`CallGraph` is the whole pattern for a function of static-shape
  inputs: warm-up and capture at the first call, copy-in, replay and a
  read of the static outputs at every call, under one lock.
* :class:`RowGraphs` is a row-wise function as a :class:`CallGraph` a row
  bucket, captured at the bucket's second call (batched evaluation).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import gc
import threading
import time
import traceback
from typing import Callable

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from . import platform

_CAPTURE_LOCK = threading.Lock()
_SIDE_STREAMS: dict = {}  # device -> its warm-up and capture stream
_LIBCUDA: list = []  # libcuda, loaded at the first node count
# program route ("exec", "eval", "fit") -> seconds of its captures in this
# process (recording and instantiation)
CAPTURE_S: collections.Counter = collections.Counter()


def captures(device: torch.device) -> bool:
    """Whether a program runs as a CUDA graph on ``device``: on a CUDA
    device, as the kernel wrappers launch their kernels there."""
    return device.type == "cuda"


@contextlib.contextmanager
def building(device: torch.device):
    """Hold the process's capture lock and yield ``device``'s side stream,
    made to wait for the current stream's work; on exit the current stream
    waits for the side stream's."""
    with _CAPTURE_LOCK:
        stream = _SIDE_STREAMS.get(device)
        if stream is None:
            stream = _SIDE_STREAMS[device] = torch.cuda.Stream(device)
        current = torch.cuda.current_stream(device)
        stream.wait_stream(current)
        try:
            yield stream
        finally:
            current.wait_stream(stream)


def warm_up(stream, fn: Callable):
    """``fn()`` run eagerly on ``stream``, its launch counts dropped."""
    with torch.cuda.stream(stream), platform.deferred_counts():
        return fn()


class Captured:
    """One CUDA graph: the outputs its closure returned at capture (static:
    every replay writes them again), the counts a replay adds, and what
    the capture cost."""

    def __init__(self, graph, outputs, tally, capture_s: float,
                 instantiate_s: float, nodes: int, device: torch.device):
        self.graph = graph
        self.outputs = outputs
        self.tally = tally
        self.capture_s = capture_s  # recording, ending and instantiating
        self.instantiate_s = instantiate_s  # ending and instantiating
        self.nodes = nodes
        self.device = device

    def replay(self, times: int = 1):
        """Replay the graph ``times`` times on the current stream, add its
        counts as many times, and return its static outputs."""
        for _ in range(times):
            self.graph.replay()
        platform.add_counts(self.tally, times)
        return self.outputs

    @property
    def pool_bytes(self) -> int:
        """Bytes of the graph's private memory pool, read from the
        allocator's snapshot when asked, never on a replay's path."""
        return pool_bytes(self.graph, self.device)


def capture(fn: Callable, stream, device: torch.device, what: str,
            generators=(), route: str = "", pool=None) -> Captured:
    """Record ``fn()`` on ``stream`` (inside :func:`building`) as a CUDA
    graph with a memory pool of its own, or in ``pool`` (another graph's
    ``graph.pool()``: graphs that never replay at once can share their
    memory, each graph's outputs read before the next replay).
    ``generators`` are the
    ``torch.Generator``s ``fn`` draws from: registered with the graph, so
    that each replay draws what the same call run eagerly at that point
    would.  Raises ``RuntimeError`` naming ``what`` and the line the
    capture stopped at if ``fn`` cannot be captured.

    Python's cyclic garbage collector is paused during the capture: a
    collection there could free another graph, and destroying a graph on
    the capturing thread invalidates the capture."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    for gen in generators:
        graph.register_generator_state(gen)
    collecting = gc.isenabled()
    gc.disable()
    with platform.deferred_counts() as tally:
        c0 = time.perf_counter()
        e0 = c0
        try:
            # capture_begin/end, not torch.cuda.graph: that context also
            # syncs the device and empties the allocator's cache, which
            # every later allocation of the process would pay
            with torch.cuda.stream(stream):
                graph.capture_begin(pool=pool,
                                    capture_error_mode="thread_local")
                try:
                    outputs = fn()
                finally:
                    e0 = time.perf_counter()
                    graph.capture_end()
            nodes = graph_nodes(graph)
            graph.instantiate()
        except RuntimeError as exc:
            raise RuntimeError(
                f"CUDA graph capture of {what} on {device} failed at "
                f"{capture_site(exc)}: {exc}") from exc
        finally:
            if collecting:
                gc.enable()
        c1 = time.perf_counter()
    CAPTURE_S[route] += c1 - c0
    return Captured(graph, outputs, tuple(tally), c1 - c0, c1 - e0, nodes,
                    device)


def copy_into(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)`` for a static input buffer of the same shape."""
    if dst.shape != src.shape:
        raise ValueError(f"a captured program's input is {tuple(dst.shape)}"
                         f", this call's {tuple(src.shape)}")
    dst.copy_(src)


class CallGraph:
    """``fn(*inputs) -> tuple of tensors`` on one device as one CUDA graph;
    the inputs are tensors or dict/list/tuple trees of them.

    The first call (or :meth:`prepare`) clones the inputs into static
    buffers, warms ``fn`` up on them, adds one to
    ``platform.ROUTES[route + ":eager"]`` and captures it; every call, the
    first included, copies its inputs into those buffers, replays the
    graph, adds one to ``ROUTES[route + ":graph"]`` and returns
    ``read(outputs)`` of the static outputs (by default a clone of each).
    One lock covers a call and its read, so that no other call's replay
    overwrites the outputs before they are read."""

    def __init__(self, fn: Callable, device: torch.device, route: str,
                 what: str):
        self.fn = fn
        self.device = device
        self.route = route
        self.what = what
        self.lock = threading.Lock()
        self.leaves = None  # the static input buffers
        self.inputs = None  # the same, as the tree of the call's inputs
        self.captured: Captured | None = None

    def prepare(self, *inputs) -> None:
        """Warm up and capture on ``inputs`` if not done yet."""
        with self.lock:
            if self.captured is None:
                self._first(*tree_flatten(inputs))

    def __call__(self, *inputs, read: Callable | None = None):
        leaves, spec = tree_flatten(inputs)
        with self.lock:
            if self.captured is None:
                self._first(leaves, spec)
            for dst, src in zip(self.leaves, leaves):
                copy_into(dst, src)
            out = self.captured.replay()
            platform.ROUTES[self.route + ":graph"] += 1
            if read is None:
                return tuple(torch.clone(o) for o in out)
            return read(out)

    def _first(self, leaves, spec) -> None:
        static = [torch.clone(t) for t in leaves]

        def run():
            return self.fn(*tree_unflatten(static, spec))

        with building(self.device) as stream:
            warm_up(stream, run)
            platform.ROUTES[self.route + ":eager"] += 1
            self.captured = capture(run, stream, self.device, self.what,
                                    route=self.route)
        self.leaves, self.inputs = static, tree_unflatten(static, spec)


def _pow2(n: int) -> int:
    """The smallest power of two >= ``n`` (1 for 0)."""
    return 1 << max(n - 1, 0).bit_length()


class RowGraphs:
    """A row-wise function ``fn(*shared, X) -> (N, ...)``, its rows padded
    to a bucket on the card.

    On the host it runs eagerly on ``X``.  On the card ``X`` is padded to
    ``bucket_fn(N)`` rows by repeating its row 0 (the padding stays inside
    the domain) and the first ``N`` rows of the answer are kept.  A
    bucket's first call runs ``fn`` eagerly on the padded rows
    (``ROUTES["eval:first"]``); its second makes it a :class:`CallGraph`
    (route ``"eval"``), which answers every later call by a replay.  So a
    one-shot evaluation (a bounds estimate, a reference grid, one
    problem's traces) pays no capture and holds no graph memory, and a
    repeated one (NSGA-II's generations, a shared executor's structure)
    replays.  Both routes run ``fn`` on the same padded rows and give the
    same bits.  ``what`` names the function in a failed capture's error."""

    def __init__(self, fn: Callable, what: str,
                 bucket_fn: Callable[[int], int] = _pow2):
        self.fn = fn
        self.what = what
        self.bucket_fn = bucket_fn
        self.seen: set[int] = set()  # buckets called once
        self.graphs: dict[int, CallGraph] = {}
        self._lock = threading.Lock()

    def __call__(self, *args):
        *shared, X = args
        if not captures(X.device):
            return self.fn(*shared, X)
        N = int(X.shape[0])
        Np = self.bucket_fn(N)
        if Np > N:
            X = torch.cat([X, X[:1].expand(Np - N, *X.shape[1:])])
        with self._lock:
            graph = self.graphs.get(Np)
            if graph is None and Np in self.seen:
                fn = self.fn  # no reference back to self: no cycle
                graph = self.graphs[Np] = CallGraph(
                    lambda *a: (fn(*a),), X.device, "eval",
                    f"{self.what} at {Np} rows")
            self.seen.add(Np)
        if graph is None:
            platform.ROUTES["eval:first"] += 1
            return self.fn(*shared, X)[:N]
        return graph(*shared, X, read=lambda out: out[0][:N].clone())


def capture_site(exc: BaseException) -> str:
    """``file:line: code`` of the innermost frame outside ``torch`` where
    the first exception of ``exc``'s chain was raised (the op a capture
    stopped at; a failed capture also fails its end, which chains it)."""
    while exc.__context__ is not None:
        exc = exc.__context__
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if "/torch/" not in f.filename.replace("\\", "/")
              and f.name != "__torch_dispatch__"]
    if not frames:
        return "an unknown line"
    f = frames[-1]
    return f"{f.filename}:{f.lineno}: {f.line}"


def graph_nodes(graph) -> int:
    """The nodes of a captured ``torch.cuda.CUDAGraph(keep_graph=True)``
    (libcuda's ``cuGraphGetNodes``)."""
    if not _LIBCUDA:
        _LIBCUDA.append(ctypes.CDLL("libcuda.so.1"))
    n = ctypes.c_size_t(0)
    err = _LIBCUDA[0].cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()),
                                      None, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes failed with CUresult {err}")
    return int(n.value)


def pool_bytes(graph, device: torch.device) -> int:
    """Bytes of the segments of ``graph``'s private memory pool."""
    pool = tuple(graph.pool())
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if seg.get("device") == device.index
               and tuple(seg.get("segment_pool_id") or ()) == pool)
