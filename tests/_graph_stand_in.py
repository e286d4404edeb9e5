"""A stand-in for CUDA graphs on a host without a card.

``kernels.graphs`` is told to capture on the host, and ``torch.cuda``'s
graph and stream objects are replaced (``monkeypatch``):

* A capture runs the closure once under a dispatch mode that refuses the
  operations a CUDA capture refuses on a host sync (``HOST_SYNC``: a
  constant copied from the host, a number read back, an output whose size
  the host must read), so the programs of the card's paths are held here
  to be capturable.  It counts the operations it sees (the graph's
  "nodes"); the tensors it writes in place, and the generators
  registered with the graph, end it as they began: a capture on the card
  runs nothing and draws nothing.
* A replay runs the closure again from the static buffers and copies what
  it returns into the static outputs (what the captured kernels do on the
  card); its launch counts are dropped, since the replay's tally adds
  them.
"""

from __future__ import annotations

import collections
import contextlib
import time
import weakref

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import graphs as graphs_mod
from repro_torch.kernels import platform

# what a CUDA capture refuses: a constant built from host data (an
# upload), a number read back, and the ops whose output size the host
# must read
HOST_SYNC = {"lift_fresh", "lift_fresh_copy", "_local_scalar_dense",
             "nonzero", "masked_select", "_unique2", "unique_dim",
             "unique_consecutive", "equal", "is_nonzero"}


class _RefuseHostSync(TorchDispatchMode):
    """Raise on the operations a CUDA stream capture cannot record; count
    the others, and keep a copy of each tensor an operation writes in
    place, taken before its first write (:meth:`restore` puts them back)."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.written = {}  # id -> (tensor, its contents before capture)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in HOST_SYNC:
            raise RuntimeError(f"operation not permitted when stream is "
                               f"capturing: {func}")
        self.ops += 1
        kwargs = kwargs or {}
        for i, arg in enumerate(func._schema.arguments):
            if arg.alias_info is None or not arg.alias_info.is_write:
                continue
            val = args[i] if i < len(args) else kwargs.get(arg.name)
            for t in val if isinstance(val, (list, tuple)) else (val,):
                if isinstance(t, torch.Tensor) and id(t) not in self.written:
                    self.written[id(t)] = (t, t.clone())
        return func(*args, **kwargs)

    def restore(self):
        for t, before in reversed(self.written.values()):
            if t.shape == before.shape:  # (an ``out=`` may be resized)
                t.copy_(before)
        self.written.clear()


class _Stream:
    def __init__(self, device=None):
        self.device = device

    def wait_stream(self, other):
        pass


class StandIn:
    """The graph objects and what they saw."""

    def __init__(self):
        self.graphs = []  # weak references to every graph made
        self.capture_delay = 0.0
        self.during_capture = None  # called inside each capture
        self.on = True  # the host takes the graph route
        self.keep = False  # hold every graph made (it outlives its owner)
        self.kept = []

    def graph_type(self):
        stand_in = self

        class Graph:
            def __init__(self, keep_graph=False):
                self.replays = 0
                self.rerun = None
                self.mode = None
                self.ops = 0
                self.generators = []
                self.saved = []
                stand_in.graphs.append(weakref.ref(self))
                if stand_in.keep:
                    stand_in.kept.append(self)

            def register_generator_state(self, gen):
                self.generators.append(gen)

            def capture_begin(self, pool=None, capture_error_mode="global"):
                assert capture_error_mode == "thread_local"
                time.sleep(stand_in.capture_delay)
                if stand_in.during_capture is not None:
                    stand_in.during_capture()
                self.saved = [g.get_state() for g in self.generators]
                self.mode = _RefuseHostSync()
                self.mode.__enter__()

            def capture_end(self):
                self.mode.__exit__(None, None, None)
                self.mode.restore()
                self.ops = self.mode.ops
                for g, st in zip(self.generators, self.saved):
                    g.set_state(st)

            def instantiate(self):
                pass

            def replay(self):
                self.replays += 1
                if self.rerun is not None:
                    self.rerun()

            def pool(self):
                return (0, id(self))

        return Graph


@pytest.fixture
def stand_in(monkeypatch):
    """Host calls take the graph routes through the stand-in."""
    s = StandIn()
    monkeypatch.setattr(graphs_mod, "captures", lambda device: s.on)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", s.graph_type())
    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream(device))
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(graphs_mod, "pool_bytes", lambda graph, dev: 0)
    monkeypatch.setattr(graphs_mod, "graph_nodes", lambda graph: graph.ops)
    monkeypatch.setattr(graphs_mod, "_SIDE_STREAMS", {})
    monkeypatch.setattr(graphs_mod, "CAPTURE_S", collections.Counter())
    capture = graphs_mod.capture

    def armed_capture(fn, *args, **kwargs):
        cap = capture(fn, *args, **kwargs)

        def rerun():
            with platform.deferred_counts():  # the tally counts a replay
                out = fn()
            if out is not None:
                for dst, src in zip(cap.outputs, out):
                    dst.copy_(src)

        cap.graph.rerun = rerun
        return cap

    monkeypatch.setattr(graphs_mod, "capture", armed_capture)
    return s


def eager(s: StandIn, fn):
    """``fn()`` on the host's eager route: no graph."""
    s.on = False
    try:
        return fn()
    finally:
        s.on = True


@pytest.fixture
def cuda_device():
    """The card, or a skip on hosts without one (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper GPU (CUDA unavailable here)")
    return torch.device("cuda", 0)
