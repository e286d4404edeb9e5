"""The train step as a CUDA graph: the port's counterpart of the
reference's ``jax.jit(make_train_step(...))``.

:class:`GraphTrainStep` owns the train state.  The parameters, both Adam
moments and the 0-d step ``count`` live in buffers that every step
updates in place (``adam.adam_update_``: ``adam_update``'s bits, leaf by
leaf, so no second copy of the state is ever held), and each batch is
copied into a static input buffer on the current stream, the stream the
replays run on (so a loader's non-blocking upload is ordered before
them).

* The first call runs the step eagerly on the live state, on the
  device's side stream (``graphs.building``).  It is a real step, its
  launch counts counted, and it is the warm-up: it builds the kernels'
  library, makes the cuBLAS handles and warms autograd.  No state has to
  be undone, so the warm-up copies nothing.
* On a device where ``graphs.captures`` holds, the second call frees the
  allocator's cached blocks (the graph's private pool is then made from
  them), captures the step as one CUDA graph and replays it; every later
  call replays it.  A capture that fails raises with the line it stopped
  at (``graphs.capture``); nothing runs eagerly in the graph's place.
  On another device every call runs eagerly.
* The metrics (``loss_fn``'s and ``grad_norm``) are the graph's static
  outputs; a call returns copies of them, read after the replay.

The wrappers' counts (launches, ``PLAIN_BACKWARD_ON_CUDA``, routes) made
during the capture are added at each replay (``platform.deferred_counts``),
so the counts are the eager steps'.  ``platform.ROUTES`` counts
``train:eager`` (steps run eagerly) and ``train:graph`` (steps replayed);
``graphs.CAPTURE_S["train"]`` the capture's seconds.  Sharded training
(``rules``) stays with ``make_train_step``, eager: its multi-rank runs are
gloo runs on hosts.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..kernels import graphs, platform
from ..nn import ArchConfig
from .adam import adam_update_
from .train_step import TrainStepConfig, _check_dtype, step_grads


def _no_note(_: str) -> None:
    pass


class GraphTrainStep:
    """``step(batch) -> metrics`` over the train state it owns:
    ``params`` and ``opt`` (``adam_init``'s tree), both updated in place
    by every call and read as they stand (a checkpoint's
    ``launch.train.checkpoint_tree(step.state)``; a resume builds the step
    on the restored state).  ``_mark`` is ``make_train_step``'s
    instrumentation hook, called in the eager first step only (a CUDA
    event cannot be recorded inside a capture)."""

    def __init__(self, cfg: ArchConfig, params, opt_state: dict,
                 ts: TrainStepConfig = TrainStepConfig(), *,
                 _mark: Callable[[str], None] | None = None):
        _check_dtype(cfg, ts)
        self.cfg, self.ts = cfg, ts
        self.params, self.opt = params, opt_state
        self.device = opt_state["count"].device
        self.batch: dict | None = None  # the static input buffers
        self.keys: tuple = ()  # the metrics' names, in the outputs' order
        self.captured: graphs.Captured | None = None
        self.steps = 0
        self._mark = _mark

    @property
    def state(self) -> dict:
        """The live ``{"params", "opt"}`` state (not a copy)."""
        return {"params": self.params, "opt": self.opt}

    def _step(self, note: Callable[[str], None]) -> tuple:
        grads, metrics = step_grads(self.cfg, self.ts, self.params,
                                    self.batch, note)
        gnorm = adam_update_(grads, self.opt, self.params, self.ts.adam)
        note("update")
        self.keys = (*metrics, "grad_norm")
        return (*metrics.values(), gnorm)

    def __call__(self, batch: dict) -> dict:
        if self.batch is None:
            self.batch = {k: torch.clone(v) for k, v in batch.items()}
        else:
            for k, dst in self.batch.items():
                graphs.copy_into(dst, batch[k])
        graph = graphs.captures(self.device)
        if self.steps == 0 or not graph:
            if graph:
                with graphs.building(self.device) as stream, \
                        torch.cuda.stream(stream):
                    out = self._step(self._mark or _no_note)
            else:
                out = self._step(self._mark or _no_note)
            platform.ROUTES["train:eager"] += 1
        else:
            if self.captured is None:
                self._capture()
            out = self.captured.replay()
            platform.ROUTES["train:graph"] += 1
        self.steps += 1
        return {k: torch.clone(v) for k, v in zip(self.keys, out)}

    def _capture(self) -> None:
        with graphs.building(self.device) as stream:
            # the eager step's cached blocks go back to the device, so
            # that the graph's pool can take them
            torch.cuda.empty_cache()
            self.captured = graphs.capture(
                lambda: self._step(_no_note), stream, self.device,
                f"the {self.cfg.name} train step", route="train")
