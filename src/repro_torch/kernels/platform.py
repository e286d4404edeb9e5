"""One device policy for every entry point and kernel wrapper of the port.

* **Entry points** (``ProbeExecutor``, ``MOGDSolver``, ``ProgressiveFrontier``,
  ``solve_pf``, the task builders, ...) take ``device=None``.
  :func:`resolve_device` maps ``None`` to ``cuda``; on a host without a
  CUDA device that raises ``RuntimeError``.  There is no silent CPU
  fallback: a caller that wants the host passes ``device="cpu"``.
* **Kernel wrappers** route on the device of the tensors they are handed
  (:func:`use_kernel`): a CPU tensor takes the kernel's plain PyTorch
  version; a CUDA tensor takes the hand-written Hopper kernel, and a card
  other than compute capability 9.0 raises instead of falling back.
* **Precision.** The reference computes in fp32 with JAX x64 off.  Device
  tensors are float32, and TF32 is kept off for float32 matrix products
  (``torch.backends.cuda.matmul.allow_tf32 = False``, set below), so the
  plain versions on the card compute in full fp32 like the kernels.
* **Launch counts.** Every wrapper adds one to :data:`LAUNCHES` under its
  kernel's name where it launches the kernel, and nowhere else, so a run
  can show that its main path went through the kernels.  A plain version
  that a wrapper routes to adds one to :data:`PLAIN_ON_CUDA` when it is
  handed a CUDA tensor, so a run can also show that its path never took
  the plain version on the card.  A kernel with more than one route (by
  dtype or by shape) also adds one to :data:`ROUTES` under
  ``"<kernel>:<route>"``, so a run can show which route its path took.
* **Backward passes.**  Where the reference has no backward kernel (the
  WKV, flash and scan wrappers), the port's ``autograd.Function`` recomputes
  through the plain version and differentiates that
  (:func:`plain_backward`); each such recompute on a CUDA tensor is counted
  in :data:`PLAIN_BACKWARD_ON_CUDA`, apart from :data:`PLAIN_ON_CUDA`.
"""

from __future__ import annotations

import collections

import torch

torch.backends.cuda.matmul.allow_tf32 = False

HOPPER = (9, 0)

# kernel name -> launches since the last reset_launches()
LAUNCHES: collections.Counter = collections.Counter()
# plain-version name -> calls on a CUDA tensor since the last reset
PLAIN_ON_CUDA: collections.Counter = collections.Counter()
# plain-version name -> backward recomputes on a CUDA tensor
PLAIN_BACKWARD_ON_CUDA: collections.Counter = collections.Counter()
# "<kernel>:<route>" -> launches by that route
ROUTES: collections.Counter = collections.Counter()
# CUDA device indices found to be Hopper cards
_ON_HOPPER: set[int] = set()
# CUDA device index -> its number of SMs
_SMS: dict[int, int] = {}


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises when CUDA is asked for but absent.

    A bare ``cuda`` is pinned to the current device index so that two
    resolutions of the same request compare equal."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: the port runs on the GPU by "
                "default; pass device='cpu' to run it on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def use_kernel(t: torch.Tensor) -> bool:
    """True when ``t`` must go through a hand-written kernel.

    CPU tensors take the plain version (False).  CUDA tensors take the
    kernel; a card that is not Hopper (compute capability 9.0) raises."""
    if not t.is_cuda:
        if t.device.type == "cpu":
            return False
        raise RuntimeError(f"unsupported device {t.device} for a port kernel")
    index = t.get_device()
    if index not in _ON_HOPPER:  # a card's capability is read once
        cap = torch.cuda.get_device_capability(index)
        if tuple(cap) != HOPPER:
            raise RuntimeError(
                f"the port's kernels are built for sm_90a (Hopper); "
                f"{torch.cuda.get_device_name(index)} has compute "
                f"capability {cap[0]}.{cap[1]}")
        _ON_HOPPER.add(index)
    return True


def sm_count(index: int) -> int:
    """The number of SMs of CUDA device ``index`` (read once)."""
    n = _SMS.get(index)
    if n is None:
        n = _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return n


def launch(fn, index: int, *args) -> int:
    """``fn(*args, stream)``: a C entry point of ``native.library()``
    called with the raw handle of the current stream of CUDA device
    ``index`` (the handle Triton's launcher reads too), entering that
    device only when it is not the current one, since the entry launches
    on the current device."""
    if index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))


def reset_launches() -> None:
    """Set every kernel's launch and route counts, and every plain
    version's counts of calls and backward recomputes on the card, to 0."""
    LAUNCHES.clear()
    PLAIN_ON_CUDA.clear()
    PLAIN_BACKWARD_ON_CUDA.clear()
    ROUTES.clear()


def launch_counts() -> dict:
    """A copy of the launch counts, by kernel name."""
    return dict(LAUNCHES)


def plain_on_cuda_counts() -> dict:
    """A copy of the plain versions' call counts on CUDA tensors."""
    return dict(PLAIN_ON_CUDA)


def plain_backward_on_cuda_counts() -> dict:
    """A copy of the plain versions' backward recompute counts on CUDA
    tensors."""
    return dict(PLAIN_BACKWARD_ON_CUDA)


def route_counts() -> dict:
    """A copy of the launch counts by ``"<kernel>:<route>"``."""
    return dict(ROUTES)


def plain_backward(plain, inputs, needs, grad_outputs) -> tuple:
    """The gradients of ``plain(*inputs)`` with respect to the inputs whose
    ``needs`` is true (None for the others), given the gradients of its
    outputs: ``plain`` is run again under ``torch.enable_grad()`` on
    detached copies of the inputs and differentiated with
    ``torch.autograd.grad``.  ``plain`` counts itself (it is handed
    :data:`PLAIN_BACKWARD_ON_CUDA` as its counter)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(bool(n))
                  if isinstance(t, torch.Tensor) else t
                  for t, n in zip(inputs, needs)]
        outs = plain(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        wrt = [t for t, n in zip(leaves, needs)
               if n and isinstance(t, torch.Tensor)]
        pairs = [(o, g) for o, g in zip(outs, grad_outputs)
                 if o.requires_grad and g is not None]
        got = iter(torch.autograd.grad(
            [o for o, _ in pairs], wrt, [g for _, g in pairs],
            allow_unused=True) if pairs and wrt else [None] * len(wrt))
    return tuple(next(got) if n and isinstance(t, torch.Tensor) else None
                 for t, n in zip(inputs, needs))


def meta_backward(ctx) -> tuple:
    """A recurrence's backward on ``meta`` tensors (the dry-run's
    shape-only route): an empty gradient shaped like each saved input
    whose gradient is needed, None for the others."""
    return tuple(torch.empty_like(t) if t is not None and need else None
                 for t, need in zip(ctx.saved_tensors,
                                    ctx.needs_input_grad))
