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
  the plain version on the card.
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
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise RuntimeError(f"unsupported device {t.device} for a port kernel")
    cap = torch.cuda.get_device_capability(t.device)
    if tuple(cap) != HOPPER:
        raise RuntimeError(
            f"the port's kernels are built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(t.device)} has compute "
            f"capability {cap[0]}.{cap[1]}")
    return True


def reset_launches() -> None:
    """Set every kernel's launch count, and every plain version's count of
    calls on the card, to 0."""
    LAUNCHES.clear()
    PLAIN_ON_CUDA.clear()


def launch_counts() -> dict:
    """A copy of the launch counts, by kernel name."""
    return dict(LAUNCHES)


def plain_on_cuda_counts() -> dict:
    """A copy of the plain versions' call counts on CUDA tensors."""
    return dict(PLAIN_ON_CUDA)
