"""Hand-written Hopper kernels for the port's hot spots, each beside its
plain PyTorch version (the CPU tier and the kernel's oracle on the card).

    pareto_filter   cross-set Pareto dominator counts (csrc/pareto_filter.cu)
    mogd_descend    fused multi-start projected-Adam MOGD descent
                    (csrc/mogd_descend.cu)

``platform`` holds the device policy, ``native`` builds and loads the CUDA
library, ``ref`` holds the autodiff oracles and ``ops`` the public wrappers.
"""

from . import ops, platform, ref

__all__ = ["ops", "platform", "ref"]
