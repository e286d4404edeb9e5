"""Hand-written Hopper kernels for the port's hot spots, each beside its
plain PyTorch version (the CPU tier and the kernel's oracle on the card).

    pareto_filter   cross-set Pareto dominator counts (csrc/pareto_filter.cu)
    mogd_descend    fused multi-start projected-Adam MOGD descent
                    (csrc/mogd_descend.cu)
    compose         all-pairs frontier composition for DAG jobs
                    (csrc/compose.cu)
    mogd_mlp        fused surrogate-MLP forward behind the regressors and
                    the trainer (csrc/mogd_mlp.cu)
    rwkv6_wkv       RWKV-6 WKV recurrence from a given state
                    (csrc/rwkv6_wkv.cu)
    flash_attention causal GQA flash attention (csrc/flash_attention.cu)

``platform`` holds the device policy, ``native`` builds and loads the CUDA
library, ``ref`` holds the autodiff oracles and ``ops`` the public wrappers.
"""

from . import ops, platform, ref

__all__ = ["ops", "platform", "ref"]
