"""PyTorch and CUDA port of the MOO optimizer for one NVIDIA H100.

Mirrors the JAX package ``repro`` module for module (``core``, ``exec``,
``models``, ``kernels``, ``obs``, ``data``, ``alloc``, ``service``) and
never imports it or JAX.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""

__all__: list[str] = []
