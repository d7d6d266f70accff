"""repro_torch: the PyTorch / NVIDIA H100 port of ``repro``.

Same subpackage names as the JAX package, PyTorch idiom inside, and
hand-written Hopper kernels in place of the Pallas TPU kernels.  It imports
torch, never jax, and nothing of ``repro`` (whose ``__init__`` imports jax):
what it needs from there it keeps as its own copy.  Entry points run on the
card unless the caller passes ``device="cpu"``.
"""
