"""larvanet_tpu_torch: the PyTorch/CUDA port of larvanet_tpu for NVIDIA Hopper.

A package of its own beside the JAX reference: it imports torch, never
jax, and nothing of `larvanet_tpu`. Plain tensor code is PyTorch; the
TPU's Pallas kernels become hand-written CUDA kernels under `csrc/`,
built at first use (ops/build.py). Entry points run on the card unless
the caller asks for the CPU (`--device cpu`).
"""
