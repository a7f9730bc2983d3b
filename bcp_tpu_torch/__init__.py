"""bcp_tpu_torch: the PyTorch/CUDA port of bcp_tpu for an NVIDIA H100.

Plain tensor code is PyTorch; each TPU kernel of the JAX package becomes a
kernel written by hand for Hopper under ``kernels/csrc``. Module names
mirror ``bcp_tpu`` so each counterpart is easy to find. Nothing here
imports JAX or the JAX package.
"""
