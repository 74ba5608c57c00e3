"""PyTorch/CUDA port of climb_tpu for NVIDIA Hopper (H100).

A package of its own beside ``climb_tpu``, the JAX reference: it imports
``torch`` and nothing of JAX or of ``climb_tpu``. Every Pallas kernel on a
ported path has a hand-written CUDA kernel under ``csrc/``, built with nvcc at
first use; each kernel's wrapper runs its plain PyTorch version only for CPU
tensors. Entry points run on ``cuda`` unless the caller asks for ``cpu``.
"""
