"""PyTorch/CUDA port of tpu_ofdm, for NVIDIA Hopper (sm_90a).

Mirrors the layout of the JAX package: `tpu_ofdm_torch/ops/sync.py` is the
counterpart of `tpu_ofdm/ops/sync.py`.  Public functions take complex64
tensors; every op runs on the tensors' own device.  The hand-written CUDA
kernels live in `csrc/` and are built at first use (`kernels/build.py`).

This package imports torch and never jax.
"""
