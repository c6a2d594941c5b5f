"""prime-rl-tpu's PyTorch + CUDA package: the serving path (paged-KV,
continuous-batching sampler and its HTTP server) on an NVIDIA Hopper card,
with the TPU kernels rewritten by hand in CUDA C++ (``csrc/``).

The JAX package ``prime_rl_tpu`` is the reference; this package imports
nothing from it and keeps its own copies of what it needs."""
