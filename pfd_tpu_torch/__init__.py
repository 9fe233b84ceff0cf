"""Prompt-Free Diffusion in PyTorch for one NVIDIA H100.

The port of ``pfd_tpu`` (JAX, Pallas, TPU), slice by slice. This package
imports neither JAX nor ``pfd_tpu``: the pure-Python tables it needs
(config bank, registry, zoo, schedules, weight conversion) are its own
copies. Modules keep the upstream torch ``state_dict`` names, so a
``pfd_tpu`` parameter pytree loads through :func:`io.convert.params_from_jax`
with ``load_state_dict(strict=True)``.

The two attention kernels of the serving path are hand-written CUDA C++ for
``sm_90a`` (``csrc/``), built at first use with ``nvcc`` into
``build/pfd_tpu_torch/`` and bound with ``ctypes`` (``ops/cuda_build.py``).
"""
