"""analytics_zoo_tpu_torch — the PyTorch / CUDA port of analytics_zoo_tpu.

A second package beside the JAX one, for an NVIDIA H100. It mirrors the JAX
package's module layout (`keras/`, `models/`, `serving/`, `observability/`)
so that each module's counterpart is found under the same path, and replaces
each Pallas kernel with a kernel written by hand for Hopper (`kernels/`,
sources in `csrc/`).

The package imports torch, numpy and the standard library only: never jax,
and nothing of `analytics_zoo_tpu`. What it needs from a jax-free module of
the JAX package is copied here under a header that names the source file.

Entry points run on `cuda` unless the caller passes `device="cpu"`; without
a GPU they raise instead of running on the CPU.
"""

__version__ = "0.1.0"
