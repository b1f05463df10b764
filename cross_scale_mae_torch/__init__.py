"""Cross-Scale MAE in PyTorch, with hand-written CUDA kernels for Hopper.

The PyTorch/CUDA counterpart of ``cross_scale_mae_tpu``. Each module sits at
the same path as its JAX counterpart, so a reader finds one from the other.
The JAX package is the numerical reference: the tests hold every module here
against it on the CPU, on the same inputs and weights.

This package imports ``torch`` and never ``jax``. It keeps its own copy of
what it needs from the JAX package (configs, dataset statistics, the npz
checkpoint format), because importing ``cross_scale_mae_tpu`` imports JAX.

Entry points run on the GPU (``device="cuda"``) unless the caller asks for
the CPU. Every kernel wrapper takes its plain PyTorch version only for a
tensor on the CPU; on a CUDA tensor it launches the kernel or raises.
"""

__version__ = "0.1.0"
