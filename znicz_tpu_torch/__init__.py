"""PyTorch/CUDA port of :mod:`znicz_tpu` for one NVIDIA H100.

The JAX package ``znicz_tpu`` is the reference; this package mirrors its
module paths (``core/``, ``ops/``, ``nn/``, ``loader/``, ``workflow/``,
``models/``) and keeps its public layouts (NHWC activations, HWIO conv
weights, ``[n_in, n_out]`` FC weights, a list of per-layer param dicts), so
the two can be held against each other on the same numpy inputs.

It imports ``torch`` and numpy, never ``jax`` nor anything of
``znicz_tpu``.  Entry points run on the card unless the caller passes
``device="cpu"``; without a card they raise instead of falling back.  The
TPU kernels on the ported paths are hand-written for Hopper: wrappers under
``ops/kernels/`` (Triton, or CUDA C++ from ``csrc/`` built with nvcc at
first use), each beside its plain PyTorch version.
"""
