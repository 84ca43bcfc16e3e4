"""PyTorch/CUDA port of :mod:`znicz_tpu` for one NVIDIA H100.

The JAX package ``znicz_tpu`` is the reference; this package mirrors its
module paths (``core/``, ``ops/``, ``nn/``, ``loader/``, ``workflow/``,
``models/``, ``services/``, ``observability/``) and keeps its public layouts
(NHWC activations, HWIO conv weights, ``[n_in, n_out]`` FC weights, a list
of per-layer param dicts), so the two can be held against each other on the
same numpy inputs.

It imports ``torch`` and numpy, never ``jax`` nor anything of
``znicz_tpu``.  Entry points run on the card unless the caller passes
``device="cpu"``; without a card they raise instead of falling back.  The
TPU kernels on the ported paths are hand-written for Hopper: wrappers under
``ops/kernels/`` (Triton, or CUDA C++ from ``csrc/`` built with nvcc at
first use), each beside its plain PyTorch version.

The top level exports the JAX package's names, the heavy ones lazily
(PEP 562), except ``Ensemble``, whose module is still to port (ROADMAP.md
A11).
"""

__version__ = "0.1.0"

from znicz_tpu_torch.core.config import Config, root  # noqa: F401
from znicz_tpu_torch.core.logger import Logger  # noqa: F401

# Lazy top-level API (PEP 562): keeps torch and the subsystems out of a
# bare `import znicz_tpu_torch`.
_LAZY = {
    "prng": ("znicz_tpu_torch.core", "prng"),
    "Workflow": ("znicz_tpu_torch.workflow", "Workflow"),
    "StandardWorkflow": ("znicz_tpu_torch.workflow", "StandardWorkflow"),
    "KohonenWorkflow": ("znicz_tpu_torch.workflow", "KohonenWorkflow"),
    "RBMWorkflow": ("znicz_tpu_torch.workflow", "RBMWorkflow"),
    "TransformerLMWorkflow": ("znicz_tpu_torch.workflow", "TransformerLMWorkflow"),
    "Snapshotter": ("znicz_tpu_torch.workflow", "Snapshotter"),
    "FullBatchLoader": ("znicz_tpu_torch.loader", "FullBatchLoader"),
    "ImageDirectoryLoader": ("znicz_tpu_torch.loader", "ImageDirectoryLoader"),
    "DataParallel": ("znicz_tpu_torch.parallel", "DataParallel"),
    "make_mesh": ("znicz_tpu_torch.parallel", "make_mesh"),
    "export_model": ("znicz_tpu_torch.export", "export_model"),
}


def __getattr__(name):
    import importlib

    if name in _LAZY:
        module, attr = _LAZY[name]
        value = getattr(importlib.import_module(module), attr)
        globals()[name] = value  # cache: next access is a plain lookup
        return value
    raise AttributeError(f"module 'znicz_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(set(list(globals()) + list(_LAZY)))
