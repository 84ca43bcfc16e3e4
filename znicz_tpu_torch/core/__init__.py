"""Host-side core: config tree, named PRNG registry, device selection.

``Logger`` (``core/logger.py``) is ROADMAP.md A11."""

from znicz_tpu_torch.core.config import Config, root  # noqa: F401


def __getattr__(name):
    # PEP 562: prng pulls in torch — load it on first use, as the JAX
    # package loads its prng (and jax) on first use
    if name == "prng":
        import importlib

        module = importlib.import_module("znicz_tpu_torch.core.prng")
        globals()[name] = module
        return module
    raise AttributeError(f"module 'znicz_tpu_torch.core' has no attribute {name!r}")
