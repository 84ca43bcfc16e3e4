"""Named, deterministically seeded random generator registry.

Port of ``znicz_tpu/core/prng.py``.  Generators are shared *by name* so
weight init, shuffling and dropout are reproducible.  The host-side numpy
streams (``np.random.default_rng(seed)``) and the name-derived seeds
(:func:`_default_seed`, :func:`hash_name`) are bit-identical to the JAX
package's, so the same seed gives the same initial weights and the same
shuffle order in both frameworks.  Where the JAX package hands out
``jax.random`` keys, each named generator here owns one ``torch.Generator``
per device, seeded from the same integer seed (device draws therefore do not
reproduce JAX's threefry bits).

``state_dict`` holds JAX's keys ``seed`` and ``numpy_state`` and, under
``torch_states``, each torch generator's ``get_state()`` as a uint8 array,
so a resumed run draws what the uninterrupted one would.  A JAX snapshot's
threefry key (``key``, ``key_impl``) is kept as data: it cannot seed a
``torch.Generator``, so those streams restart from the generator's seed.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch


class RandomGenerator:
    """A named generator: one numpy stream plus per-device torch streams."""

    def __init__(self, name: str, seed: Optional[int] = None):
        self.name = name
        self._seed = None
        self._numpy = None
        self._torch: Dict[str, torch.Generator] = {}
        # restored states of generators not created yet (a snapshot taken
        # on another device), and a JAX snapshot's key, kept as data
        self._pending: Dict[str, np.ndarray] = {}
        self._jax_key: Dict[str, Any] = {}
        self.seed(seed if seed is not None else _default_seed(name))

    def seed(self, value: int) -> None:
        self._seed = int(value)
        self._numpy = np.random.default_rng(self._seed)
        self._torch = {}
        self._pending = {}
        self._jax_key = {}

    def generator(self, device) -> torch.Generator:
        """This name's ``torch.Generator`` on ``device`` (created on first
        use, seeded from the generator's seed); advances as it is drawn."""
        dev = torch.device(device)
        key = str(dev)
        gen = self._torch.get(key)
        if gen is None:
            gen = torch.Generator(device=dev)
            state = self._pending.pop(key, None)
            if state is None:
                gen.manual_seed(self._seed)
            else:
                gen.set_state(torch.from_numpy(state.copy()))
            self._torch[key] = gen
        return gen

    # -- host-side draws (numpy outputs) -------------------------------------
    def normal(self, shape, mean=0.0, stddev=1.0, dtype=np.float32) -> np.ndarray:
        return (self._numpy.standard_normal(shape) * stddev + mean).astype(dtype)

    def uniform(self, shape, low=-1.0, high=1.0, dtype=np.float32) -> np.ndarray:
        return self._numpy.uniform(low, high, shape).astype(dtype)

    def permutation(self, n: int) -> np.ndarray:
        return self._numpy.permutation(n)

    def integers(self, low, high, shape=()) -> np.ndarray:
        return self._numpy.integers(low, high, shape)

    # -- snapshot support (the exact-resume contract) ------------------------
    def state_dict(self) -> dict:
        torch_states = dict(self._pending)
        torch_states.update(
            {k: g.get_state().numpy().copy() for k, g in self._torch.items()}
        )
        return {
            "seed": self._seed,
            "numpy_state": self._numpy.bit_generator.state,
            "torch_states": torch_states,
            **self._jax_key,
        }

    def load_state_dict(self, state: dict) -> None:
        """Restore a stream position captured by :meth:`state_dict`, or by
        the JAX package's.  The torch generators already handed out keep
        their identity (a train state holds them) and take the saved
        state, or, when the snapshot has none (a JAX snapshot), restart
        from the seed."""
        self._seed = int(state["seed"])
        self._numpy = np.random.default_rng()
        self._numpy.bit_generator.state = state["numpy_state"]
        self._jax_key = {k: state[k] for k in ("key", "key_impl") if k in state}
        saved = {k: np.asarray(v, np.uint8) for k, v in state.get("torch_states", {}).items()}
        for key, gen in self._torch.items():
            got = saved.pop(key, None)
            if got is None:
                gen.manual_seed(self._seed)
            else:
                gen.set_state(torch.from_numpy(got.copy()))
        self._pending = saved


_registry: Dict[str, RandomGenerator] = {}
_global_seed: Optional[int] = None


def _default_seed(name: str) -> int:
    # same derivation as the JAX package: from the global seed when one was
    # set (seed_all), else from the name alone
    if _global_seed is not None:
        return (_global_seed ^ hash_name(name)) % (2**31)
    return abs(hash_name(name)) % (2**31)


def hash_name(name: str) -> int:
    h = 0
    for ch in name:
        h = (h * 31 + ord(ch)) & 0x7FFFFFFF
    return h


def get(name: str = "default") -> RandomGenerator:
    """Return the shared generator registered under ``name`` (creating it)."""
    gen = _registry.get(name)
    if gen is None:
        gen = RandomGenerator(name)
        _registry[name] = gen
    return gen


def names() -> list:
    """Names of every currently registered generator."""
    return list(_registry)


def seed_all(seed: int) -> None:
    """Reseed every generator (current and future) from one master seed:
    generator ``name`` gets ``seed ^ hash(name)``."""
    global _global_seed
    _global_seed = int(seed)
    for name, gen in _registry.items():
        gen.seed((seed ^ hash_name(name)) % (2**31))


def state_dict() -> dict:
    """Capture every named generator's stream position (for snapshots)."""
    return {
        "global_seed": _global_seed,
        "generators": {n: g.state_dict() for n, g in _registry.items()},
    }


def load_state_dict(state: dict) -> None:
    """Restore generator streams captured by :func:`state_dict` (the port's
    or the JAX package's); resumed runs draw the same shuffles as the
    uninterrupted run."""
    global _global_seed
    _global_seed = state["global_seed"]
    for name, gen_state in state["generators"].items():
        get(name).load_state_dict(gen_state)


def reset() -> None:
    """Drop all registered generators and the global seed (test isolation)."""
    global _global_seed
    _global_seed = None
    _registry.clear()
