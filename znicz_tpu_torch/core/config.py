"""Auto-vivifying configuration tree (the port's own copy).

Same class and semantics as ``znicz_tpu/core/config.py``: a global attribute
tree ``root`` that config files mutate, with deep ``update({...})`` merging.
The port keeps a copy instead of importing it so that nothing of the JAX
package is loaded.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Iterator


class Config:
    """A node in the auto-vivifying config tree.

    Attribute access on a missing name creates a child ``Config`` node, so
    configs can be written as ``root.mnist.learning_rate = 0.03`` without
    declaring intermediate nodes first.
    """

    __slots__ = ("__dict__", "_config_path_")

    def __init__(self, path: str = "") -> None:
        object.__setattr__(self, "_config_path_", path)

    # -- auto-vivification ------------------------------------------------
    def __getattr__(self, name: str) -> "Config":
        if name.startswith("__") and name.endswith("__"):
            raise AttributeError(name)
        child = Config(f"{self._config_path_}.{name}" if self._config_path_ else name)
        self.__dict__[name] = child
        return child

    def __setattr__(self, name: str, value: Any) -> None:
        self.__dict__[name] = value

    def __delattr__(self, name: str) -> None:
        del self.__dict__[name]

    # -- mapping-style access --------------------------------------------
    def __getitem__(self, name: str) -> Any:
        return getattr(self, name)

    def __setitem__(self, name: str, value: Any) -> None:
        setattr(self, name, value)

    def __contains__(self, name: str) -> bool:
        return name in self.__dict__

    def __iter__(self) -> Iterator[str]:
        return iter(self.keys())

    def keys(self):
        return [k for k in self.__dict__ if not k.startswith("_")]

    def items(self):
        return [(k, self.__dict__[k]) for k in self.keys()]

    # -- deep update ------------------------------------------------------
    def update(self, tree: Dict[str, Any]) -> "Config":
        """Deep-merge a nested dict into this node (reference ``root.update``)."""
        if not isinstance(tree, dict):
            raise TypeError(f"Config.update expects a dict, got {type(tree)}")
        for key, value in tree.items():
            if isinstance(value, dict):
                node = self.__dict__.get(key)
                if not isinstance(node, Config):
                    node = Config(
                        f"{self._config_path_}.{key}" if self._config_path_ else key
                    )
                    self.__dict__[key] = node
                node.update(value)
            else:
                self.__dict__[key] = value
        return self

    # -- introspection ----------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for key, value in self.items():
            out[key] = value.to_dict() if isinstance(value, Config) else value
        return out

    def get(self, name: str, default: Any = None) -> Any:
        """Non-vivifying lookup: returns ``default`` if unset or empty node."""
        value = self.__dict__.get(name, default)
        if isinstance(value, Config) and not value.keys():
            return default
        return value

    def copy(self) -> "Config":
        clone = Config(self._config_path_)
        clone.update(copy.deepcopy(self.to_dict()))
        return clone

    def clear(self) -> None:
        for key in list(self.keys()):
            del self.__dict__[key]

    def __repr__(self) -> str:
        return f"Config({self._config_path_!r}, {self.to_dict()!r})"


#: Global configuration root, mutated by config modules (two-file UX:
#: ``workflow.py`` + ``config.py`` overrides, reference veles/__main__.py).
root = Config("root")
