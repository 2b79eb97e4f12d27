"""A string -> factory registry, the reference's decorator registries
(datasets, dependency blocks) as one generic class."""

from __future__ import annotations

from typing import Any, Callable, Dict


class Registry:
    """A named mapping from string keys to factories/classes."""

    def __init__(self, name: str):
        self.name = name
        self._entries: Dict[str, Any] = {}

    def register(self, key: str) -> Callable:
        def decorator(obj):
            if key in self._entries:
                raise KeyError(f"{key!r} already registered in {self.name}")
            self._entries[key] = obj
            return obj

        return decorator

    def get(self, key: str):
        if key not in self._entries:
            raise KeyError(f"{key!r} not found in registry {self.name!r}; "
                           f"available: {sorted(self._entries)}")
        return self._entries[key]

    def build(self, key: str, *args, **kwargs):
        return self.get(key)(*args, **kwargs)

    def keys(self):
        return self._entries.keys()

    def __contains__(self, key: str) -> bool:
        return key in self._entries


DATASETS = Registry("datasets")
DEPENDENCY_BLOCKS = Registry("dependency_blocks")
