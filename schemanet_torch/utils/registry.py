"""A tiny name->factory registry (a copy of ``schemanet_tpu/utils/registry.py``,
which the port does not import): datasets and workers register by name."""

from __future__ import annotations

from typing import Callable, Dict, Generic, Iterator, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    def __init__(self, name: str):
        self.name = name
        self._entries: Dict[str, T] = {}

    def register(self, key: str, value: T = None):
        if value is not None:
            self._entries[key] = value
            return value

        def deco(fn: Callable) -> Callable:
            self._entries[key] = fn
            return fn

        return deco

    def get(self, key: str) -> T:
        if key not in self._entries:
            raise KeyError(
                f"{key!r} is not registered in {self.name!r}; "
                f"known: {sorted(self._entries)}"
            )
        return self._entries[key]

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    def __iter__(self) -> Iterator[str]:
        return iter(self._entries)

    def keys(self):
        return self._entries.keys()
