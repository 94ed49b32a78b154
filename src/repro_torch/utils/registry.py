"""A tiny name->factory registry (envs, archs, game managers, losses)."""
from __future__ import annotations

from typing import Callable, Dict, Generic, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    def __init__(self, kind: str):
        self.kind = kind
        self._items: Dict[str, T] = {}

    def register(self, name: str, item: T | None = None):
        if item is not None:
            self._items[name] = item
            return item

        def deco(fn: T) -> T:
            self._items[name] = fn
            return fn

        return deco

    def get(self, name: str) -> T:
        if name not in self._items:
            raise KeyError(f"unknown {self.kind} {name!r}; known: {sorted(self._items)}")
        return self._items[name]

    def __contains__(self, name: str) -> bool:
        return name in self._items

    def names(self):
        return sorted(self._items)
