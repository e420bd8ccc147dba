"""Versioned handle and object stores (a copy of gatling_tpu/utils/handles.py).

Reimplements the reference's handle machinery (src/gb/gtl/gb/HandleStore.h:28-42
and LinearDataStore.h:1-72): 64-bit handles composed of a 32-bit slot index and
a 32-bit version, with slot reuse through a free list. Stale handles (freed or
re-allocated slots) are detected by version mismatch.
"""

from __future__ import annotations

from typing import Any, Iterator


class HandleStore:
    """Allocates versioned 64-bit handles: (version << 32) | index."""

    def __init__(self) -> None:
        self._versions: list[int] = []  # version per slot; odd = alive convention not needed
        self._free: list[int] = []

    def allocate(self) -> int:
        if self._free:
            index = self._free.pop()
            self._versions[index] += 1
        else:
            index = len(self._versions)
            self._versions.append(1)
        return (self._versions[index] << 32) | index

    def is_valid(self, handle: int) -> bool:
        index = handle & 0xFFFFFFFF
        version = handle >> 32
        return 0 <= index < len(self._versions) and version > 0 and self._versions[index] == version and not self._is_free(index)

    def free(self, handle: int) -> None:
        if not self.is_valid(handle):
            raise KeyError(f"invalid handle {handle:#x}")
        index = handle & 0xFFFFFFFF
        self._free.append(index)

    def _is_free(self, index: int) -> bool:
        return index in self._free


class LinearDataStore:
    """Handle -> object storage with slot reuse (reference: gb/LinearDataStore.h)."""

    def __init__(self) -> None:
        self._handles = HandleStore()
        self._objects: dict[int, Any] = {}

    def allocate(self, obj: Any) -> int:
        handle = self._handles.allocate()
        self._objects[handle & 0xFFFFFFFF] = obj
        return handle

    def get(self, handle: int) -> Any:
        if not self._handles.is_valid(handle):
            raise KeyError(f"invalid handle {handle:#x}")
        return self._objects[handle & 0xFFFFFFFF]

    def is_valid(self, handle: int) -> bool:
        return self._handles.is_valid(handle)

    def free(self, handle: int) -> None:
        self._handles.free(handle)
        del self._objects[handle & 0xFFFFFFFF]

    def values(self) -> Iterator[Any]:
        return iter(self._objects.values())

    def __len__(self) -> int:
        return len(self._objects)
