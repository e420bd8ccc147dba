"""Asset readers: pluggable byte sources for textures and scene payloads
(gatling_tpu/render/assets.py, copied class for class).

Reimplements the reference's asset-reader stack
(reference: src/gi/impl/AssetReader.cpp — GiMmapAssetReader mapping files,
GiAggregateAssetReader chaining registered readers; registered by the Hydra
plugin to route reads through USD's ArResolver, rendererPlugin.cpp:95-143).
Host applications register readers via gi_register_asset_reader to serve
assets from archives, resolvers, or object stores; the texture manager
reads every image through `read_asset`.
"""

from __future__ import annotations

import abc
import mmap
import os


class GiAsset:
    """An opened asset (opaque payload holder, reference: GiAsset)."""

    def __init__(self, data, size: int, closer=None):
        self._data = data
        self._size = size
        self._closer = closer

    def size(self) -> int:
        return self._size

    def data(self) -> bytes | memoryview:
        return self._data

    def close(self) -> None:
        if isinstance(self._data, memoryview):
            self._data.release()  # mmap refuses to close with live views
        self._data = b""
        if self._closer:
            self._closer()
            self._closer = None


class GiAssetReader(abc.ABC):
    """Reference: Gi.h class GiAssetReader (open/size/data/close)."""

    @abc.abstractmethod
    def open(self, path: str) -> GiAsset | None:
        ...


class GiMmapAssetReader(GiAssetReader):
    """Memory-maps files (reference: impl/Mmap.cpp + GiMmapAssetReader)."""

    def open(self, path: str) -> GiAsset | None:
        try:
            f = open(path, "rb")
        except OSError:
            return None
        try:
            size = os.fstat(f.fileno()).st_size
            if size == 0:
                f.close()
                return GiAsset(b"", 0)
            mapped = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except (OSError, ValueError):
            f.close()
            return None

        def closer():
            mapped.close()
            f.close()

        return GiAsset(memoryview(mapped), size, closer)


class GiAggregateAssetReader(GiAssetReader):
    """Tries registered readers in order (reference: GiAggregateAssetReader)."""

    def __init__(self) -> None:
        self._readers: list[GiAssetReader] = []

    def register(self, reader: GiAssetReader) -> None:
        self._readers.append(reader)

    def open(self, path: str) -> GiAsset | None:
        for reader in self._readers:
            asset = reader.open(path)
            if asset is not None:
                return asset
        return None


# process-wide aggregate, seeded with the mmap reader like giInitialize does
_aggregate = GiAggregateAssetReader()
_aggregate.register(GiMmapAssetReader())


def gi_register_asset_reader(reader: GiAssetReader) -> None:
    """giRegisterAssetReader analog."""
    _aggregate.register(reader)


def read_asset(path: str) -> bytes | None:
    """Read a whole asset through the registered reader chain."""
    asset = _aggregate.open(path)
    if asset is None:
        return None
    try:
        return bytes(asset.data())
    finally:
        asset.close()
