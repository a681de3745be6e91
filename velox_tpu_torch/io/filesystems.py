"""File-system abstraction + scheme registry.

Counterpart of the JAX package's ``io/filesystems.py``.  Reference:
velox/common/file/FileSystems.h — `registerFileSystem(scheme, factory)` with
LocalFileSystem as the default and S3/HDFS/GCS/ABFS adapters registered by the
connectors that need them.  Here the registry maps URI schemes to FileSystem
factories; bare paths resolve to the local filesystem.

The cloud adapters (s3://, hdfs://, gs://, abfs://) are registered as gated
stubs: the package ships no network client, so they raise with a clear message
instead of failing deep inside a read.  Their seam is the same FileSystem
interface — an adapter only needs open_input/open_output/walk.
"""

from __future__ import annotations

import io
import os
from typing import Callable, Dict, Iterator, List, Tuple


class FileSystem:
    """Minimal interface the engine's readers/writers need."""

    def open_input(self, path: str):
        """Binary file-like for reading."""
        raise NotImplementedError

    def open_output(self, path: str):
        """Binary file-like for writing (parents created)."""
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def remove(self, path: str) -> None:
        raise NotImplementedError

    def walk(self, root: str) -> Iterator[Tuple[str, List[str]]]:
        """Yield (directory, file names) pairs under root, sorted."""
        raise NotImplementedError


class LocalFileSystem(FileSystem):
    def open_input(self, path: str):
        return open(path, "rb")

    def open_output(self, path: str):
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        return open(path, "wb")

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def remove(self, path: str) -> None:
        os.unlink(path)

    def walk(self, root: str):
        for dirpath, _dirnames, filenames in sorted(os.walk(root)):
            yield dirpath, sorted(filenames)


class MemoryFileSystem(FileSystem):
    """In-process filesystem (memory:// scheme) — the analog of the
    reference's InMemoryFileSystem used by tests (FileSystems.cpp)."""

    def __init__(self):
        self.files: Dict[str, bytes] = {}

    def open_input(self, path: str):
        if path not in self.files:
            raise FileNotFoundError(path)
        return io.BytesIO(self.files[path])

    def open_output(self, path: str):
        fs = self

        class _Buf(io.BytesIO):
            def close(self):  # capture on close
                fs.files[path] = self.getvalue()
                super().close()

        return _Buf()

    def exists(self, path: str) -> bool:
        return path in self.files

    def remove(self, path: str) -> None:
        del self.files[path]

    def walk(self, root: str):
        root = root.rstrip("/")
        by_dir: Dict[str, List[str]] = {}
        for p in sorted(self.files):
            if p == root or p.startswith(root + "/"):
                d, f = p.rsplit("/", 1)
                by_dir.setdefault(d, []).append(f)
        for d in sorted(by_dir):
            yield d, by_dir[d]


def _gated(scheme: str, hint: str) -> Callable[[], FileSystem]:
    class _Stub(FileSystem):
        def _raise(self, *a, **k):
            raise NotImplementedError(
                f"{scheme}:// filesystem adapter is not built into this "
                f"package (no network egress); {hint}"
            )

        open_input = open_output = exists = remove = walk = _raise

    return _Stub


_REGISTRY: Dict[str, Callable[[], FileSystem]] = {}
_INSTANCES: Dict[str, FileSystem] = {}


def register_filesystem(scheme: str, factory: Callable[[], FileSystem]):
    """Register a FileSystem factory for a URI scheme (reference:
    filesystems::registerFileSystem)."""
    _REGISTRY[scheme] = factory
    _INSTANCES.pop(scheme, None)


def filesystem_for(path: str) -> Tuple[FileSystem, str]:
    """Resolve a path/URI to (filesystem, scheme-local path)."""
    if "://" in path:
        scheme, rest = path.split("://", 1)
    else:
        scheme, rest = "file", path
    if scheme not in _REGISTRY:
        raise ValueError(
            f"no filesystem registered for scheme {scheme!r} "
            f"(registered: {sorted(_REGISTRY)})"
        )
    if scheme not in _INSTANCES:
        _INSTANCES[scheme] = _REGISTRY[scheme]()
    local = rest if scheme != "file" else path
    if scheme == "memory":
        local = path  # keep the full URI as the key namespace
    return _INSTANCES[scheme], local


register_filesystem("file", LocalFileSystem)
register_filesystem("memory", MemoryFileSystem)
for _scheme, _hint in (
    ("s3", "reference adapter: velox/connectors/hive/storage_adapters/s3fs"),
    ("hdfs", "reference adapter: velox/connectors/hive/storage_adapters/hdfs"),
    ("gs", "reference adapter: velox/connectors/hive/storage_adapters/gcs"),
    ("abfs", "reference adapter: velox/connectors/hive/storage_adapters/abfs"),
):
    register_filesystem(_scheme, _gated(_scheme, _hint))
