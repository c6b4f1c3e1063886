"""A volume on a local directory, beside a mounted CFS volume (``core.fs.CfsMount``).

The storage layer reads and writes through seven methods of a CFS mount:
``exists``, ``mkdir``, ``write_file``, ``read_file``, ``readdir``,
``unlink`` and ``rmdir``.  ``LocalMount`` implements those seven over a
root directory: the volume path ``/ckpt/step_2/MANIFEST`` is the file
``<root>/ckpt/step_2/MANIFEST``.  A write is on disk before it returns
(the file and its directory entry are fsynced), so the checkpoint's
commit order (tensor files, then MANIFEST, then LATEST) holds across a
crash.  Errors are the operating system's, except that ``read_file`` of a
missing path raises ``NotFound``: the class that the port's CFS mount
raises (``core.client.NotFound``, a ``FileNotFoundError``), so code on
either mount catches one class.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List

from ..core.client import NotFound

__all__ = ["LocalMount", "NotFound"]


class LocalMount:
    def __init__(self, root):
        self.root = Path(root).resolve()
        if not self.root.is_dir():
            raise NotADirectoryError(f"volume root {self.root} is not a directory")

    def _host(self, path: str) -> Path:
        """The file under the root that a volume path names."""
        parts = [p for p in path.split("/") if p]
        if not path.startswith("/") or any(p in (".", "..") for p in parts):
            raise ValueError(f"not an absolute volume path without '.' or '..': {path!r}")
        return self.root.joinpath(*parts)

    def exists(self, path: str) -> bool:
        return self._host(path).exists()

    def mkdir(self, path: str) -> None:
        self._host(path).mkdir()

    def write_file(self, path: str, data: bytes) -> None:
        """Creates or replaces the file, and returns once it is on disk."""
        host = self._host(path)
        with open(host, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        fd = os.open(host.parent, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def read_file(self, path: str) -> bytes:
        host = self._host(path)
        try:
            with open(host, "rb") as f:
                return f.read()
        except FileNotFoundError as e:
            raise NotFound(path) from e

    def readdir(self, path: str) -> List[str]:
        return sorted(os.listdir(self._host(path)))

    def unlink(self, path: str) -> None:
        self._host(path).unlink()

    def rmdir(self, path: str) -> None:
        self._host(path).rmdir()
