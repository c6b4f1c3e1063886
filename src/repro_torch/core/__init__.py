"""CFS core — the paper's contribution as an in-process distributed system.

The port's own copy of the reference's ``repro.core``, standard library
only: the same script gives the same trajectory in both, bit for bit.

Public surface:
    CfsCluster  — assemble a simulated deployment (RM + meta + data nodes)
    CfsVfs      — POSIX-style VFS (fds, open flags, errno errors)
    CfsMount    — legacy path/string-mode compat wrapper over the VFS
    CfsClient   — lower-level client (caches, workflows, batched meta RPCs)
"""

from .client import CfsClient, CfsFile, FsError, NotFound, Exists
from .fs import CfsCluster, CfsMount
from .meta_session import MetaSession
from .simnet import (EventScheduler, LatencyModel, Network, Resource,
                     SimClock)
from .types import PACKET_SIZE, SMALL_FILE_THRESHOLD
from .vfs import (CfsOSError, CfsVfs, O_ACCMODE, O_APPEND, O_CREAT, O_EXCL,
                  O_RDONLY, O_RDWR, O_TRUNC, O_WRONLY)

__all__ = [
    "CfsCluster", "CfsMount", "CfsClient", "CfsFile", "CfsVfs", "CfsOSError",
    "MetaSession", "FsError", "NotFound", "Exists",
    "O_RDONLY", "O_WRONLY", "O_RDWR", "O_ACCMODE",
    "O_CREAT", "O_EXCL", "O_TRUNC", "O_APPEND",
    "EventScheduler", "LatencyModel", "Network", "Resource", "SimClock",
    "PACKET_SIZE", "SMALL_FILE_THRESHOLD",
]
