"""Sharded, crash-safe checkpoints of tensor trees on a volume.

Mirrors ``repro.storage.checkpoint`` file for file, so that either package
restores the other's checkpoints bit for bit:

    /ckpt/step_<N>/<leaf>.shard<k>   (tensor shards, ``RPT1`` files)
    /ckpt/step_<N>/MANIFEST          (JSON: per leaf its dtype, shape and shards)
    /ckpt/LATEST                     (the step of the newest commit)

A leaf is named by its dict keys joined with ``~`` (``params~emb~tok``),
keys in sorted order, as JAX flattens a dict; ``None`` subtrees hold no
leaf.  A leaf whose dim 0 divides into ``shards`` is split along it, so a
checkpoint written with one shard count restores with another.  Each
shard file carries a ``zlib.crc32`` in the manifest, verified on restore.
Crash safety: tensor files first, MANIFEST second, LATEST last.

Two differences from the reference:
  * a step directory without a MANIFEST (a save that crashed) is cleared
    and written again when that step is saved, and removed by the garbage
    collection once a later step commits; the reference skips the step's
    save and keeps the torn directory for good;
  * ``restore`` copies each leaf into the tensor of ``tree_like`` in place
    (so onto its device and into its dtype) and returns that tree: a
    training state on the card has no room for a second copy.  A restore
    that fails leaves the leaves before the failing one overwritten.
``last_io`` holds the bytes and the seconds of the last save or restore
by stage, read from its spans (``ckpt.save`` or ``ckpt.restore``, each
stage a ``ckpt.<stage>`` span inside it; ``repro_torch.obs``).
"""

from __future__ import annotations

import contextlib
import json
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..core.client import NotFound

__all__ = ["CheckpointManager", "tensor_to_bytes", "bytes_to_tensor"]

_MAGIC = b"RPT1"
Tree = Dict[str, Any]


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[-1]      # numpy's name: float32, bfloat16, int32, ...


def tensor_to_bytes(t: torch.Tensor) -> bytes:
    """An ``RPT1`` file: magic, header length, JSON header, raw little-endian
    data.  bf16 is written as its 16 bits."""
    t = t.detach().cpu().contiguous()
    header = json.dumps({"dtype": _dtype_name(t.dtype), "shape": list(t.shape)}).encode()
    raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    # one copy: join reads the array's memory where tobytes() would copy it first
    return b"".join((_MAGIC, len(header).to_bytes(4, "little"), header,
                     raw.reshape(-1).view(np.uint8)))


def bytes_to_tensor(data: bytes) -> torch.Tensor:
    """Inverse of :func:`tensor_to_bytes`: a CPU tensor of the file's dtype."""
    if data[:4] != _MAGIC:
        raise ValueError("bad tensor file: no RPT1 magic")
    hlen = int.from_bytes(data[4:8], "little")
    header = json.loads(data[8:8 + hlen].decode())
    raw = memoryview(data)[8 + hlen:]
    if header["dtype"] == "bfloat16":
        t = torch.from_numpy(np.frombuffer(raw, np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.frombuffer(raw, np.dtype(header["dtype"])).copy())
    return t.reshape(header["shape"])


def _flatten(tree: Tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    """(name, leaf) in JAX's order: keys sorted, ``None`` skipped."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        elif v is not None:
            yield "~".join(prefix + (k,)), v


class CheckpointManager:
    def __init__(self, mount, base: str = "/ckpt", shards: int = 1, keep_n: int = 2):
        self.mnt = mount
        self.base = base
        self.shards = shards
        self.keep_n = keep_n
        self.last_io: Dict[str, float] = {}
        if not self.mnt.exists(base):
            self.mnt.mkdir(base)

    @contextlib.contextmanager
    def _timed(self, stage: str):
        """A ``ckpt.<stage>`` span, its seconds added to ``last_io["<stage>_s"]``."""
        with obs.span(f"ckpt.{stage}") as sp:
            yield
        key = f"{stage}_s"
        self.last_io[key] = self.last_io.get(key, 0.0) + sp.host_ns / 1e9

    # ---- save ----------------------------------------------------------------
    def save(self, step: int, tree: Tree, crash_after: Optional[int] = None) -> str:
        """Write the checkpoint of ``step``.  ``crash_after``: fault injection,
        raise after that many file writes."""
        d = f"{self.base}/step_{step}"
        if self.mnt.exists(d):
            if self.mnt.exists(f"{d}/MANIFEST"):
                return d
            self._remove(d)                   # torn by a crashed save
        self.mnt.mkdir(d)
        self.last_io = {"bytes": 0}
        with obs.span("ckpt.save") as sp:
            manifest: Dict[str, Any] = {"step": step, "tensors": {}}
            writes = 0
            for name, leaf in _flatten(tree):
                with self._timed("device_to_host"):
                    host = leaf.detach().cpu()
                nsh = self.shards if (host.dim() > 0 and host.shape[0] >= self.shards
                                      and host.shape[0] % self.shards == 0) else 1
                per = host.shape[0] // nsh if nsh > 1 else 0
                parts = [host[i * per:(i + 1) * per] for i in range(nsh)] if nsh > 1 else [host]
                entry = {"shards": [], "dtype": _dtype_name(host.dtype), "shape": list(host.shape)}
                for k, part in enumerate(parts):
                    path = f"{d}/{name}.shard{k}"
                    with self._timed("serialize"):
                        payload = tensor_to_bytes(part)
                    with self._timed("write"):
                        self.mnt.write_file(path, payload)
                    writes += 1
                    if crash_after is not None and writes >= crash_after:
                        raise RuntimeError("injected crash during checkpoint save")
                    with self._timed("crc32"):
                        crc = zlib.crc32(payload) & 0xFFFFFFFF
                    entry["shards"].append({"path": path, "bytes": len(payload), "crc32": crc})
                    self.last_io["bytes"] += len(payload)
                manifest["tensors"][name] = entry
            # data durable -> manifest -> commit pointer
            self.mnt.write_file(f"{d}/MANIFEST", json.dumps(manifest).encode())
            if crash_after is not None and writes + 1 >= crash_after:
                raise RuntimeError("injected crash before LATEST commit")
            if self.mnt.exists(f"{self.base}/LATEST"):
                self.mnt.unlink(f"{self.base}/LATEST")
            self.mnt.write_file(f"{self.base}/LATEST", str(step).encode())
        self.last_io["s"] = sp.host_ns / 1e9
        self._gc(step)
        return d

    def _remove(self, d: str) -> None:
        for name in self.mnt.readdir(d):
            self.mnt.unlink(f"{d}/{name}")
        self.mnt.rmdir(d)

    def _gc(self, newest: int) -> None:
        """Keep the newest ``keep_n`` committed steps; drop torn steps older
        than ``newest``."""
        steps = self.list_steps()
        doomed = steps[: max(0, len(steps) - self.keep_n)]
        doomed += [s for s in self._torn_steps() if s < newest]
        for s in doomed:
            self._remove(f"{self.base}/step_{s}")

    # ---- load -----------------------------------------------------------------
    def _step_dirs(self) -> List[Tuple[int, bool]]:
        """(step, committed) of every ``step_<N>`` directory."""
        out = []
        for name in self.mnt.readdir(self.base):
            if name.startswith("step_") and name[5:].isdigit():
                out.append((int(name[5:]), self.mnt.exists(f"{self.base}/{name}/MANIFEST")))
        return out

    def _torn_steps(self) -> List[int]:
        return sorted(s for s, committed in self._step_dirs() if not committed)

    def list_steps(self) -> List[int]:
        return sorted(s for s, committed in self._step_dirs() if committed)

    def latest_step(self) -> Optional[int]:
        try:
            return int(self.mnt.read_file(f"{self.base}/LATEST").decode())
        except (NotFound, ValueError):
            steps = self.list_steps()
            return steps[-1] if steps else None

    @torch.no_grad()
    def restore(self, tree_like: Tree, step: Optional[int] = None) -> Tuple[Tree, int]:
        """Fill ``tree_like``'s tensors with the checkpoint of ``step`` (default:
        the latest) and return (tree_like, step).  Every shard's CRC32 is
        checked before its leaf is written."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise NotFound("no checkpoint")
        d = f"{self.base}/step_{step}"
        manifest = json.loads(self.mnt.read_file(f"{d}/MANIFEST").decode())
        self.last_io = {"bytes": 0}
        with obs.span("ckpt.restore") as sp:
            on_cuda = False
            for name, dst in _flatten(tree_like):
                entry = manifest["tensors"][name]
                if list(dst.shape) != entry["shape"]:
                    raise ValueError(f"{name}: checkpoint shape {entry['shape']}, "
                                     f"tree shape {list(dst.shape)}")
                parts = []
                for sh in entry["shards"]:
                    with self._timed("read"):
                        data = self.mnt.read_file(sh["path"])
                    with self._timed("crc32"):
                        ok = (zlib.crc32(data) & 0xFFFFFFFF) == sh["crc32"]
                    if not ok:
                        raise IOError(f"checksum mismatch in {sh['path']}")
                    with self._timed("deserialize"):
                        parts.append(bytes_to_tensor(data))
                    self.last_io["bytes"] += len(data)
                with self._timed("host_to_device"):
                    if len(parts) == 1:
                        dst.copy_(parts[0].reshape(dst.shape))
                    else:
                        row = 0
                        for part in parts:
                            dst[row:row + part.shape[0]].copy_(part)
                            row += part.shape[0]
                    on_cuda = on_cuda or dst.is_cuda
            if on_cuda:
                with self._timed("host_to_device"):
                    torch.cuda.synchronize()
        self.last_io["s"] = sp.host_ns / 1e9
        return tree_like, step
