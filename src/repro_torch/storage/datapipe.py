"""Tokenized-data pipeline on a volume.

Mirrors ``repro.storage.datapipe``, with the same files:

* ``ShardWriter`` packs documents into fixed-size shard files of int32
  tokens (``/data/shard_00000.tok`` ...) and writes ``/data/META``;
* ``ShardReader`` gives each data-parallel rank its shards, in an order
  drawn once from ``RandomState(seed)``, and addresses a batch by its step,
  so a restarted trainer replays the same batches.

On a CFS volume (``core.fs.CfsMount``) a shard is read as the reference
reads it, by ``hedged_read_file``: the client's ``read_extents`` races the
next replica against an attempt whose modeled latency passes ``hedge_us``,
and only the winner is charged.  A ``LocalMount`` has no replicas, so there
a shard is read whole with ``read_file``.
"""

from __future__ import annotations

import json
from typing import Dict, Iterator, List

import numpy as np

from .. import obs
from ..core.client import NotFound
from ..core.fs import CfsMount

__all__ = ["ShardWriter", "ShardReader", "hedged_read_file"]


class ShardWriter:
    def __init__(self, mount, base: str = "/data", tokens_per_shard: int = 1 << 16,
                 dtype=np.int32):
        self.mnt = mount
        self.base = base
        self.tokens_per_shard = tokens_per_shard
        self.dtype = dtype
        if not self.mnt.exists(base):
            self.mnt.mkdir(base)
        self._buf: List[int] = []
        self._n = 0

    def add_document(self, tokens: List[int]) -> None:
        self._buf.extend(tokens)
        while len(self._buf) >= self.tokens_per_shard:
            self._flush_shard(self._buf[: self.tokens_per_shard])
            self._buf = self._buf[self.tokens_per_shard:]

    def _flush_shard(self, toks: List[int]) -> None:
        arr = np.asarray(toks, dtype=self.dtype)
        self.mnt.write_file(f"{self.base}/shard_{self._n:05d}.tok", arr.tobytes())
        self._n += 1

    def finish(self) -> int:
        """Pad and write the last shard, then META; returns the shard count."""
        if self._buf:
            pad = self.tokens_per_shard - len(self._buf)
            self._flush_shard(self._buf + [0] * pad)
            self._buf = []
        self.mnt.write_file(f"{self.base}/META",
                            json.dumps({"shards": self._n,
                                        "tokens_per_shard": self.tokens_per_shard}).encode())
        return self._n


def hedged_read_file(mount: CfsMount, path: str, hedge_us: float = 2_000.0) -> bytes:
    """The whole file at ``path``, read through the client's hedged
    ``read_extents``; the winning replica lands in its read-affinity map."""
    client = mount.client
    _, _, dentry = mount._resolve(path)
    if dentry is None:
        raise NotFound(path)
    inode = client.get_inode(dentry["inode"])
    return client.read_extents(inode, 0, inode["size"], hedge_us=hedge_us)


class ShardReader:
    """Deterministic per-rank batches: ``batch_at(step)`` is the same on every call."""

    def __init__(self, mount, base: str, rank: int, world: int, batch: int,
                 seq_len: int, hedge_us: float = 2_000.0, seed: int = 0):
        self.mnt = mount
        self.base = base
        self.rank = rank
        self.world = world
        self.batch = batch
        self.seq_len = seq_len
        self.hedge_us = hedge_us
        meta = json.loads(mount.read_file(f"{base}/META").decode())
        self.n_shards = meta["shards"]
        self.tokens_per_shard = meta["tokens_per_shard"]
        self.dtype = np.int32
        self._order = list(range(self.n_shards))
        np.random.RandomState(seed).shuffle(self._order)

    def my_shards(self) -> List[int]:
        return [s for i, s in enumerate(self._order) if i % self.world == self.rank]

    def _read(self, path: str) -> bytes:
        if isinstance(self.mnt, CfsMount):
            return hedged_read_file(self.mnt, path, self.hedge_us)
        return self.mnt.read_file(path)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """{"tokens", "labels"}: int32 [batch, seq_len], the labels shifted by one."""
        with obs.span("datapipe.batch"):
            need = self.batch * (self.seq_len + 1)
            shards = self.my_shards()
            toks: List[np.ndarray] = []
            got = 0
            cursor = (step * need) // self.tokens_per_shard
            offset = (step * need) % self.tokens_per_shard
            while got < need:
                sid = shards[cursor % len(shards)]
                raw = self._read(f"{self.base}/shard_{sid:05d}.tok")
                arr = np.frombuffer(raw, dtype=self.dtype)[offset:]
                toks.append(arr[: need - got])
                got += len(toks[-1])
                cursor += 1
                offset = 0
            flat = np.concatenate(toks)[:need].reshape(self.batch, self.seq_len + 1)
            return {"tokens": flat[:, :-1].astype(np.int32),
                    "labels": flat[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
