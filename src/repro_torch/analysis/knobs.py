"""Central registry of every ``CFS_*`` environment knob.

The port's own copy of the reference's ``repro.analysis.knobs``: the same
names, defaults, types and docs, so that one environment variable (CI's
``CFS_META_ASYNC=1``, say) drives both packages alike.  ``module`` keeps the
reference's dotted names, which the port's ``repro_torch.<same path>``
mirrors, so the two tables compare equal.  The storage plane's modules read
their tunables through :func:`get_int` / :func:`get_float` /
:func:`get_bool` instead of touching ``os.environ`` directly, and an access
to a name missing from this table raises immediately, so a knob can never
be parsed in two places with two defaults.  The reference's README sync
(``--write-readme`` / ``--check``) stays with the reference.

This module imports only the stdlib so that ``core`` and
``analysis.sanitizer`` can depend on it without cycles.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Dict

__all__ = ["Knob", "KNOBS", "UnregisteredKnob", "get_int", "get_float",
           "get_str", "get_bool"]


class UnregisteredKnob(KeyError):
    """An env knob was read without being declared in :data:`KNOBS`."""


@dataclass(frozen=True)
class Knob:
    name: str            # environment variable, e.g. "CFS_META_TTL"
    default: str         # default as the env string (pre-parse)
    type: str            # "int" | "float" | "bool"
    doc: str             # one-line description
    zero_means: str      # what 0 / off selects (every knob has a 0 mode)
    module: str          # owning module (dotted, under repro.)
    pr: int              # the reference's change that introduced the knob


# Declaration order is the reference's.
_DECLS = [
    Knob("CFS_PIPELINE_DEPTH", "8", "int",
         "Max in-flight append packets per file handle",
         "synchronous per-packet seed path",
         "repro.core.client", 2),
    Knob("CFS_SYNC_WINDOW_US", "1000", "float",
         "Min virtual µs between routing-miss sync_partitions refreshes",
         "refresh on every routing miss",
         "repro.core.client", 4),
    Knob("CFS_READ_WINDOW", "8", "int",
         "Concurrent packet-fetch window (and readahead depth) for reads",
         "serial per-packet seed path",
         "repro.core.client", 3),
    Knob("CFS_HEDGE_READS", "1", "bool",
         "Hedge packet reads against a p99 EWMA budget per replica group",
         "hedging off",
         "repro.core.client", 3),
    Knob("CFS_RAFT_FANOUT", "1", "bool",
         "Fork raft AppendEntries legs concurrently under timed ops",
         "serial legs",
         "repro.core.raft", 4),
    Knob("CFS_META_TTL", "1000000", "float",
         "Metadata lease TTL in virtual µs (server grant = client cache)",
         "seed sync-on-open (no lease caching)",
         "repro.core.meta_session", 4),
    Knob("CFS_META_NEG_TTL", "100000", "float",
         "Negative dentry cache TTL in virtual µs",
         "no negative caching",
         "repro.core.meta_session", 4),
    Knob("CFS_SANITIZE", "0", "bool",
         "Enable the happens-before / staleness runtime sanitizer",
         "sanitizer off (zero overhead)",
         "repro.analysis.sanitizer", 6),
    Knob("CFS_META_ASYNC", "1", "bool",
         "Early-ack async metadata commits (leader journal, background raft)",
         "seed synchronous raft-round-per-mutation ack path",
         "repro.core.client", 7),
    Knob("CFS_META_JOURNAL_DEPTH", "64", "int",
         "Max unacked async metadata mutations in flight per partition",
         "synchronous commits (no unacked window)",
         "repro.core.client", 7),
    Knob("CFS_META_AUTOSPLIT", "1", "bool",
         "RM control loop auto-splits near-full max-id meta partitions",
         "static placement (splits only on explicit admin calls)",
         "repro.core.resource_manager", 8),
    Knob("CFS_META_SPLIT_FRACTION", "0.8", "float",
         "Entry fill fraction of max_entries that triggers a meta split",
         "split as soon as the partition reports any entries",
         "repro.core.resource_manager", 8),
    Knob("CFS_META_SPLIT_DELTA", "65536", "int",
         "Algorithm 1 Δ: inode headroom beyond maxInodeID at the range cut",
         "cut exactly at maxInodeID (no headroom)",
         "repro.core.resource_manager", 8),
    Knob("CFS_META_HB_US", "50000", "float",
         "Timed control-plane heartbeat/split-check period in virtual µs",
         "no periodic control loop (driver ticks only)",
         "repro.core.resource_manager", 8),
    Knob("CFS_CLIENT_CACHE", "1", "bool",
         "Two-tier client-side extent cache (RAM + simulated SSD) on reads",
         "seed per-packet network fetch path (no data caching)",
         "repro.cache.extent_cache", 9),
    Knob("CFS_CACHE_RAM_MB", "64", "int",
         "RAM tier byte budget of the client extent cache, in MB",
         "no RAM tier (inserts go straight to the SSD tier, if any)",
         "repro.cache.extent_cache", 9),
    Knob("CFS_CACHE_SSD_MB", "256", "int",
         "Simulated-SSD tier byte budget of the client extent cache, in MB",
         "no SSD tier (RAM evictions are dropped instead of demoted)",
         "repro.cache.extent_cache", 9),
    Knob("CFS_CACHE_WRITE_THROUGH", "0", "bool",
         "Insert committed append/small-write packets into the cache",
         "read-only fills (write path leaves the cache untouched)",
         "repro.cache.extent_cache", 9),
    Knob("CFS_QOS", "1", "bool",
         "Per-volume QoS: WFQ meta-NIC scheduling + data-node admission",
         "seed FIFO scheduling and no admission (byte-identical baselines)",
         "repro.core.simnet", 10),
    Knob("CFS_QOS_WEIGHTS", "", "str",
         "Per-volume WFQ weights, e.g. 'volA=4,volB=1' (unlisted weigh 1)",
         "empty: every volume weighs 1 (equal shares)",
         "repro.core.simnet", 10),
    Knob("CFS_QOS_ADMIT_US", "4000", "float",
         "Max per-tenant virtual queue (µs) a data node admits before Busy",
         "admission control off (data nodes never shed)",
         "repro.core.data_node", 10),
]

KNOBS: Dict[str, Knob] = {k.name: k for k in _DECLS}
assert len(KNOBS) == len(_DECLS), "duplicate knob declaration"


def _raw(name: str) -> str:
    knob = KNOBS.get(name)
    if knob is None:
        raise UnregisteredKnob(
            f"{name} is not declared in repro.analysis.knobs.KNOBS — "
            "register it (name, default, type, doc) before reading it")
    return os.environ.get(name, knob.default)


def get_int(name: str) -> int:
    return int(_raw(name))


def get_float(name: str) -> float:
    return float(_raw(name))


def get_str(name: str) -> str:
    return _raw(name)


def get_bool(name: str) -> bool:
    """Boolean knobs follow the repo convention: any value other than
    ``"0"`` is on (matches the historical ``!= "0"`` parses exactly)."""
    return _raw(name) != "0"


_GETTERS: Dict[str, Callable[[str], object]] = {
    "int": get_int, "float": get_float, "bool": get_bool, "str": get_str,
}
