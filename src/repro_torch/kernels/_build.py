"""Build the port's CUDA sources with ``nvcc`` at first use and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled for
Hopper (``sm_90a``) into ``build/lib<name>-<hash>.so`` at the repository
root, then loaded with ``ctypes``.  The hash covers the source, every shared
header ``csrc/*.cuh`` and the flags, so an edited source or header is rebuilt
and an unchanged one is reused.  ``define_op`` binds a kernel's wrapper to
PyTorch as an operator.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIB = torch.library.Library("repro_torch", "FRAGMENT")     # the kernels' operators
_loaded: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}   # nvcc's output (ptxas register/spill report) per source,
                                  # kept beside the library as lib<name>-<hash>.log


def refuse_dtensor(name: str, *tensors) -> None:
    """A kernel launches on plain tensors: a rank's own shard (a DTensor's
    ``to_local()``), never a DTensor, which would hand it a whole tensor
    gathered behind its back or a shard taken for the whole."""
    from torch.distributed.tensor import DTensor
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(f"{name} takes plain tensors, not DTensors: launch it on each "
                        "rank's shard (DTensor.to_local())")


def define_op(schema: str, impl: Callable, fake: Callable) -> None:
    """Define ``torch.ops.repro_torch.<name>`` by ``schema``: its real
    implementation, for CUDA and CPU tensors alike, is ``impl`` (a kernel's
    wrapper, which refuses a CPU tensor), and ``fake`` gives the outputs'
    shapes, dtypes and strides, so that fake tensors pass through it and
    nothing launches.  A plain ``torch.library.Library`` registration: the
    dispatcher calls ``impl`` directly, where ``torch.library.custom_op``
    adds Python layers of its own (autograd, alias checks) to every call."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    for key in ("CUDA", "CPU"):
        _LIB.impl(name, impl, key)
    torch.library.register_fake(f"repro_torch::{name}", fake, lib=_LIB)


def _tool(name: str) -> str:
    for cand in (shutil.which(name), f"/usr/local/cuda/bin/{name}"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError(f"{name} not found (looked on PATH and in /usr/local/cuda/bin); "
                       "building the CUDA kernels needs the CUDA toolkit")


def source_digest(name: str, csrc: Path = CSRC) -> str:
    """Hash of ``<csrc>/<name>.cu``, every ``<csrc>/*.cuh`` (any of which it may
    include) and the flags: the key of the built library."""
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists; returns its path."""
    src = CSRC / f"{name}.cu"
    out = BUILD_DIR / f"lib{name}-{source_digest(name)[:16]}.so"
    log = out.with_suffix(".log")
    if out.exists():
        if name not in build_logs and log.exists():
            build_logs[name] = log.read_text()
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_tool("nvcc"), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    build_logs[name] = proc.stdout + proc.stderr
    log.write_text(build_logs[name])
    os.replace(tmp, out)
    return out


def build_all(names: Sequence[str]) -> Dict[str, Path]:
    """Compile several sources at once, one ``nvcc`` process each."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(build, names)))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build(name)))
    return _loaded[name]


def sass_counts(name: str, opcodes: Sequence[str] = ("HGMMA", "HMMA")) -> Dict[str, Dict[str, int]]:
    """Per kernel of the built ``csrc/<name>.cu``, how many SASS instructions of
    each opcode ``cuobjdump -sass`` finds: the proof of which units a kernel uses."""
    proc = subprocess.run([_tool("cuobjdump"), "-sass", str(build(name))], capture_output=True,
                          text=True, check=True)
    counts: Dict[str, Dict[str, int]] = {}
    current = None
    for line in proc.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            current = counts.setdefault(m.group(1), dict.fromkeys(opcodes, 0))
        elif current is not None:
            for op in opcodes:
                if re.search(rf"\b{op}\.", line):
                    current[op] += 1
    return counts


def ptxas_usage(name: str) -> Dict[str, Dict[str, int]]:
    """Per kernel of ``csrc/<name>.cu``, the registers and spill bytes that
    ``ptxas -v`` reported when the library was built."""
    build(name)
    usage: Dict[str, Dict[str, int]] = {}
    current = None
    for line in build_logs.get(name, "").splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            current = usage.setdefault(m.group(1), {})
        elif current is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                current.update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                current["registers"] = int(m.group(1))
    return usage
