"""Guards on the PyTorch port: what it imports, and where its kernel runs."""

import ast
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_fwd

ROOT = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "repro", "ml_dtypes")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imported_modules(f)
           if m.split(".")[0] in BANNED]
    assert not bad, bad


def _qkv(device="cpu"):
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 64, 2, 1, 32), generator=g)
    k = torch.randn((1, 64, 2, 32), generator=g)
    v = torch.randn((1, 64, 2, 32), generator=g)
    return q.to(device), k.to(device), v.to(device)


def test_ops_on_cpu_takes_the_plain_version(monkeypatch):
    monkeypatch.setattr(flash_attention_fwd, "launches", 0)
    out = ops.flash_attention(*_qkv())
    assert out.shape == (1, 64, 2, 1, 32)
    assert flash_attention_fwd.launches == 0


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd(*_qkv())
