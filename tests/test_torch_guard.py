"""Guards on the PyTorch port: what it imports, and where its kernel runs."""

import ast
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.checksum import checksum as checksum_kernel
from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_fwd
from repro_torch.kernels.mamba2_ssd import ssd_fwd
from repro_torch.kernels.rwkv6_scan import wkv6_fwd

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


def test_flash_backward_on_cpu_takes_the_plain_version(monkeypatch):
    monkeypatch.setattr(flash_attention_fwd, "launches", 0)
    monkeypatch.setattr(flash_attention_bwd, "launches", 0)
    q, k, v = (x.requires_grad_() for x in _qkv())
    dq, dk, dv = torch.autograd.grad(ops.flash_attention(q, k, v).sum(), (q, k, v))
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape
    assert flash_attention_fwd.launches == 0 and flash_attention_bwd.launches == 0


def test_backward_and_checksum_wrappers_refuse_cpu_tensors(monkeypatch):
    q, k, v = _qkv()
    out = torch.zeros_like(q)
    lse = torch.zeros((1, 2, 1, 64))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd(q, k, v, out, lse, out)
    monkeypatch.setattr(checksum_kernel, "launches", 0)
    with pytest.raises(ValueError, match="CUDA"):
        checksum_kernel(torch.arange(16, dtype=torch.int32))
    digest = ops.tensor_checksum(torch.arange(16, dtype=torch.int32))
    assert digest.tolist() == [sum((i + 1) * i for i in range(16)), sum(range(16))]
    assert checksum_kernel.launches == 0


def _wkv6_inputs():
    g = torch.Generator().manual_seed(1)
    r, k, v = (torch.randn((1, 70, 2, 64), generator=g) for _ in range(3))
    w = torch.rand((1, 70, 2, 64), generator=g)
    return r, k, v, w, torch.randn((2, 64), generator=g), torch.zeros((1, 2, 64, 64))


def _ssd_inputs():
    g = torch.Generator().manual_seed(2)
    x = torch.randn((1, 130, 2, 64), generator=g)
    dt = torch.rand((1, 130, 2), generator=g)
    B, C = (torch.randn((1, 130, 64), generator=g) for _ in range(2))
    return x, dt, -torch.rand(2, generator=g), B, C, torch.zeros((1, 2, 64, 64))


def test_scan_ops_on_cpu_take_the_plain_versions(monkeypatch):
    monkeypatch.setattr(wkv6_fwd, "launches", 0)
    monkeypatch.setattr(ssd_fwd, "launches", 0)
    y, s = ops.wkv6(*_wkv6_inputs())
    assert y.shape == (1, 70, 2, 64) and s.shape == (1, 2, 64, 64)
    y, s = ops.mamba2_ssd(*_ssd_inputs())
    assert y.shape == (1, 130, 2, 64) and s.shape == (1, 2, 64, 64)
    assert wkv6_fwd.launches == 0 and ssd_fwd.launches == 0


def test_scan_kernel_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        wkv6_fwd(*_wkv6_inputs())
    with pytest.raises(ValueError, match="CUDA"):
        ssd_fwd(*_ssd_inputs())
