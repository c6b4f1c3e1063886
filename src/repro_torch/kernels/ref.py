"""Plain PyTorch versions of the port's kernels (the correctness yardstick).

Mirrors ``repro.kernels.ref`` for the flash-attention forward: the same
blockwise online softmax, the same padding, the same sliding-window span
and the same rounding points (logits in fp32 from exact products, the
probabilities rounded to v's dtype before the PV product).  The CPU tests
hold these to the JAX functions; ``chip_smoke.py`` holds the CUDA kernel
to them on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _mask_for(q_pos, k_pos, tk, window):
    mask = q_pos[:, None] >= k_pos[None, :]
    mask = mask & (k_pos < tk)[None, :]
    if window:
        mask = mask & ((q_pos[:, None] - k_pos[None, :]) < window)
    return mask


def _kv_slice(kp, vp, q_start, j, tk, window, span, block_k):
    if window:
        k_start = min(max(q_start - window + 1, 0), max(tk - span, 0))
        k_j = kp[:, k_start:k_start + span]
        v_j = vp[:, k_start:k_start + span]
        k_pos = k_start + torch.arange(span, device=kp.device)
    else:
        k_j = kp[:, j * block_k:(j + 1) * block_k]
        v_j = vp[:, j * block_k:(j + 1) * block_k]
        k_pos = j * block_k + torch.arange(block_k, device=kp.device)
    return k_j, v_j, k_pos


def _flash_fwd_impl(q, k, v, q_offset, window, block_q, block_k):
    """Returns ``out [B,Tq,KV,G,hd]`` (q's dtype) and ``lse [B,KV,G,Tq]`` (fp32).

    ``repro.kernels.ref._flash_fwd_impl`` returns lse padded to a whole
    number of q blocks; here it is cut to Tq, the shape the CUDA kernel
    writes."""
    b, tq, kvh, g, hd = q.shape
    tk = k.shape[1]
    block_q = min(block_q, tq)
    block_k = min(block_k, tk)
    pq = (-tq) % block_q
    pk = (-tk) % block_k
    qp = F.pad(q, (0, 0, 0, 0, 0, 0, 0, pq))
    kp = F.pad(k, (0, 0, 0, 0, 0, pk))
    vp = F.pad(v, (0, 0, 0, 0, 0, pk))
    nq = qp.shape[1] // block_q
    nk = kp.shape[1] // block_k
    scale = 1.0 / (hd ** 0.5)
    span = min(window + block_q, max(tk, 1)) if window else 0
    dev = q.device

    outs, lses = [], []
    for i in range(nq):
        q_i = qp[:, i * block_q:(i + 1) * block_q].float()
        q_start = q_offset + i * block_q
        q_pos = q_start + torch.arange(block_q, device=dev)
        m = torch.full((b, kvh, g, block_q), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, kvh, g, block_q), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, kvh, g, block_q, hd), dtype=torch.float32,
                          device=dev)
        for j in range(1 if window else nk):
            k_j, v_j, k_pos = _kv_slice(kp, vp, q_start, j, tk, window, span,
                                        block_k)
            s = torch.einsum("bqkgh,bskh->bkgqs", q_i, k_j.float()) * scale
            mask = _mask_for(q_pos, k_pos, tk, window)
            s = s.masked_fill(~mask[None, None, None], NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            correction = torch.exp(m - m_new)
            l = l * correction + p.sum(-1)
            acc = acc * correction[..., None] + torch.einsum(
                "bkgqs,bskh->bkgqh", p.to(v_j.dtype).float(), v_j.float())
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4).to(q.dtype))
        lses.append(m + torch.log(torch.clamp(l, min=1e-30)))
    out = torch.cat(outs, dim=1)[:, :tq]
    lse = torch.cat(lses, dim=-1)[..., :tq]
    return out, lse


def flash_attention(q, k, v, q_offset: int = 0, window: int = 0,
                    block_q: int = 512, block_k: int = 1024):
    """Blockwise causal attention forward (optionally sliding-window).

    q [B,Tq,KV,G,hd]; k/v [B,Tk,KV,hd] -> [B,Tq,KV,G,hd] in q's dtype."""
    out, _ = _flash_fwd_impl(q, k, v, q_offset, window, block_q, block_k)
    return out


def attention_naive(q, k, v, q_offset: int = 0, window: int = 0):
    """O(T^2)-materialized oracle (small shapes only)."""
    b, tq, kvh, g, hd = q.shape
    tk = k.shape[1]
    s = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float()) / (hd ** 0.5)
    q_pos = q_offset + torch.arange(tq, device=q.device)
    k_pos = torch.arange(tk, device=q.device)
    mask = q_pos[:, None] >= k_pos[None, :]
    if window:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    s = s.masked_fill(~mask[None, None, None], NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bkgqs,bskh->bqkgh", w.to(v.dtype), v)
