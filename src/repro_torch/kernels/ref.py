"""Plain PyTorch versions of the port's kernels (the correctness yardstick).

Mirrors ``repro.kernels.ref``:
  * the flash-attention forward: the same blockwise online softmax, the
    same padding, the same sliding-window span and the same rounding points
    (logits in fp32 from exact products, the probabilities rounded to v's
    dtype before the PV product);
  * its recompute backward and the autograd function that joins the two
    (the reference's custom VJP), so ``flash_attention`` is differentiable;
  * the RWKV6 WKV recurrence and the Mamba2 SSD scan, each as its per-step
    oracle (``*_naive``) and its chunked form, with a state in and the final
    state out, and the chunked forms' backward (``*_bwd``: autograd through
    them, as the reference's gradients are JAX's autodiff of its own);
  * the positional-weighted checksum, in int64 with every product and sum
    reduced mod 2^32;
  * one-token decode attention over a K/V cache as the model's plain path
    computes it (the decode kernel's counterpart; the JAX package has no kernel
    for it), and one token of a Mamba2 layer with its conv and gated norm (the
    fused decode step's counterpart).
The CPU tests hold these to the JAX functions; ``chip_smoke.py`` holds the
CUDA kernels to them on the card.
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


def _k_start(q_start, j, tk, window, span, block_k):
    """The first key position of block j (with a window: of the q block's span)."""
    if window:
        return min(max(q_start - window + 1, 0), max(tk - span, 0))
    return j * block_k


def _kv_slice(kp, vp, q_start, j, tk, window, span, block_k):
    if window:
        k_start = _k_start(q_start, j, tk, window, span, block_k)
        k_j = kp[:, k_start:k_start + span]
        v_j = vp[:, k_start:k_start + span]
        k_pos = k_start + torch.arange(span, device=kp.device)
    else:
        k_j = kp[:, j * block_k:(j + 1) * block_k]
        v_j = vp[:, j * block_k:(j + 1) * block_k]
        k_pos = j * block_k + torch.arange(block_k, device=kp.device)
    return k_j, v_j, k_pos


def _flash_fwd_impl(q, k, v, q_offset, window, block_q, block_k, scale=None):
    """Returns ``out [B,Tq,KV,G,hd]`` (q's dtype) and ``lse [B,KV,G,Tq]`` (fp32);
    ``scale`` is the softmax scale (None: 1/sqrt(hd)).

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
    scale = 1.0 / (hd ** 0.5) if scale is None else scale
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


def _flash_bwd_impl(q, k, v, lse, do, q_offset, window, block_q, block_k, scale=None):
    """One pass over q blocks: emit dq per block, accumulate dk/dv.

    Mirrors ``repro.kernels.ref._flash_bwd_impl``: p is recomputed from
    (q, k, lse), and ``D = rowsum(do * o)`` from an ``o`` recomputed in fp32
    from the same p.  ``lse`` is [B,KV,G,Tq] as ``_flash_fwd_impl`` returns
    it.  Returns dq (q's dtype), dk, dv (k's and v's dtypes)."""
    b, tq, kvh, g, hd = q.shape
    tk = k.shape[1]
    block_q = min(block_q, tq)
    block_k = min(block_k, tk)
    pq = (-tq) % block_q
    pk = (-tk) % block_k
    qp = F.pad(q, (0, 0, 0, 0, 0, 0, 0, pq))
    kp = F.pad(k, (0, 0, 0, 0, 0, pk))
    vp = F.pad(v, (0, 0, 0, 0, 0, pk))
    dop = F.pad(do, (0, 0, 0, 0, 0, 0, 0, pq))
    lsep = F.pad(lse, (0, pq))
    nq = qp.shape[1] // block_q
    nk = kp.shape[1] // block_k
    scale = 1.0 / (hd ** 0.5) if scale is None else scale
    span = min(window + block_q, max(tk, 1)) if window else 0
    tkp = kp.shape[1]
    dev = q.device

    dk_acc = torch.zeros((b, tkp, kvh, hd), dtype=torch.float32, device=dev)
    dv_acc = torch.zeros((b, tkp, kvh, hd), dtype=torch.float32, device=dev)
    dqs = []
    for i in range(nq):
        q_i = qp[:, i * block_q:(i + 1) * block_q]
        do_i = dop[:, i * block_q:(i + 1) * block_q]
        lse_i = lsep[..., i * block_q:(i + 1) * block_q]
        q_start = q_offset + i * block_q
        q_pos = q_start + torch.arange(block_q, device=dev)
        tiles = []
        for j in range(1 if window else nk):
            k_j, v_j, k_pos = _kv_slice(kp, vp, q_start, j, tk, window, span,
                                        block_k)
            s = torch.einsum("bqkgh,bskh->bkgqs", q_i.float(), k_j.float()) * scale
            mask = _mask_for(q_pos, k_pos, tk, window)
            # where(), not the reference's exp(.) * mask: the same values, and
            # no inf * 0 where a masked logit lies far above the row's lse
            p = torch.where(mask[None, None, None], torch.exp(s - lse_i[..., None]), 0.0)
            tiles.append((k_j, v_j, _k_start(q_start, j, tk, window, span, block_k), p))
        # D_i = rowsum(do * o), with o recomputed from p
        o_i = sum(torch.einsum("bkgqs,bskh->bqkgh", p.to(v_j.dtype).float(), v_j.float())
                  for _, v_j, _, p in tiles)
        d_i = (do_i.float() * o_i).sum(-1).permute(0, 2, 3, 1)      # [b,kv,g,bq]
        dq_i = torch.zeros((b, block_q, kvh, g, hd), dtype=torch.float32, device=dev)
        for k_j, v_j, k0, p in tiles:
            dv_j = torch.einsum("bkgqs,bqkgh->bskh", p.to(do_i.dtype).float(),
                                do_i.float())
            dp = torch.einsum("bqkgh,bskh->bkgqs", do_i.float(), v_j.float())
            ds = p * (dp - d_i[..., None]) * scale
            dq_i = dq_i + torch.einsum("bkgqs,bskh->bqkgh",
                                       ds.to(k_j.dtype).float(), k_j.float())
            dk_j = torch.einsum("bkgqs,bqkgh->bskh", ds.to(q_i.dtype).float(),
                                q_i.float())
            dk_acc[:, k0:k0 + dk_j.shape[1]] += dk_j
            dv_acc[:, k0:k0 + dv_j.shape[1]] += dv_j
        dqs.append(dq_i.to(q.dtype))
    dq = torch.cat(dqs, dim=1)[:, :tq]
    return dq, dk_acc[:, :tk].to(k.dtype), dv_acc[:, :tk].to(v.dtype)


class _Flash(torch.autograd.Function):
    """The plain flash attention with its recompute backward: the counterpart
    of the reference's ``jax.custom_vjp`` on ``_flash``."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, window, block_q, block_k, scale=None):
        out, lse = _flash_fwd_impl(q, k, v, q_offset, window, block_q, block_k, scale)
        ctx.save_for_backward(q, k, v, lse)
        ctx.args = (q_offset, window, block_q, block_k, scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, lse = ctx.saved_tensors
        return (*_flash_bwd_impl(q, k, v, lse, do.contiguous(), *ctx.args),
                None, None, None, None, None)


def flash_attention(q, k, v, q_offset: int = 0, window: int = 0,
                    block_q: int = 512, block_k: int = 1024, scale=None):
    """Blockwise causal attention (optionally sliding-window), flash-style
    forward and recompute backward, softmax scale ``scale`` (None: 1/sqrt(hd)).

    q [B,Tq,KV,G,hd]; k/v [B,Tk,KV,hd] -> [B,Tq,KV,G,hd] in q's dtype."""
    return _Flash.apply(q, k, v, q_offset, window, block_q, block_k, scale)


def attention_naive(q, k, v, q_offset: int = 0, window: int = 0, scale=None):
    """O(T^2)-materialized oracle (small shapes only)."""
    b, tq, kvh, g, hd = q.shape
    tk = k.shape[1]
    s = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float())
    s = s / (hd ** 0.5) if scale is None else s * scale
    q_pos = q_offset + torch.arange(tq, device=q.device)
    k_pos = torch.arange(tk, device=q.device)
    mask = q_pos[:, None] >= k_pos[None, :]
    if window:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    s = s.masked_fill(~mask[None, None, None], NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bkgqs,bskh->bqkgh", w.to(v.dtype), v)


# ================================================================= RWKV6 (WKV)

def decode_attention(q, k, v, n_valid: int, scale=None):
    """One-token GQA decode attention as the model's plain path computes it
    (``models.layers.attention_decode`` with a bf16 or fp32 cache and no split):
    the products over every slot of the cache in the dtype q and the cache
    promote to, slots at or past ``n_valid`` masked out, the softmax in fp32 and
    the probabilities rounded to q's dtype before the product with v.  On fp32
    inputs it is the function the decode kernel computes, in fp32.  ``scale`` is the
    softmax scale (None: 1/sqrt(hd)).
    q [B,1,H,hd]; k/v [B,Smax,KV,hd] -> [B,1,H,hd]."""
    b, _, h, hd = q.shape
    n, kvh = k.shape[1], k.shape[2]
    dt = torch.promote_types(q.dtype, k.dtype)
    qg = q.reshape(b, 1, kvh, h // kvh, hd).to(dt)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.to(dt)).float()
    s = s / hd ** 0.5 if scale is None else s * scale
    s = s.masked_fill(torch.arange(n, device=q.device) >= n_valid, NEG_INF)
    pr = torch.softmax(s, dim=-1).to(q.dtype).to(dt)
    return torch.einsum("bkgqs,bskh->bqkgh", pr, v.to(dt)).reshape(b, 1, h, hd)


def rwkv6_naive(r, k, v, w, u, state):
    """Per-step WKV6 recurrence oracle.

    r,k,w: [B,T,H,K]; v: [B,T,H,V]; u: [H,K]; state: [B,H,K,V].
    y_t = r_t · (S_{t-1} + (u ⊙ k_t) v_t^T);  S_t = diag(w_t) S_{t-1} + k_t v_t^T
    Returns (y [B,T,H,V], final state)."""
    ys = []
    S = state
    for t in range(r.shape[1]):
        kv = torch.einsum("bhk,bhv->bhkv", k[:, t], v[:, t])
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t], S + u[None, :, :, None] * kv))
        S = w[:, t][..., None] * S + kv
    return torch.stack(ys, 1), S


def rwkv6_chunked(r, k, v, w, u, state, chunk: int = 64):
    """Chunked WKV6 (the formulation the WKV6 kernel computes).

    Within a chunk, pairwise decays exp(cl_prev_i - cl_j) of the log-decay
    cumsums; across chunks, the [B,H,K,V] state.  T is padded to a whole
    number of chunks with w = 1 (no decay), which keeps the state exact."""
    b, t, h, kdim = r.shape
    vdim = v.shape[-1]
    pad = (-t) % chunk
    if pad:
        r, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    nt = r.shape[1] // chunk

    def chunks(a, d):   # [B,T,H,d] -> [nt,B,H,c,d]
        return a.reshape(b, nt, chunk, h, d).permute(1, 0, 3, 2, 4)

    rc, kc, wc = (chunks(a, kdim) for a in (r, k, w))
    vc = chunks(v, vdim)
    mask = torch.arange(chunk, device=r.device)[:, None] > torch.arange(
        chunk, device=r.device)[None, :]
    uf = u.float()
    S = state.float()
    ys = []
    for i in range(nt):
        r_f, k_f, v_f = rc[i].float(), kc[i].float(), vc[i].float()
        logw = torch.log(torch.clamp(wc[i].float(), min=1e-30))
        cl = torch.cumsum(logw, dim=2)          # [B,H,c,K] inclusive
        cl_prev = cl - logw                     # exclusive
        y_state = torch.einsum("bhck,bhkv->bhcv", r_f * torch.exp(cl_prev), S)
        diff = cl_prev[:, :, :, None, :] - cl[:, :, None, :, :]   # [B,H,i,j,K]
        D = torch.exp(torch.clamp(diff, max=30.0)) * mask[None, None, :, :, None]
        att = torch.einsum("bhik,bhijk,bhjk->bhij", r_f, D, k_f)
        diag = torch.einsum("bhik,hk,bhik->bhi", r_f, uf, k_f)
        y = (y_state + torch.einsum("bhij,bhjv->bhiv", att, v_f)
             + diag[..., None] * v_f)
        cl_last = cl[:, :, -1, :]
        carry_w = torch.exp(torch.clamp(cl_last[:, :, None, :] - cl, max=30.0))
        S = (torch.exp(cl_last)[..., None] * S
             + torch.einsum("bhjk,bhjv->bhkv", carry_w * k_f, v_f))
        ys.append(y.to(r.dtype))
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(b, nt * chunk, h, vdim)
    return y[:, :t], S


def _vjp(fn, inputs, dy, ds_out):
    """Gradients of every input of ``fn(*inputs) -> (y, final state)`` for the
    cotangents ``dy`` and ``ds_out`` (``None``: the final state is not read)."""
    with torch.enable_grad():
        xs = [a.detach().requires_grad_() for a in inputs]
        y, s = fn(*xs)
        outs, cots = ([y, s], [dy, ds_out]) if ds_out is not None else ([y], [dy])
        return torch.autograd.grad(outs, xs, cots)


def rwkv6_chunked_bwd(r, k, v, w, u, state, dy, ds_out=None, chunk: int = 64):
    """The backward of ``rwkv6_chunked`` by autograd through it: the gradients
    of r, k, v, w, u and the initial state for the cotangents ``dy`` of y and
    ``ds_out`` of the final state.  Where w < 1e-30 (the forward's clamp), dw
    is 0."""
    return _vjp(lambda *a: rwkv6_chunked(*a, chunk=chunk), (r, k, v, w, u, state), dy, ds_out)


# ================================================================ Mamba2 (SSD)

def mamba2_naive(x, dt, A, B, C, state):
    """Per-step SSD oracle.  x: [Bt,T,H,P]; dt: [Bt,T,H]; A: [H] (negative);
    B,C: [Bt,T,N], or [Bt,T,G,N] in G groups, head h reading group h // (H/G);
    state: [Bt,H,P,N].
    h_t = exp(A dt_t) h_{t-1} + dt_t * x_t B_t^T ;  y_t = h_t C_t"""
    if B.dim() == 4:                # each head's group: [Bt,T,H,N]
        heads = torch.arange(x.shape[2], device=x.device) // (x.shape[2] // B.shape[2])
        B, C = B[:, :, heads], C[:, :, heads]
    upd_eq, out_eq = (("bhp,bn->bhpn", "bhpn,bn->bhp") if B.dim() == 3
                      else ("bhp,bhn->bhpn", "bhpn,bhn->bhp"))
    ys = []
    h = state
    for t in range(x.shape[1]):
        decay = torch.exp(A * dt[:, t])[..., None, None]          # [Bt,H,1,1]
        upd = torch.einsum(upd_eq, x[:, t] * dt[:, t][..., None], B[:, t])
        h = decay * h + upd
        ys.append(torch.einsum(out_eq, h, C[:, t]))
    return torch.stack(ys, 1), h


def mamba2_step(u, conv_state, conv_w, conv_b, dt_bias, A, D, state, norm_w, groups: int,
                eps: float):
    """One token of a Mamba2 layer from its in_proj's output to its out_proj's input
    (the decode kernel K6's plain version).  u [B, W] = z | x | B | C | dt (W = 2 din
    + 2 G N + H); conv_state [B, C, K-1] (C = din + 2 G N) and the fp32 state
    [B,H,P,N] are updated in place; conv_w [K, C], conv_b [C]; dt_bias, A (=
    -exp(A_log)), D [H]; norm_w [din].  xBC' = silu(conv(conv_state | xBC) + b),
    dt = softplus(dt + dt_bias), s = e^(A dt) s + dt x B^T (head h reading group
    h // (H/G)), y = s C + D x; returns norm_w * RMS over each of the G groups of
    y * silu(z), rounded to u's dtype before the weight: [B, din]."""
    b, h, p, n = state.shape
    din, gn, k = h * p, groups * n, h // groups
    z, xbc, dt = torch.split(u, [din, din + 2 * gn, h], dim=-1)
    pad = torch.cat([conv_state.to(xbc.dtype), xbc[:, :, None]], dim=2)      # [B, C, K]
    conv_state.copy_(pad[:, :, 1:])
    conv = F.conv1d(pad, conv_w.t().unsqueeze(1), conv_b, groups=pad.shape[1])[:, :, 0]
    xs, B, C = torch.split(F.silu(conv), [din, gn, gn], dim=-1)
    dt = F.softplus(dt.float() + dt_bias)                                    # [B, H]
    x = xs.float().reshape(b, groups, k, p)
    s = state.view(b, groups, k, p, n)
    s.mul_(torch.exp(A * dt).reshape(b, groups, k, 1, 1))
    s.addcmul_((x * dt.reshape(b, groups, k, 1))[..., None],
               B.float().reshape(b, groups, 1, 1, n))
    y = (s @ C.float().reshape(b, groups, 1, n, 1))[..., 0] + D.reshape(groups, k, 1) * x
    y = y.reshape(b, groups, din // groups) * F.silu(z.float()).reshape(b, groups, din // groups)
    y = F.rms_norm(y, (din // groups,), eps=eps).reshape(b, din)
    return y.to(u.dtype) * norm_w


def mamba2_ssd(x, dt, A, B, C, state, chunk: int = 128):
    """Chunked SSD (Mamba2's dual form; the formulation the SSD kernel
    computes).  T is padded with dt = 0 and x = 0, which keeps the state
    exact.  B, C [Bt,T,N], or [Bt,T,G,N] in G groups (``_ssd_grouped``)."""
    if B.dim() == 4:
        return _ssd_grouped(x, dt, A, B, C, state, chunk)
    bt, t, h, p = x.shape
    n = B.shape[-1]
    pad = (-t) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    nt = x.shape[1] // chunk
    xc = x.reshape(bt, nt, chunk, h, p).permute(1, 0, 3, 2, 4)   # [nt,b,h,c,p]
    dtc = dt.reshape(bt, nt, chunk, h).permute(1, 0, 3, 2)       # [nt,b,h,c]
    Bc = B.reshape(bt, nt, chunk, n).transpose(0, 1)             # [nt,b,c,n]
    Cc = C.reshape(bt, nt, chunk, n).transpose(0, 1)
    mask = torch.arange(chunk, device=x.device)[:, None] >= torch.arange(
        chunk, device=x.device)[None, :]
    Af = A.float()
    S = state.float()
    ys = []
    for i in range(nt):
        x_f, dt_f = xc[i].float(), dtc[i].float()
        B_f, C_f = Bc[i].float(), Cc[i].float()
        cl = torch.cumsum(Af[None, :, None] * dt_f, dim=-1)       # [b,h,c]
        y_state = torch.einsum("bhpn,bcn,bhc->bhcp", S, C_f, torch.exp(cl))
        diff = cl[:, :, :, None] - cl[:, :, None, :]
        L = torch.exp(torch.clamp(diff, max=30.0)) * mask[None, None]
        G = torch.einsum("bin,bjn->bij", C_f, B_f)
        M = G[:, None] * L                                         # [b,h,i,j]
        y = y_state + torch.einsum("bhij,bhj,bhjp->bhip", M, dt_f, x_f)
        cl_last = cl[:, :, -1]
        decay_tail = torch.exp(torch.clamp(cl_last[:, :, None] - cl, max=30.0))
        S = (torch.exp(cl_last)[..., None, None] * S
             + torch.einsum("bhc,bhcp,bcn->bhpn", decay_tail * dt_f, x_f, B_f))
        ys.append(y)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(bt, nt * chunk, h, p)
    return y[:, :t].to(x.dtype), S


def _ssd_grouped(x, dt, A, B, C, state, chunk: int):
    """``mamba2_ssd`` with B, C [Bt,T,G,N]: the heads as G groups of K = H/G, head
    (g, k) = g K + k reading group g; the same chunks, products and rounding points."""
    bt, t, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    k = h // g
    pad = (-t) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    nt = x.shape[1] // chunk
    xc = x.reshape(bt, nt, chunk, g, k, p).permute(1, 0, 3, 4, 2, 5)   # [nt,b,g,k,c,p]
    dtc = dt.reshape(bt, nt, chunk, g, k).permute(1, 0, 3, 4, 2)      # [nt,b,g,k,c]
    Bc = B.reshape(bt, nt, chunk, g, n).permute(1, 0, 3, 2, 4)         # [nt,b,g,c,n]
    Cc = C.reshape(bt, nt, chunk, g, n).permute(1, 0, 3, 2, 4)
    mask = torch.arange(chunk, device=x.device)[:, None] >= torch.arange(
        chunk, device=x.device)[None, :]
    Af = A.float().reshape(g, k)
    S = state.float().reshape(bt, g, k, p, n)
    ys = []
    for i in range(nt):
        x_f, dt_f = xc[i].float(), dtc[i].float()
        B_f, C_f = Bc[i].float(), Cc[i].float()
        cl = torch.cumsum(Af[None, :, :, None] * dt_f, dim=-1)    # [b,g,k,c]
        y_state = torch.einsum("bgkpn,bgcn,bgkc->bgkcp", S, C_f, torch.exp(cl))
        diff = cl[..., :, None] - cl[..., None, :]
        L = torch.exp(torch.clamp(diff, max=30.0)) * mask
        G = torch.einsum("bgin,bgjn->bgij", C_f, B_f)
        M = G[:, :, None] * L                                      # [b,g,k,i,j]
        y = y_state + torch.einsum("bgkij,bgkj,bgkjp->bgkip", M, dt_f, x_f)
        cl_last = cl[..., -1]
        decay_tail = torch.exp(torch.clamp(cl_last[..., None] - cl, max=30.0))
        S = (torch.exp(cl_last)[..., None, None] * S
             + torch.einsum("bgkc,bgkcp,bgcn->bgkpn", decay_tail * dt_f, x_f, B_f))
        ys.append(y)
    y = torch.stack(ys).permute(1, 0, 4, 2, 3, 5).reshape(bt, nt * chunk, h, p)
    return y[:, :t].to(x.dtype), S.reshape(bt, h, p, n)


def mamba2_ssd_bwd(x, dt, A, B, C, state, dy, ds_out=None, chunk: int = 128):
    """The backward of ``mamba2_ssd`` by autograd through it: the gradients of
    x, dt, A, B, C and the initial state for the cotangents ``dy`` of y and
    ``ds_out`` of the final state."""
    return _vjp(lambda *a: mamba2_ssd(*a, chunk=chunk), (x, dt, A, B, C, state), dy, ds_out)


# ================================================================ checksum

_MASK32 = 0xFFFFFFFF


def _mulmod32(a, b):
    """(a * b) mod 2^32 for int64 tensors holding values in [0, 2^32).

    The plain product reaches 2^64 and overflows int64, so b is split into
    16-bit halves: a*lo < 2^48 and (a*hi mod 2^16) * 2^16 < 2^32."""
    lo, hi = b & 0xFFFF, b >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _MASK32


def checksum(data, block: int = 4096):
    """Positional-weighted modular checksum of a buffer of 32-bit words.

    Mirrors ``repro.kernels.ref.checksum``: per block of ``block`` words,
    sum_i (i+1)*x_i and sum_i x_i mod 2^32, combined as
    sum_b weighted_b + offset_b * plain_b; any ``block`` gives the same
    digest.  ``data`` is a 1-D int32 or uint32 tensor, read as unsigned
    words.  Returns int64 [2] = (weighted, plain), each in [0, 2^32): the
    bits of the reference's uint32 [2]."""
    if data.dtype not in (torch.int32, torch.uint32) or data.dim() != 1:
        raise ValueError(f"checksum takes a 1-D int32 or uint32 tensor of words; got "
                         f"{data.dtype} of shape {tuple(data.shape)}")
    x = data.to(torch.int64) & _MASK32
    n = x.shape[0]
    x = F.pad(x, (0, (-n) % block))
    blocks = x.reshape(-1, block)
    idx = torch.arange(1, block + 1, dtype=torch.int64, device=x.device)
    plain = blocks.sum(1) & _MASK32
    weighted = _mulmod32(blocks, idx[None, :]).sum(1) & _MASK32
    offsets = (torch.arange(blocks.shape[0], dtype=torch.int64, device=x.device)
               * block) & _MASK32
    w_total = (weighted + _mulmod32(offsets, plain)).sum() & _MASK32
    p_total = plain.sum() & _MASK32
    return torch.stack([w_total, p_total])
