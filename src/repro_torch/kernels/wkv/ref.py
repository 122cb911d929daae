"""Plain PyTorch WKV recurrence, in the model's (B, T, H, N) layout of
``repro.models.recurrent.wkv_scan``."""
from __future__ import annotations

from typing import Optional

import torch


def wkv_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
            u: torch.Tensor, state0: Optional[torch.Tensor] = None,
            lengths: Optional[torch.Tensor] = None):
    """r, k, v, w: (B, T, H, N); u: (H, N) per-head bonus; state0:
    (B, H, N, N) or None (zeros); lengths: (B,) int32 or None (T steps
    everywhere). A sequential loop over T in fp32, the step of
    ``recurrent._wkv_step``:

        out_t = r_t @ (S + u^T (k_t^T v_t)),   S <- S * w_t^T + k_t^T v_t

    Steps at or past ``lengths[b]`` leave S as it is and output zeros. The
    contraction over the key channel is an elementwise product and a sum, so
    no matrix product (and no TF32) is involved. Returns out (B, T, H, N)
    and the final state (B, H, N, N), both fp32."""
    B, T, H, N = r.shape
    r, k, v, w, u = (a.float() for a in (r, k, v, w, u))
    if state0 is None:
        S = torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
    else:
        S = state0.float().clone()
    out = torch.zeros((B, T, H, N), dtype=torch.float32, device=r.device)
    live = None
    if lengths is not None:
        live = torch.arange(T, device=r.device)[None, :] < lengths.to(r.device)[:, None]
    for t in range(T):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]            # (B, H, N, N)
        o = (r[:, t, :, :, None] * (S + u[:, :, None] * kv)).sum(-2)
        nxt = S * w[:, t, :, :, None] + kv
        if live is None:
            out[:, t], S = o, nxt
        else:
            m = live[:, t].view(B, 1, 1)
            out[:, t] = torch.where(m, o, 0.0)
            S = torch.where(m[..., None], nxt, S)
    return out, S


#: the chunked kernel's constants (``csrc/wkv_chunked.cu``): steps a chunk,
#: the floor of log w, and the largest total decay -a_L of a chunk at which
#: its scores are taken in the factored form; the kernel works in log2 units
CHUNK = 16
LOG_W_MIN = -60.0
FACTOR_LIMIT = 60.0
LOG2E = 1.4426950408889634


def wkv_chunked_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                    u: torch.Tensor, state0: Optional[torch.Tensor] = None,
                    lengths: Optional[torch.Tensor] = None, *, chunk: int = CHUNK):
    """The arithmetic of ``csrc/wkv_chunked.cu`` in plain PyTorch, for the
    tests: the same function as ``wkv_ref`` in the chunked-parallel form.
    Nothing on the main path calls it.

    Steps at or past ``lengths[b]`` and the ragged last chunk's are identity
    steps (r, k, v zero, w one). Per chunk of L steps, with a_t[i] the sum
    of max(log w, LOG_W_MIN) over the chunk's steps up to t (a_{-1} = 0),
    taken as the kernel takes it, in log2 units with exp2:

        out_t = (r_t * exp(a_{t-1})) @ S + sum_{s<t} A[t, s] v_s + (r_t . (u * k_t)) v_t
        A[t, s] = sum_i r_t[i] k_s[i] exp(a_{t-1}[i] - a_s[i])
        S <- exp(a_L) *rows S + (k * exp(a_L - a))^T @ V

    A is taken as (r * exp(a_{t-1})) @ (k * exp(-a))^T where the (b, h)'s
    chunk total -a_L stays at or below FACTOR_LIMIT in every channel, else
    elementwise. Every exponent is a direct sum of log decays, never the
    difference of two large sums: a_{t-1} and a_L - a_s as prefix and
    suffix sums, and in the elementwise form a_{t-1} - a_s as the sum over
    s < m < t, taken from m = t - 1 down. fp32 products on the CPU, no
    TF32."""
    B, T, H, N = r.shape
    f32 = torch.float32
    r, k, v, w, u = (a.to(f32) for a in (r, k, v, w, u))
    S = torch.zeros((B, H, N, N), dtype=f32, device=r.device) if state0 is None \
        else state0.to(f32).clone()
    L = chunk
    Tp = -(-T // L) * L
    n = torch.full((B,), T) if lengths is None else lengths.clamp(0, T)
    live = (torch.arange(Tp)[None, :] < n.cpu()[:, None]).to(r.device)[:, :, None, None]

    def padded(a, fill):
        a = torch.cat([a, a.new_full((B, Tp - T, H, N), fill)], 1)
        return torch.where(live, a, fill).transpose(1, 2)      # (B, H, Tp, N)

    r, k, v = padded(r, 0.0), padded(k, 0.0), padded(v, 0.0)
    lw = padded(w, 1.0).log2().clamp_min(LOG_W_MIN * LOG2E)
    causal = torch.ones(L, L, dtype=torch.bool, device=r.device).tril(-1)
    outs = []
    for c0 in range(0, Tp, L):
        rc, kc, vc, lc = (x[:, :, c0:c0 + L] for x in (r, k, v, lw))
        a = lc.cumsum(2)                                        # a_t, (B, H, L, N)
        zero = torch.zeros_like(a[:, :, :1])
        a_prev = torch.cat([zero, a[:, :, :-1]], 2)             # a_{t-1}
        a_last = a[:, :, -1:]                                   # a_L, (B, H, 1, N)
        after = torch.cat([lc.flip(2).cumsum(2).flip(2)[:, :, 1:], zero], 2)   # a_L - a_t
        rq = rc * a_prev.exp2()
        factored = (-a_last <= FACTOR_LIMIT * LOG2E).all(-1, keepdim=True)   # (B, H, 1, 1)
        kq = torch.where(factored, kc * (-a).exp2(), 0.0)
        # a_{t-1} - a_s as the sum of lw over s < m < t, taken from m = t - 1 down
        gap = torch.full((B, H, L, L, N), -torch.inf, device=r.device)
        for t in range(L):
            acc = torch.zeros_like(lc[:, :, 0])
            for s_ in range(t - 1, -1, -1):
                gap[:, :, t, s_] = acc
                acc = acc + lc[:, :, s_]
        exact = (rc[:, :, :, None, :] * kc[:, :, None, :, :] * gap.exp2()).sum(-1)
        A = torch.where(factored, (rq @ kq.transpose(-1, -2)) * causal, exact)
        A = A + torch.diag_embed((rc * u[None, :, None, :] * kc).sum(-1))
        outs.append(rq @ S + A @ vc)
        kd = torch.where(factored, kq * a_last.exp2(), kc * after.exp2())
        S = a_last.exp2().transpose(-1, -2) * S + kd.transpose(-1, -2) @ vc
    out = torch.cat(outs, 2).transpose(1, 2)[:, :T]
    return torch.where(live[:, :T], out, 0.0).contiguous(), S
