"""Plain PyTorch WKV recurrence, in the model's (B, T, H, N) layout of
``repro.models.recurrent.wkv_scan``."""
from __future__ import annotations

from typing import Optional

import torch

from ...device import traced

#: the steps a plain loop runs on fake tensors (a dry run's trace of the CPU
#: program): from its second step on, each step allocates and frees the
#: same storages as the one before, so two hold the whole loop's peak; no
#: step does a product a FLOP counter counts or launches a kernel
TRACED_STEPS = 2


def _steps(x: torch.Tensor, T: int) -> int:
    """The steps of a loop over `T` that `x`'s program runs: all of them, or
    ``TRACED_STEPS`` on a fake tensor."""
    return min(T, TRACED_STEPS) if traced(x) else T


def _working_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def wkv_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
            u: torch.Tensor, state0: Optional[torch.Tensor] = None,
            lengths: Optional[torch.Tensor] = None):
    """r, k, v, w: (B, T, H, N); u: (H, N) per-head bonus; state0:
    (B, H, N, N) or None (zeros); lengths: (B,) int32 or None (T steps
    everywhere). A sequential loop over T in fp32 (float64 for float64
    inputs, which the gradient tests take), the step of
    ``recurrent._wkv_step``:

        out_t = r_t @ (S + u^T (k_t^T v_t)),   S <- S * w_t^T + k_t^T v_t

    Steps at or past ``lengths[b]`` leave S as it is and output zeros. The
    contraction over the key channel is an elementwise product and a sum, so
    no matrix product (and no TF32) is involved. Returns out (B, T, H, N)
    and the final state (B, H, N, N), both fp32. On fake tensors the loop
    runs ``TRACED_STEPS`` steps (``_steps``)."""
    B, T, H, N = r.shape
    dt = _working_dtype(r)
    r, k, v, w, u = (a.to(dt) for a in (r, k, v, w, u))
    if state0 is None:
        S = torch.zeros((B, H, N, N), dtype=dt, device=r.device)
    else:
        S = state0.to(dt).clone()
    out = torch.zeros((B, T, H, N), dtype=dt, device=r.device)
    live = None
    if lengths is not None:
        live = torch.arange(T, device=r.device)[None, :] < lengths.to(r.device)[:, None]
    for t in range(_steps(r, T)):
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


def wkv_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                u: torch.Tensor, state0: Optional[torch.Tensor], dout: torch.Tensor,
                dstate: Optional[torch.Tensor] = None):
    """Gradients (dr, dk, dv, dw, du, dstate0) of ``wkv_ref`` over whole
    sequences (a train step passes no lengths), given dout (B, T, H, N), the
    gradient of its output, and dstate (B, H, N, N), that of its final
    state (None: zeros). The explicit sequential formula in fp32 (float64
    for float64 inputs), with S_{t-1} the state before step t and D_t the
    gradient of the state after it, from D_T = dstate:

        D_{t-1} = diag(w_t) D_t + r_t do_t^T
        dr_t = S_{t-1} do_t + u * k_t (v_t . do_t)
        dk_t = D_t v_t + u * r_t (v_t . do_t)
        dv_t = D_t^T k_t + (r_t . (u * k_t)) do_t
        dw_t = rowsum(D_t * S_{t-1}),  du = sum over b, t of r * k (v . do)

    dstate0 = D_0, or None where state0 is None. dw is 0 where log w <=
    LOG_W_MIN, as in ``csrc/wkv_bwd.cu``: the chunked forward clamps log w
    there, so its output does not depend on w. Keeps every step's state:
    B H N^2 T values. Nothing on the main path calls it when a card is
    present. On fake tensors each loop runs ``TRACED_STEPS`` steps
    (``_steps``), the states it would keep allocated whole."""
    B, T, H, N = r.shape
    dt = _working_dtype(r)
    r, k, v, w, u, dout = (a.to(dt) for a in (r, k, v, w, u, dout))
    S = torch.zeros((B, H, N, N), dtype=dt, device=r.device) if state0 is None \
        else state0.to(dt).clone()
    states = []
    n = _steps(r, T)
    for t in range(n):
        states.append(S)
        S = S * w[:, t, :, :, None] + k[:, t, :, :, None] * v[:, t, :, None, :]
    if n < T:       # a trace: the states of the steps it skips and the last, one storage
        rest = torch.empty((T - n, *S.shape), dtype=dt, device=r.device)
        states += [S] + [rest[0]] * (T - n - 1)
        S = rest[-1]
    D = torch.zeros_like(S) if dstate is None else dstate.to(dt).clone()
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    vdo = (v * dout).sum(-1, keepdim=True)                      # (B, T, H, 1)
    for t in reversed(range(T - n, T)):
        rt, kt, vt, wt, dot = (a[:, t] for a in (r, k, v, w, dout))
        dr[:, t] = (states[t] * dot[..., None, :]).sum(-1) + u * kt * vdo[:, t]
        dk[:, t] = (D * vt[..., None, :]).sum(-1) + u * rt * vdo[:, t]
        dv[:, t] = (D * kt[..., :, None]).sum(-2) + (rt * u * kt).sum(-1, keepdim=True) * dot
        dw[:, t] = (D * states[t]).sum(-1)
        D = D * wt[..., :, None] + rt[..., :, None] * dot[..., None, :]
    du = (r * k * vdo).sum((0, 1))
    dw = torch.where(w.log() <= LOG_W_MIN, 0.0, dw)
    return dr, dk, dv, dw, du, None if state0 is None else D


def wkv_bwd_chunked_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                        u: torch.Tensor, state0: Optional[torch.Tensor], dout: torch.Tensor,
                        dstate: Optional[torch.Tensor] = None, *, chunk: int = CHUNK,
                        segment: int = 64):
    """The arithmetic of ``csrc/wkv_bwd.cu`` in plain PyTorch, for the
    tests: the function of ``wkv_bwd_ref`` in the chunked form. Nothing on
    the main path calls it.

    The segments' starting states (what the chunked forward writes into
    ``s_seg``) are taken first; then segment by segment from the last, each
    chunk's starting state is rebuilt from its segment's, and the chunks
    run from the last with D, the gradient of the state at the chunk's end.
    In a chunk of L steps, with lw = max(log2 w, LOG_W_MIN log2 e) (0 past
    T), pre_t and post_t the sums of lw over its steps before and after t,
    E[t, s] = 2^(sum of lw over s < m < t) (a direct sum, m from t - 1
    down), S the chunk's starting state, D the gradient of its final one,
    sd_t = S do_t, dvv_t = D v_t and M = dO V^T:

        drS_t = 2^pre_t sd_t + sum_{s<t} E[t, s] k_s M[t, s]
        dkD_t = 2^post_t dvv_t + sum_{s>t} E[s, t] r_s M[s, t]
        dr = drS + u k M[t, t],  dk = dkD + u r M[t, t]
        dv_t = D^T (k_t 2^post_t) + sum_{s>=t} A[s, t] do_s,
        A[t, s] = sum_i r_t k_s E[t, s] (s < t),  A[t, t] = r_t . (u * k_t)
        D <- 2^(sum lw) *rows D + (r 2^pre)^T dO

    and dw_t = rowsum(D_t * S_{t-1}) expanded over the chunk, a sum of
    products of decays at most 1 (no difference of large sums, so small
    decays keep their relative precision):

        dw_t = 2^(pre_t + post_t) rowsum(D * S)
               + 2^post_t sum_{s<t} E[t, s] k_s dvv_s
               + 2^pre_t sum_{s>t} E[s, t] r_s sd_s
               + sum_{s>t} E[s, t] r_s sum_{q<t} E[t, q] k_q M[s, q]

    0 where log w is clamped."""
    B, T, H, N = r.shape
    f32 = torch.float32
    r, k, v, w, dout = (a.to(f32).transpose(1, 2) for a in (r, k, v, w, dout))
    u = u.to(f32)
    L = chunk
    Tp = -(-T // L) * L

    def padded(a, fill):
        return torch.cat([a, a.new_full((B, H, Tp - T, N), fill)], 2)   # (B, H, Tp, N)

    r, k, v, dout = (padded(a, 0.0) for a in (r, k, v, dout))
    w = padded(w, 1.0)
    lw = w.log2().clamp_min(LOG_W_MIN * LOG2E)
    clamped = w.log2() < LOG_W_MIN * LOG2E
    n_chunks = Tp // L
    per_seg = segment // L

    def sums(c):
        x = lw[:, :, c * L:(c + 1) * L]
        zero = torch.zeros_like(x[:, :, :1])
        pre = torch.cat([zero, x.cumsum(2)[:, :, :-1]], 2)
        post = torch.cat([x.flip(2).cumsum(2).flip(2)[:, :, 1:], zero], 2)
        return x, pre, post, x.sum(2)

    def step(S, c):
        _, _, post, tot = sums(c)
        kd = k[:, :, c * L:(c + 1) * L] * post.exp2()
        return tot.exp2()[..., None] * S + kd.transpose(-1, -2) @ v[:, :, c * L:(c + 1) * L]

    S = torch.zeros((B, H, N, N), dtype=f32, device=r.device) if state0 is None \
        else state0.to(f32).clone()
    seg_states = []
    for c in range(n_chunks):
        if c % per_seg == 0:
            seg_states.append(S)
        S = step(S, c)
    D = torch.zeros_like(S) if dstate is None else dstate.to(f32).clone()
    dr, dk, dv, dw = (torch.zeros_like(r) for _ in range(4))
    du = torch.zeros((B, H, N), dtype=f32, device=r.device)
    for g in reversed(range(len(seg_states))):
        chunks = range(g * per_seg, min((g + 1) * per_seg, n_chunks))
        starts = [seg_states[g]]
        for c in chunks[:-1]:
            starts.append(step(starts[-1], c))
        for ci in reversed(range(len(chunks))):
            c = chunks[ci]
            sl = slice(c * L, (c + 1) * L)
            rc, kc, vc, dc = r[:, :, sl], k[:, :, sl], v[:, :, sl], dout[:, :, sl]
            x, pre, post, tot = sums(c)
            Sc = starts[ci]
            M = dc @ vc.transpose(-1, -2)                       # M[t, s] = do_t . v_s
            E = torch.zeros((B, H, L, L, N), dtype=f32, device=r.device)
            for t in range(L):
                gap = torch.zeros_like(x[:, :, 0])
                for s in range(t - 1, -1, -1):
                    E[:, :, t, s] = gap.exp2()
                    gap = gap + x[:, :, s]
            A = (rc[:, :, :, None, :] * kc[:, :, None, :, :] * E).sum(-1)
            A = A + torch.diag_embed((rc * u[None, :, None, :] * kc).sum(-1))
            sd, dvv = dc @ Sc.transpose(-1, -2), vc @ D.transpose(-1, -2)   # (B, H, L, N)
            ek = E * kc[:, :, None, :, :]                       # E[t, q] k_q
            er = E * rc[:, :, :, None, :]                       # E[s, t] r_s at [s, t]
            drs = pre.exp2() * sd + (ek * M[..., None]).sum(3)
            dkd = post.exp2() * dvv + (er * M[..., None]).sum(2)
            inner = torch.einsum("bhtqi,bhsq->bhtsi", ek, M)    # sum_q E[t, q] k_q M[s, q]
            dwc = (pre + post).exp2() * (D * Sc).sum(-1)[:, :, None, :] \
                + post.exp2() * (ek * dvv[:, :, None, :, :]).sum(3) \
                + pre.exp2() * (er * sd[:, :, :, None, :]).sum(2) \
                + (er.transpose(2, 3) * inner).sum(3)
            mtt = M.diagonal(dim1=-2, dim2=-1)[..., None]      # (B, H, L, 1)
            dr[:, :, sl] = drs + u[None, :, None, :] * kc * mtt
            dk[:, :, sl] = dkd + u[None, :, None, :] * rc * mtt
            dv[:, :, sl] = (kc * post.exp2()) @ D + A.transpose(-1, -2) @ dc
            dw[:, :, sl] = torch.where(clamped[:, :, sl], 0.0, dwc)
            du += (rc * kc * mtt).sum(2)
            D = tot.exp2()[..., None] * D + (rc * pre.exp2()).transpose(-1, -2) @ dc
    back = [a[:, :, :T].transpose(1, 2).contiguous() for a in (dr, dk, dv, dw)]
    return (*back, du.sum(0), None if state0 is None else D)
