"""RWKV6 (Finch) time mix and channel mix and the Griffin RG-LRU block of the
port, the counterparts of ``repro.models.recurrent``.

The parameters keep the JAX tree's keys and dtypes: the shift mixes ``mu``
and the r/k/v/g/o and channel-mix weights bf16; the base decay ``w0``, the
decay LoRA, the bonus ``u`` and the group-norm gain ``ln_x`` fp32. The
arithmetic follows the JAX model's types step by step: the shift mixes and
the GEMMs in bf16, the decay LoRA and ``w = exp(-exp(w0 + dd))`` in fp32,
r/k/v cast to fp32 for the recurrence, the group-norm output cast to bf16
before the gate, and the channel mix's ``relu(.)^2`` in bf16.

The recurrence itself goes through the wkv op (``kernels/wkv``), which
launches the Hopper kernel for CUDA tensors and runs the plain version for
CPU tensors; it takes per-sequence lengths, so that a right-padded prompt's
state is that of its real tokens only.

The RG-LRU block keeps the JAX tree's keys and dtypes too: ``w_gate``,
``w_in``, ``conv_w``, ``conv_b`` and ``w_out`` bf16, the gate weights
``w_a``, ``w_x`` and ``lam`` fp32. Its GELU branch goes through the gelu op,
the width-4 depthwise causal convolution stays plain torch ops (bf16
products and sums, as the JAX model's), the gate GEMMs ``u @ w_a`` and
``u @ w_x`` stay fp32 ``torch.matmul``, and the gates and the scan go through
the rglru op (``kernels/rglru``), which takes per-sequence lengths. The conv
carry after a right-padded prompt is its last W - 1 real inputs, and h its
state after its last real token: the JAX model's result for that prompt
alone (``ROADMAP.md``, C4).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.gelu.ops import gelu
from ..kernels.rglru.ops import rglru
from ..kernels.wkv.ops import wkv
from .layers import Params, _init, _param

RWKV_LORA = 64
GROUP_NORM_EPS = 64e-5


def rwkv_tmix_init(cfg: ModelConfig, gen: Optional[torch.Generator],
                   device=None) -> Params:
    d = cfg.d_model
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    return Params({
        "mu": _param(torch.full((5, d), 0.5, dtype=torch.bfloat16, device=device)),
        "wr": _init(gen, (d, d), device=device),
        "wk": _init(gen, (d, d), device=device),
        "wv": _init(gen, (d, d), device=device),
        "wg": _init(gen, (d, d), device=device),
        "wo": _init(gen, (d, d), scale=out_scale, device=device),
        "w0": _param(torch.full((d,), -6.0, dtype=torch.float32, device=device)),
        "w_lora_a": _init(gen, (d, RWKV_LORA), device=device, dtype=torch.float32),
        "w_lora_b": _init(gen, (RWKV_LORA, d), device=device, dtype=torch.float32),
        "u": _init(gen, (d,), scale=0.3, device=device, dtype=torch.float32),
        "ln_x": _param(torch.ones(d, dtype=torch.float32, device=device)),
    })


def token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """shift(x)_t = x_{t-1}; prev (B, d) is the token before x's first."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def rwkv_inputs(p: Params, x: torch.Tensor, prev: torch.Tensor):
    """r, k, v (bf16), the gate g (bf16) and the decay w in (0, 1) (fp32),
    each (B, T, d)."""
    xs = token_shift(x, prev)
    xr, xk, xv, xg, xw = (x + (xs - x) * p["mu"][i] for i in range(5))
    r = xr @ p["wr"]
    k = xk @ p["wk"]
    v = xv @ p["wv"]
    g = F.silu(xg @ p["wg"])
    # data-dependent decay: a LoRA on the shifted input, in fp32
    dd = torch.tanh(xw.float() @ p["w_lora_a"]) @ p["w_lora_b"]
    w = torch.exp(-torch.exp(p["w0"] + dd))
    return r, k, v, g, w


def rwkv_tmix_apply(cfg: ModelConfig, p: Params, x: torch.Tensor,
                    prev: torch.Tensor, state0: Optional[torch.Tensor] = None,
                    lengths: Optional[torch.Tensor] = None,
                    state_out: Optional[torch.Tensor] = None):
    """x: (B, T, d) normed input; prev: (B, d) token before x's first;
    state0: (B, H, N, N) fp32 or None (zeros); lengths: (B,) int32 or None.
    Returns (y (B, T, d), final state), the state written into `state_out`
    when given (which may be `state0`: updated in place)."""
    B, T, d = x.shape
    N = cfg.rwkv_head_dim
    H = d // N
    r, k, v, g, w = rwkv_inputs(p, x, prev)

    def heads(a):
        return a.float().reshape(B, T, H, N)

    out, state = wkv(heads(r), heads(k), heads(v), heads(w), p["u"].reshape(H, N),
                     state0, lengths, state_out=state_out)
    # per-head group norm (population variance), then the gate
    mu = out.mean(-1, keepdim=True)
    var = out.var(-1, correction=0, keepdim=True)
    out = ((out - mu) * torch.rsqrt(var + GROUP_NORM_EPS)).reshape(B, T, d) * p["ln_x"]
    return (out.to(x.dtype) * g) @ p["wo"], state


def rwkv_cmix_init(cfg: ModelConfig, gen: Optional[torch.Generator],
                   device=None) -> Params:
    """Channel mix of width int(3.5 d), as the JAX model (not ``cfg.d_ff``)."""
    d = cfg.d_model
    ff = int(3.5 * d)
    return Params({
        "mu": _param(torch.full((2, d), 0.5, dtype=torch.bfloat16, device=device)),
        "w_up": _init(gen, (d, ff), device=device),
        "w_down": _init(gen, (ff, d), scale=0.02 / math.sqrt(2 * cfg.n_layers),
                        device=device),
    })


def rwkv_cmix_apply(p: Params, x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """x: (B, T, d) normed input; prev: (B, d). ``relu(xk @ w_up)^2 @ w_down``
    with the shift mix ``mu[0]`` (the JAX tree keeps a second, unused row)."""
    xs = token_shift(x, prev)
    xk = x + (xs - x) * p["mu"][0]
    return torch.relu(xk @ p["w_up"]).square() @ p["w_down"]


# ---------------------------------------------------------------------------
# Griffin RG-LRU block
# ---------------------------------------------------------------------------

def rglru_init(cfg: ModelConfig, gen: Optional[torch.Generator], device=None) -> Params:
    d = cfg.d_model
    return Params({
        "w_gate": _init(gen, (d, d), device=device),          # gelu branch
        "w_in": _init(gen, (d, d), device=device),            # recurrent branch
        "conv_w": _init(gen, (cfg.rglru_conv_width, d), scale=0.1, device=device),
        "conv_b": _param(torch.zeros(d, dtype=torch.bfloat16, device=device)),
        "w_a": _init(gen, (d, d), device=device, dtype=torch.float32),  # recurrence gate
        "w_x": _init(gen, (d, d), device=device, dtype=torch.float32),  # input gate
        "lam": _param(torch.full((d,), 3.0, dtype=torch.float32, device=device)),
        "w_out": _init(gen, (d, d), scale=0.02 / math.sqrt(2 * cfg.n_layers), device=device),
    })


def causal_conv1d(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  carry: Optional[torch.Tensor] = None,
                  lengths: Optional[torch.Tensor] = None):
    """Depthwise causal convolution: u (B, T, d), w (W, d), b (d,), carry
    (B, W-1, d) the inputs before u's first (zeros if None). Returns (out
    (B, T, d), the next carry: the last W-1 inputs, or with `lengths` those
    before each sequence's length)."""
    W = w.shape[0]
    B, T, d = u.shape
    if carry is None:
        carry = u.new_zeros((B, W - 1, d))
    up = torch.cat([carry, u], dim=1)
    out = sum(up[:, i:i + T] * w[i] for i in range(W)) + b
    if lengths is None:
        return out, up[:, T:]
    idx = lengths.to(u.device).long()[:, None] + torch.arange(W - 1, device=u.device)
    return out, up[torch.arange(B, device=u.device)[:, None], idx]


def rglru_apply(cfg: ModelConfig, p: Params, x: torch.Tensor,
                h0: Optional[torch.Tensor] = None, conv_carry: Optional[torch.Tensor] = None,
                lengths: Optional[torch.Tensor] = None, h_out: Optional[torch.Tensor] = None):
    """x: (B, T, d) normed input; h0: (B, d) fp32 or None; conv_carry:
    (B, W-1, d) bf16 or None; lengths: (B,) int32 or None. Returns (y
    (B, T, d), (h after each sequence's last real token, next conv carry));
    h is written into `h_out` when given (which may be `h0`: updated in
    place). With T = 1, h0 and the carry this is ``rglru_decode_step``."""
    gate = gelu(x @ p["w_gate"])
    u = x @ p["w_in"]
    u, carry = causal_conv1d(u, p["conv_w"], p["conv_b"], conv_carry, lengths)
    uf = u.float()
    gh, h = rglru(u, uf @ p["w_a"], uf @ p["w_x"], p["lam"], gate, h0, lengths,
                  h_out=h_out)
    y = gh @ p["w_out"].float()
    return y.to(x.dtype), (h, carry)


def rglru_decode_step(cfg: ModelConfig, p: Params, x: torch.Tensor, h: torch.Tensor,
                      conv_carry: torch.Tensor):
    """x: (B, 1, d). One step from h (updated in place) and the conv carry.
    Returns (y, (h, next conv carry))."""
    return rglru_apply(cfg, p, x, h, conv_carry, h_out=h)


__all__ = ["RWKV_LORA", "GROUP_NORM_EPS", "rwkv_tmix_init", "rwkv_tmix_apply",
           "rwkv_cmix_init", "rwkv_cmix_apply", "rwkv_inputs", "token_shift",
           "rglru_init", "causal_conv1d", "rglru_apply", "rglru_decode_step"]
