"""Decoder LM of the port, the dense, MoE, RWKV6 and Griffin paths of
``repro.models.lm``.

``LM`` is an ``nn.Module`` holding a ``ModuleList`` of blocks, one per layer
in layer order; the JAX package's stacked-unit scan becomes a Python loop
over the blocks (``layer_kinds`` and ``unit_structure`` give the JAX
grouping, which ``params_from_jax`` unstacks).

Public entry points, counterparts of the JAX functions of the same names:
    init_params -> LM, LM.forward (teacher-forced logits), init_cache,
    LM.prefill, LM.decode_step, padded_vocab

The cache is a dict of tensors updated IN PLACE by ``prefill`` and
``decode_step`` (the JAX functions return a new cache). Every tensor but
``pos`` has a layer of one kind on axis 0 (the attention layers in order,
or the RG-LRU layers in order) and the sequence (slot) on axis 1. The
attention layers' ``k`` and ``v`` are fused (n_attn, B, T, Hkv*dh) bf16,
with T = min(max_len, attn_window) for a windowed model: a ring, position p
in slot p % T. Griffin's RG-LRU layers keep ``h`` (n_rglru, B, d) fp32 and
the conv carry ``conv`` (n_rglru, B, W-1, d) bf16. An RWKV6 model's
``state`` is (n_layers, B, H, N, N) fp32 and its token shifts ``sx_t`` /
``sx_c`` (n_layers, B, d) bf16. ``pos`` (B,) int32 holds each sequence's
next position (continuous batching).

Ported: dense decoders with full causal or local (windowed) attention, an
attention logit softcap or none, RMSNorm or LayerNorm, a SwiGLU, gated-GELU
or plain tanh-GELU MLP, and full, partial (stablelm) or no RoPE; with no
RoPE (gpt3) sinusoidal positions are added to the embeddings, as the JAX
model adds them. MoE decoders (``family == "moe"``, granite-moe-3b-a800m,
grok-1-314b): each layer's MLP is ``n_experts`` such MLPs behind a top-k
router with a capacity (``layers.moe_apply``). The attention-free RWKV6
(``family == "ssm"``, rwkv6-7b), no positions. And Griffin (``family ==
"hybrid"``, recurrentgemma-2b): a ``block_pattern`` of RG-LRU and
local-attention layers. Any other config raises NotImplementedError naming
the field.

Right pads and the recurrent state: an RWKV6 ``prefill`` hands each
sequence's prompt length to the wkv op, so the state after prefill is the
state after the real tokens only, and the token shifts are taken at each
sequence's last real token. That is the JAX model's result for each prompt
prefilled alone; the JAX ``prefill`` of a right-padded wave runs the pads
through the state instead (``ROADMAP.md``, C4), which the port does not
reproduce. Griffin's RG-LRU layers do the same with h and the conv carry;
and where a prompt is longer than the window, the ring keeps each prompt's
own last T keys, where the JAX prefill keeps the padded wave's last T
positions, which for a shorter prompt are partly pads (C4 too).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..kernels.decode_attention.ops import decode_attention
from . import layers as L
from . import recurrent as R

VOCAB_PAD = 256      # embeddings padded as in the JAX package

# (field, test that the port runs the config's value of it) for every
# config field of the ported slices
_SUPPORTED = (
    ("family", lambda c: c.family in ("dense", "moe", "ssm", "hybrid")),
    ("block_pattern", lambda c: set(c.block_pattern) <= {"rglru", "attn"}),
    ("cross_attention", lambda c: not c.cross_attention),
    ("n_encoder_layers", lambda c: c.n_encoder_layers == 0),
    ("cross_attn_layers", lambda c: not c.cross_attn_layers),
    ("n_frontend_tokens", lambda c: c.n_frontend_tokens == 0),
    ("norm", lambda c: c.norm in ("rmsnorm", "layernorm")),
    # a gated MLP runs the SwiGLU or the gated-GELU kernel, a plain one the
    # GELU kernel; RWKV6's channel mix is relu^2 whatever the field says
    ("activation", lambda c: c.attention_free
     or c.activation in (("silu", "gelu") if c.mlp_gated else ("gelu",))),
)


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError naming the first config field the port
    does not run yet."""
    for field, ok in _SUPPORTED:
        if not ok(cfg):
            raise NotImplementedError(
                f"{cfg.name}: {field}={getattr(cfg, field)!r} is not ported "
                f"to repro_torch yet (dense and MoE decoders with full or local "
                f"attention and a SwiGLU, gated-GELU or plain GELU MLP, "
                f"RWKV6, and Griffin)")


def layer_kinds(cfg: ModelConfig) -> list:
    """The kind of each layer: "attn", "rglru" or "rwkv" (the JAX
    ``layer_kinds`` of the ported families)."""
    return [cfg.block_kind(i) for i in range(cfg.n_layers)]


def unit_structure(cfg: ModelConfig):
    """(unit kinds, n_units, remainder kinds): the smallest period of the
    layer kinds, as the JAX model stacks its parameters."""
    kinds = layer_kinds(cfg)
    n = len(kinds)
    for p in range(1, n + 1):
        reps = n // p
        if all(kinds[i] == kinds[i % p] for i in range(reps * p)):
            return tuple(kinds[:p]), reps, tuple(kinds[reps * p:])
    return tuple(kinds), 1, ()


def kind_index(cfg: ModelConfig) -> list:
    """Each layer's index among the layers of its kind: its row of the
    cache tensors of that kind."""
    kinds = layer_kinds(cfg)
    return [kinds[:i].count(k) for i, k in enumerate(kinds)]


def padded_vocab(cfg: ModelConfig) -> int:
    return -(-cfg.vocab_size // VOCAB_PAD) * VOCAB_PAD


def _mask_pad_logits(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """Padded vocab entries must never win: -1e30 them."""
    if logits.shape[-1] == cfg.vocab_size:
        return logits
    idx = torch.arange(logits.shape[-1], device=logits.device)
    return logits.masked_fill(idx >= cfg.vocab_size, -1e30)


class Block(nn.Module):
    """One pre-norm decoder layer: attention then the MLP, or the MoE layer
    (``moe``, under the JAX key) where the config has experts."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator], device):
        super().__init__()
        self.ln1 = L.norm_init(cfg, device)
        self.attn = L.attn_init(cfg, gen, device)
        self.ln2 = L.norm_init(cfg, device)
        if cfg.n_experts:
            self.moe = L.moe_init(cfg, gen, device)
        else:
            self.mlp = L.mlp_init(cfg, gen, device)

    def mlp_residual(self, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
        """x plus the MLP or MoE layer of its norm (the JAX
        ``_mlp_or_moe``); the MoE aux loss is dropped."""
        h = L.apply_norm(cfg, self.ln2, x)
        if cfg.n_experts:
            return x + L.moe_apply(cfg, self.moe, h)[0]
        return x + L.mlp_apply(cfg, self.mlp, h)


class RGLRUBlock(nn.Module):
    """One Griffin recurrent layer: RMSNorm, RG-LRU block, RMSNorm, MLP."""

    mlp_residual = Block.mlp_residual

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator], device):
        super().__init__()
        self.ln1 = L.norm_init(cfg, device)
        self.rec = R.rglru_init(cfg, gen, device)
        self.ln2 = L.norm_init(cfg, device)
        self.mlp = L.mlp_init(cfg, gen, device)

    def mix(self, cfg: ModelConfig, x: torch.Tensor, h0: Optional[torch.Tensor] = None,
            conv: Optional[torch.Tensor] = None, lengths: Optional[torch.Tensor] = None,
            h_out: Optional[torch.Tensor] = None):
        """x: (B, T, d). Returns (x after the layer, (h, next conv carry)),
        the state as in ``rglru_apply``."""
        y, state = R.rglru_apply(cfg, self.rec, L.apply_norm(cfg, self.ln1, x), h0, conv,
                                 lengths, h_out)
        return self.mlp_residual(cfg, x + y), state


class RWKVBlock(nn.Module):
    """One RWKV6 layer: LayerNorm, time mix, LayerNorm, channel mix."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator], device):
        super().__init__()
        self.ln1 = L.norm_init(cfg, device)
        self.tmix = R.rwkv_tmix_init(cfg, gen, device)
        self.ln2 = L.norm_init(cfg, device)
        self.cmix = R.rwkv_cmix_init(cfg, gen, device)

    def mix(self, cfg: ModelConfig, x: torch.Tensor, prev_t: torch.Tensor,
            prev_c: torch.Tensor, state0: Optional[torch.Tensor] = None,
            lengths: Optional[torch.Tensor] = None,
            state_out: Optional[torch.Tensor] = None):
        """x: (B, T, d); prev_t / prev_c: (B, d) token shifts of the time and
        channel mix. Returns (x after the layer, the time mix's normed input,
        the channel mix's normed input); the caller keeps rows of the last
        two as the next token shifts. The state goes as in
        ``rwkv_tmix_apply``."""
        h = L.apply_norm(cfg, self.ln1, x)
        y, _ = R.rwkv_tmix_apply(cfg, self.tmix, h, prev_t, state0, lengths,
                                 state_out)
        x = x + y
        hc = L.apply_norm(cfg, self.ln2, x)
        return x + R.rwkv_cmix_apply(self.cmix, hc, prev_c), h, hc


_BLOCKS = {"attn": Block, "rglru": RGLRUBlock, "rwkv": RWKVBlock}


class LM(nn.Module):
    """The model on `device` (``cuda`` unless the caller names another).
    With a generator its weights are drawn as ``init_params`` draws them;
    without one they are left uninitialised, to be filled by
    ``load_state_dict``."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        check_supported(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        vpad = padded_vocab(cfg)
        self.embed = L._init(gen, (vpad, cfg.d_model), device=device)
        self.final_norm = L.norm_init(cfg, device)
        if not cfg.tie_embeddings:
            self.head = L._init(gen, (cfg.d_model, vpad), device=device)
        self.kinds = layer_kinds(cfg)
        self.rows = kind_index(cfg)
        self.blocks = nn.ModuleList(_BLOCKS[kind](cfg, gen, device) for kind in self.kinds)

    def _embed(self, tokens: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """Token embeddings, plus the sinusoidal table at `positions` (its
        fp32 rows rounded to bf16, then added) for an attention config
        without RoPE."""
        x = self.embed[tokens]
        if self.cfg.rope_fraction == 0.0 and not self.cfg.attention_free:
            x = x + L.sinusoidal_positions(positions, self.cfg.d_model).to(x.dtype)
        return x

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = L.apply_norm(self.cfg, self.final_norm, x)
        head = self.embed.T if self.cfg.tie_embeddings else self.head
        return _mask_pad_logits(self.cfg, x @ head)

    def _attention(self, blk: Block, x: torch.Tensor, rope):
        """(x after the layer's attention residual, its k, v) over the whole
        sequence: causal, under the config's window."""
        cfg = self.cfg
        q, k, v = L.attn_qkv(cfg, blk.attn, L.apply_norm(cfg, blk.ln1, x), rope)
        o = L.flash_attention(q, k, v, causal=True, window=cfg.attn_window,
                              logit_softcap=cfg.attn_logit_softcap)
        return x + L.attn_out(blk.attn, o), k, v

    # ------------------------------------------------------------------
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens: (B, S) -> logits (B, S, V_padded). (The JAX forward also
        returns the MoE layers' summed aux loss, which only its loss reads;
        the port's layers compute it and drop it.)"""
        cfg = self.cfg
        B, S = tokens.shape
        positions = torch.arange(S, device=tokens.device)
        x = self._embed(tokens, positions)
        if cfg.attention_free:
            zeros = x.new_zeros((B, cfg.d_model))
            for blk in self.blocks:
                x = blk.mix(cfg, x, zeros, zeros)[0]
            return self._logits(x)
        rope = L.rope_tables(cfg, positions.expand(B, S))
        for kind, blk in zip(self.kinds, self.blocks):
            if kind == "rglru":
                x = blk.mix(cfg, x)[0]
            else:
                x = blk.mlp_residual(cfg, self._attention(blk, x, rope)[0])
        return self._logits(x)

    # ------------------------------------------------------------------
    def prefill(self, tokens: torch.Tensor, cache: dict,
                prompt_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Process right-padded prompts from position 0, writing their K/V
        (and RG-LRU state and conv carry, or RWKV6 state and token shifts)
        into ``cache`` in place. prompt_lens: (B,) true prompt lengths
        (defaults to S). Returns the logits at each sequence's last real
        token, (B, V_padded)."""
        cfg = self.cfg
        B, S = tokens.shape
        if prompt_lens is None:
            prompt_lens = torch.full((B,), S, dtype=torch.int32, device=tokens.device)
        if cfg.attention_free:
            return self._prefill_rwkv(tokens, cache, prompt_lens)
        T = cache["k"].shape[2] if "k" in cache else S
        if S > T and not cfg.attn_window:
            raise ValueError(f"prompt of {S} tokens exceeds the cache's {T}")
        positions = torch.arange(S, device=tokens.device)
        x = self._embed(tokens, positions)
        rope = L.rope_tables(cfg, positions.expand(B, S))
        bidx = torch.arange(B, device=x.device)
        if S > T:
            # a ring shorter than the prompts: each prompt's own last T
            # positions (from 0 for one no longer than T), position p in
            # slot p % T
            src = (prompt_lens.long() - T).clamp(min=0)[:, None] + torch.arange(T, device=x.device)
            dst = (bidx[:, None], src % T)
        for i, (kind, blk) in enumerate(zip(self.kinds, self.blocks)):
            j = self.rows[i]
            if kind == "rglru":
                x, (_, conv) = blk.mix(cfg, x, lengths=prompt_lens, h_out=cache["h"][j])
                cache["conv"][j] = conv
                continue
            x, k, v = self._attention(blk, x, rope)
            # pads sit after the valid tokens; decode overwrites them in turn
            for name, t in (("k", k), ("v", v)):
                t = t.reshape(B, S, -1)
                if S > T:
                    cache[name][j][dst] = t[bidx[:, None], src]
                else:
                    cache[name][j, :, :S] = t
            x = blk.mlp_residual(cfg, x)
        cache["pos"].copy_(prompt_lens)
        last = (prompt_lens.long() - 1).clamp(0, S - 1)
        return self._logits(x[bidx, last])

    def _prefill_rwkv(self, tokens: torch.Tensor, cache: dict,
                      prompt_lens: torch.Tensor) -> torch.Tensor:
        """RWKV6 prefill from position 0: a zero state and zero token shifts
        whatever the cache held. The wkv op stops each sequence's recurrence
        at its prompt length and writes the state into the cache; the token
        shifts are the normed inputs at each sequence's last real token."""
        cfg = self.cfg
        B, S = tokens.shape
        x = self.embed[tokens]
        zeros = x.new_zeros((B, cfg.d_model))
        bidx = torch.arange(B, device=x.device)
        last = (prompt_lens.long() - 1).clamp(0, S - 1)
        for i, blk in enumerate(self.blocks):
            x, h, hc = blk.mix(cfg, x, zeros, zeros, lengths=prompt_lens,
                               state_out=cache["state"][i])
            cache["sx_t"][i] = h[bidx, last]
            cache["sx_c"][i] = hc[bidx, last]
        cache["pos"].copy_(prompt_lens)
        return self._logits(x[bidx, last])

    # ------------------------------------------------------------------
    def decode_step(self, token: torch.Tensor, cache: dict) -> torch.Tensor:
        """token: (B,) -> logits (B, V_padded). Writes each sequence's K/V at
        its position cache["pos"] (its ring slot pos % T for a windowed
        model), advances its RG-LRU state and conv carry (or its RWKV6 state
        and token shifts), in place, and advances the position."""
        cfg = self.cfg
        B = token.shape[0]
        if cfg.attention_free:
            return self._decode_rwkv(token, cache)
        pos = cache["pos"]
        x = self._embed(token, pos)[:, None, :]
        rope = L.rope_tables(cfg, pos.view(B, 1))
        bidx = torch.arange(B, device=x.device)
        if "k" in cache:
            hkv, dh = cfg.n_kv_heads, cfg.d_head
            T = cache["k"].shape[2]
            if cfg.attn_window:
                in_range, wpos = None, (pos % T).long()
            else:
                # a write past the cache's end is dropped, as JAX's scatter drops it
                in_range, wpos = (pos < T)[:, None], pos.clamp(max=T - 1).long()
            valid = (pos + 1).clamp(max=T).to(torch.int32)
        for i, (kind, blk) in enumerate(zip(self.kinds, self.blocks)):
            j = self.rows[i]
            if kind == "rglru":
                x, (_, conv) = blk.mix(cfg, x, cache["h"][j], cache["conv"][j],
                                       h_out=cache["h"][j])
                cache["conv"][j] = conv
                continue
            h = L.apply_norm(cfg, blk.ln1, x)
            q, k, v = L.attn_qkv(cfg, blk.attn, h, rope)
            ck, cv = cache["k"][j], cache["v"][j]
            for c, t in ((ck, k), (cv, v)):
                t = t.reshape(B, -1)
                c[bidx, wpos] = t if in_range is None else torch.where(in_range, t, c[bidx, wpos])
            o = _decode_attend(cfg, q, ck.view(B, T, hkv, dh),
                               cv.view(B, T, hkv, dh), valid)
            x = x + L.attn_out(blk.attn, o)
            x = blk.mlp_residual(cfg, x)
        pos += 1
        return self._logits(x)[:, 0]

    def _decode_rwkv(self, token: torch.Tensor, cache: dict) -> torch.Tensor:
        """One RWKV6 step: the wkv op updates each layer's state in place."""
        x = self.embed[token][:, None, :]
        for i, blk in enumerate(self.blocks):
            state = cache["state"][i]
            x, h, hc = blk.mix(self.cfg, x, cache["sx_t"][i], cache["sx_c"][i],
                               state0=state, state_out=state)
            cache["sx_t"][i] = h[:, 0]
            cache["sx_c"][i] = hc[:, 0]
        cache["pos"] += 1
        return self._logits(x)[:, 0]


def _decode_attend(cfg: ModelConfig, q: torch.Tensor, ck: torch.Tensor,
                   cv: torch.Tensor, valid_len: torch.Tensor) -> torch.Tensor:
    """Single-token attention over the cache through the decode kernel op,
    GQA-grouped (KV read once per kv-head), under the config's logit
    softcap.

    q: (B, 1, Hq, dh); ck/cv: (B, T, Hkv, dh); valid_len: (B,) int32."""
    B, _, Hq, dh = q.shape
    Hkv = cfg.n_kv_heads
    o = decode_attention(q.reshape(B, Hkv, Hq // Hkv, dh), ck, cv, valid_len,
                         softcap=cfg.attn_logit_softcap)
    return o.reshape(B, 1, Hq, dh)


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> LM:
    """Random weights from a ``torch.Generator`` seeded with ``seed`` on the
    target device (the same shapes and scales as the JAX init, not the same
    numbers). On the meta device only the shapes are made."""
    dev = resolve_device(device)
    gen = None if dev.type == "meta" else torch.Generator(dev).manual_seed(seed)
    return LM(cfg, gen, dev)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> dict:
    """Fused bf16 K/V of (n_attn, batch, T, Hkv*dh) for the attention layers
    (T = max_len, or min(max_len, attn_window) for a windowed model: the
    ring), the fp32 RG-LRU state (n_rglru, batch, d) and bf16 conv carry
    (n_rglru, batch, W-1, d) of Griffin's recurrent layers, or for RWKV6 the
    fp32 state (n_layers, batch, H, N, N) and the bf16 token shifts
    (n_layers, batch, d) (no length limit); and the per-sequence
    positions."""
    check_supported(cfg)
    dev = resolve_device(device)
    pos = torch.zeros((batch,), dtype=torch.int32, device=dev)
    if cfg.attention_free:
        N = cfg.rwkv_head_dim
        shift = (cfg.n_layers, batch, cfg.d_model)
        return {"state": torch.zeros((cfg.n_layers, batch, cfg.d_model // N, N, N),
                                     dtype=torch.float32, device=dev),
                "sx_t": torch.zeros(shift, dtype=torch.bfloat16, device=dev),
                "sx_c": torch.zeros(shift, dtype=torch.bfloat16, device=dev),
                "pos": pos}
    kinds = layer_kinds(cfg)
    cache = {}
    if "attn" in kinds:
        T = min(max_len, cfg.attn_window) if cfg.attn_window else max_len
        shape = (kinds.count("attn"), batch, T, cfg.n_kv_heads * cfg.d_head)
        cache["k"] = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
        cache["v"] = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
    if "rglru" in kinds:
        n, d = kinds.count("rglru"), cfg.d_model
        cache["h"] = torch.zeros((n, batch, d), dtype=torch.float32, device=dev)
        cache["conv"] = torch.zeros((n, batch, cfg.rglru_conv_width - 1, d),
                                    dtype=torch.bfloat16, device=dev)
    cache["pos"] = pos
    return cache


__all__ = ["LM", "Block", "RGLRUBlock", "RWKVBlock", "init_params", "init_cache",
           "padded_vocab", "check_supported", "layer_kinds", "unit_structure", "kind_index",
           "VOCAB_PAD"]
