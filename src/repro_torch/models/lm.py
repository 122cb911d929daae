"""Decoder LM of the port, the dense, MoE, RWKV6, Griffin, vision
cross-attention and encoder-decoder paths of ``repro.models.lm``.

``LM`` is an ``nn.Module`` holding a ``ModuleList`` of blocks, one per layer
in layer order; the JAX package's stacked-unit scan becomes a Python loop
over the blocks (``layer_kinds`` and ``unit_structure`` give the JAX
grouping, which ``params_from_jax`` unstacks). An encoder-decoder also holds
``enc``: its encoder's ``layers`` and ``final_norm``.

Public entry points, counterparts of the JAX functions of the same names:
    init_params -> LM, LM.forward (teacher-forced logits), loss_fn,
    init_cache, LM.prefill, LM.decode_step, padded_vocab

Training: parameters are made with ``requires_grad=False``, so serving
builds no autograd graph; a trainer calls ``model.requires_grad_(True)``
after ``check_trainable``. The kernel ops then run as autograd Functions
with hand-written backward kernels (RMSNorm, LayerNorm, SwiGLU, GELU,
gated GELU, flash attention). ``loss_fn`` passes ``forward`` a list into
which every MoE layer appends its Switch aux loss, as the JAX forward sums
it; serving passes none, and the layers then compute none.

The cache is a dict of tensors updated IN PLACE by ``prefill`` and
``decode_step`` (the JAX functions return a new cache). Every tensor but
``pos`` has a layer of one kind on axis 0 and the sequence (slot) on axis 1.
The self-attention layers' (``attn`` and ``encdec``) ``k`` and ``v`` are
fused (n_self, B, T, Hkv*dh) bf16, with T = min(max_len, attn_window) for a
windowed model: a ring, position p in slot p % T. The cross-attending
layers' (``xattn`` and ``encdec``) ``xk`` and ``xv`` are (n_cross, B,
n_frontend_tokens, Hkv*dh) bf16, written once by ``prefill``. Griffin's
RG-LRU layers keep ``h`` (n_rglru, B, d) fp32 and the conv carry ``conv``
(n_rglru, B, W-1, d) bf16. An RWKV6 model's ``state`` is (n_layers, B, H,
N, N) fp32 and its token shifts ``sx_t`` / ``sx_c`` (n_layers, B, d) bf16.
``pos`` (B,) int32 holds each sequence's next position (continuous
batching). The JAX cache of an encoder-decoder also keeps ``enc_out``,
which its ``decode_step`` reads and never uses; the port keeps only the
cross K/V made from it.

Ported: dense decoders with full causal or local (windowed) attention, an
attention logit softcap or none, RMSNorm or LayerNorm, a SwiGLU, gated-GELU
or plain tanh-GELU MLP, and full, partial (stablelm) or no RoPE; with no
RoPE (gpt3, whisper's decoder) sinusoidal positions are added to the
embeddings, as the JAX model adds them. MoE decoders (``family == "moe"``,
granite-moe-3b-a800m, grok-1-314b): each layer's MLP is ``n_experts`` such
MLPs behind a top-k router with a capacity (``layers.moe_apply``). The
attention-free RWKV6 (``family == "ssm"``, rwkv6-7b), no positions. Griffin
(``family == "hybrid"``, recurrentgemma-2b): a ``block_pattern`` of RG-LRU
and local-attention layers. Vision cross-attention (``cross_attn_layers``,
llama-3.2-vision-11b): each listed layer (``xattn``) has no self-attention
and attends, non-causally and without RoPE, over the K/V of a stub frontend
of ``n_frontend_tokens`` embeddings, its output gated by ``tanh(xgate)``.
And an encoder-decoder (``cross_attention``, whisper-tiny): an encoder of
``n_encoder_layers`` non-causal layers over the frontend plus sinusoidal
positions, and decoder layers (``encdec``) that cross-attend to its output
between their self-attention and their MLP. Any other config raises
NotImplementedError naming the field.

Frontends: ``forward`` and ``prefill`` take one of (B, n_frontend_tokens,
d), rounded to the embeddings' dtype (bf16); another length raises
ValueError, as the cache holds exactly that many cross keys. An
encoder-decoder needs one (the JAX model fails without it, ROADMAP.md
C12). A vision model's ``prefill``
without one attends over zero cross K/V, as the JAX prefill does over the
zeros of a fresh cache; the port zeroes them in place, so that a reused
cache never lends a sequence another's. A zero frontend row gives a
sequence of a batch the same zero cross K/V, as vision cross layers take
no qkv bias (``check_supported``). Its ``forward`` needs one: without
it the JAX forward would attend from each token to the whole sequence.

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
from ..kernels.decode_attention.ops import attend_all_keys, decode_attention
from . import layers as L
from . import recurrent as R

VOCAB_PAD = 256      # embeddings padded as in the JAX package

_FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")

# (field, test that the port runs the config's value of it, why not) for
# every config field of the ported slices
_SUPPORTED = (
    ("family", lambda c: c.family in _FAMILIES, f"no family but {_FAMILIES} is ported"),
    ("block_pattern", lambda c: set(c.block_pattern) <= {"rglru", "attn"},
     "a layer kind other than RG-LRU and attention"),
    ("n_encoder_layers", lambda c: not c.n_encoder_layers or c.cross_attention,
     "an encoder whose output no decoder layer reads"),
    # the JAX cached encdec arm leaves the cross q un-normed where its forward
    # norms it, and its encoder layers have no MoE arm: no such config runs
    ("cross_attention", lambda c: not c.cross_attention or bool(
        c.n_encoder_layers and c.n_frontend_tokens and not c.cross_attn_layers
        and not c.block_pattern and not c.attention_free and not c.n_experts
        and not c.qk_norm),
     "an encoder-decoder needs encoder layers and frontend tokens, and takes no "
     "vision cross layers, block pattern, experts or qk-norm"),
    # the JAX xattn layer is built with a dense MLP and applied with the MoE
    # one; a request without a frontend gets zero cross K/V from zero
    # frontend rows, which qkv biases would make nonzero
    ("cross_attn_layers", lambda c: not c.cross_attn_layers or bool(
        c.n_frontend_tokens and not c.block_pattern and not c.attention_free
        and not c.n_experts and not c.qkv_bias),
     "vision cross layers need frontend tokens, and take no block pattern, experts "
     "or qkv biases"),
    ("n_frontend_tokens",
     lambda c: not c.n_frontend_tokens or c.cross_attention or bool(c.cross_attn_layers),
     "a frontend that no layer reads"),
    ("norm", lambda c: c.norm in ("rmsnorm", "layernorm"), "RMSNorm and LayerNorm only"),
    # a gated MLP runs the SwiGLU or the gated-GELU kernel, a plain one the
    # GELU kernel; RWKV6's channel mix is relu^2 whatever the field says
    ("activation", lambda c: c.attention_free
     or c.activation in (("silu", "gelu") if c.mlp_gated else ("gelu",)),
     "a SwiGLU, gated-GELU or plain GELU MLP only"),
)


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError naming the first config field the port
    does not run."""
    for field, ok, why in _SUPPORTED:
        if not ok(cfg):
            raise NotImplementedError(
                f"{cfg.name}: {field}={getattr(cfg, field)!r} is not run by "
                f"repro_torch: {why}")


def check_trainable(cfg: ModelConfig) -> None:
    """Raise NotImplementedError naming the first config field a train step
    does not run. Every config ``LM`` runs trains (``check_supported``):
    the backward kernels are flash attention (causal or full, self or
    cross, under a window and a logit softcap), RMSNorm, LayerNorm, the
    SwiGLU gate, GELU, the gated GELU, the RG-LRU scan and the WKV
    recurrence. So all eleven configs train: qwen1.5-0.5b, qwen2-0.5b,
    qwen3-1.7b, stablelm-1.6b, granite-moe-3b-a800m, grok-1-314b,
    recurrentgemma-2b, whisper-tiny, llama-3.2-vision-11b, gpt3-175b and
    rwkv6-7b."""
    check_supported(cfg)


def needs_frontend(cfg: ModelConfig) -> bool:
    """Whether a train step feeds the model a frontend: the audio and
    vision families, as the JAX ``needs_frontend`` decides."""
    return cfg.family in ("audio", "vlm")


def layer_kinds(cfg: ModelConfig) -> list:
    """The kind of each layer, as the JAX ``layer_kinds`` gives it: "rglru",
    "rwkv", or for an attention layer "encdec" in an encoder-decoder,
    "xattn" at a vision cross layer, else "attn"."""
    kinds = []
    for i in range(cfg.n_layers):
        k = cfg.block_kind(i)
        if k == "attn":
            if cfg.cross_attention:
                k = "encdec"
            elif i in cfg.cross_attn_layers:
                k = "xattn"
        kinds.append(k)
    return kinds


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
    cache tensors of that kind (an "encdec" layer's of both ``k``/``v`` and
    ``xk``/``xv``; no config has "encdec" layers beside "attn" ones)."""
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

    def mlp_residual(self, cfg: ModelConfig, x: torch.Tensor,
                     aux: Optional[list] = None) -> torch.Tensor:
        """x plus the MLP or MoE layer of its norm (the JAX
        ``_mlp_or_moe``). An MoE layer appends its aux loss to `aux` where
        one is given, and computes none where it is None (serving)."""
        h = L.apply_norm(cfg, self.ln2, x)
        if cfg.n_experts:
            y, a = L.moe_apply(cfg, self.moe, h, with_aux=aux is not None)
            if aux is not None:
                aux.append(a)
            return x + y
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


class EncDecBlock(Block):
    """A decoder layer of an encoder-decoder: ``Block`` plus ``lnx`` and
    ``xattn``, the ungated cross-attention to the encoder's output between
    the self-attention and the MLP."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator], device):
        super().__init__(cfg, gen, device)
        self.lnx = L.norm_init(cfg, device)
        self.xattn = L.attn_init(cfg, gen, device)


class XAttnBlock(nn.Module):
    """A vision cross-attention layer: norm, cross-attention to the frontend
    gated by ``tanh(xgate)`` (an fp32 scalar, 0 at init as in JAX), norm,
    MLP. It has no self-attention."""

    mlp_residual = Block.mlp_residual

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator], device):
        super().__init__()
        self.ln1 = L.norm_init(cfg, device)
        self.xattn = L.attn_init(cfg, gen, device)
        self.xgate = L._param(torch.zeros(1, dtype=torch.float32, device=device))
        self.ln2 = L.norm_init(cfg, device)
        self.mlp = L.mlp_init(cfg, gen, device)


_BLOCKS = {"attn": Block, "rglru": RGLRUBlock, "rwkv": RWKVBlock, "encdec": EncDecBlock,
           "xattn": XAttnBlock}


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
        if cfg.n_encoder_layers:
            self.enc = nn.ModuleDict({
                "layers": nn.ModuleList(Block(cfg, gen, device)
                                        for _ in range(cfg.n_encoder_layers)),
                "final_norm": L.norm_init(cfg, device)})

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
    def _cross_source(self, frontend: Optional[torch.Tensor], B: int,
                      required: bool) -> Optional[torch.Tensor]:
        """What the cross-attending layers' K/V come from: the frontend
        (B, n_frontend_tokens, d) in the embeddings' dtype (bf16), or for an
        encoder-decoder the encoder's output over it. None where the model
        has no cross layer, or where a vision model's prefill has no
        frontend (it attends over zero cross K/V). Raises ValueError for a frontend of another shape
        and for a missing one that the call needs."""
        cfg = self.cfg
        if not set(self.kinds) & {"xattn", "encdec"}:
            return None
        if frontend is None:
            if required or cfg.n_encoder_layers:
                raise ValueError(f"{cfg.name} needs a frontend of (B, {cfg.n_frontend_tokens}, "
                                 f"{cfg.d_model}) embeddings for its cross-attention")
            return None
        want = (B, cfg.n_frontend_tokens, cfg.d_model)
        if tuple(frontend.shape) != want:
            raise ValueError(f"{cfg.name} takes a frontend of {want}, got "
                             f"{tuple(frontend.shape)}")
        frontend = frontend.to(self.embed.dtype)
        return self._encode(frontend) if cfg.n_encoder_layers else frontend

    def _encode(self, frontend: torch.Tensor) -> torch.Tensor:
        """The encoder (the JAX ``_encode``): the frontend plus its
        sinusoidal positions (rounded to bf16, then added), per layer
        non-causal self-attention with no RoPE and the MLP, then the final
        norm."""
        cfg = self.cfg
        pe = L.sinusoidal_positions(torch.arange(frontend.shape[1], device=frontend.device),
                                    cfg.d_model)
        x = frontend + pe.to(frontend.dtype)
        for blk in self.enc["layers"]:
            q, k, v = L.attn_qkv(cfg, blk.attn, L.apply_norm(cfg, blk.ln1, x))
            o = L.flash_attention(q, k, v, causal=False)
            x = blk.mlp_residual(cfg, x + L.attn_out(blk.attn, o))
        return L.apply_norm(cfg, self.enc["final_norm"], x)

    def _cross(self, blk, x: torch.Tensor, src: Optional[torch.Tensor] = None,
               xk: Optional[torch.Tensor] = None, xv: Optional[torch.Tensor] = None,
               decode: bool = False) -> torch.Tensor:
        """x plus the layer's cross-attention residual: q from x's norm
        (``ln1`` in an xattn layer, ``lnx`` in an encdec one), non-causal
        over every cross key, no RoPE. k, v come from `src` (B, nf, d),
        written into the cache rows `xk`, `xv` (B, nf, Hkv*dh) where given,
        or else are those rows. Flash attention runs it, or at a `decode`
        step (one query) ``attend_all_keys``. An xattn layer gates the
        output by ``tanh(xgate)``: the fp32 product is rounded once."""
        cfg = self.cfg
        gated = isinstance(blk, XAttnBlock)
        h = L.apply_norm(cfg, blk.ln1 if gated else blk.lnx, x)
        if src is None:
            q = L.attn_q(cfg, blk.xattn, h)
            k, v = (t.view(t.shape[0], t.shape[1], cfg.n_kv_heads, cfg.d_head)
                    for t in (xk, xv))
        else:
            q, k, v = L.attn_qkv(cfg, blk.xattn, h, kv_src=src)
            if xk is not None:
                xk.copy_(k.flatten(2))
                xv.copy_(v.flatten(2))
        if decode:
            B, _, Hq, dh = q.shape
            o = attend_all_keys(q.reshape(B, cfg.n_kv_heads, Hq // cfg.n_kv_heads, dh),
                                k, v).reshape(B, 1, Hq, dh)
        else:
            o = L.flash_attention(q, k, v, causal=False)
        y = L.attn_out(blk.xattn, o)
        return x + (torch.tanh(blk.xgate) * y).to(x.dtype) if gated else x + y

    # ------------------------------------------------------------------
    def forward(self, tokens: torch.Tensor, frontend: Optional[torch.Tensor] = None,
                aux: Optional[list] = None) -> torch.Tensor:
        """tokens: (B, S) -> logits (B, S, V_padded); frontend: (B,
        n_frontend_tokens, d) stub embeddings, needed by a model with a
        cross-attending layer. The JAX forward also returns the MoE layers'
        summed aux loss, which only its loss reads: here each MoE layer
        appends its own to `aux` where a list is given (``loss_fn`` sums
        them), and computes none otherwise."""
        cfg = self.cfg
        B, S = tokens.shape
        positions = torch.arange(S, device=tokens.device)
        x = self._embed(tokens, positions)
        if cfg.attention_free:
            zeros = x.new_zeros((B, cfg.d_model))
            for blk in self.blocks:
                x = blk.mix(cfg, x, zeros, zeros)[0]
            return self._logits(x)
        src = self._cross_source(frontend, B, required=True)
        rope = L.rope_tables(cfg, positions.expand(B, S))
        for kind, blk in zip(self.kinds, self.blocks):
            if kind == "rglru":
                x = blk.mix(cfg, x)[0]
                continue
            if kind != "xattn":
                x = self._attention(blk, x, rope)[0]
            if kind != "attn":
                x = self._cross(blk, x, src)
            x = blk.mlp_residual(cfg, x, aux)
        return self._logits(x)

    # ------------------------------------------------------------------
    def prefill(self, tokens: torch.Tensor, cache: dict,
                prompt_lens: Optional[torch.Tensor] = None,
                frontend: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Process right-padded prompts from position 0, writing their K/V
        (and cross K/V, RG-LRU state and conv carry, or RWKV6 state and
        token shifts) into ``cache`` in place. prompt_lens: (B,) true
        prompt lengths (defaults to S); frontend: (B, n_frontend_tokens, d)
        stub embeddings (see the module's note); a zero row gives a vision
        model's sequence zero cross K/V, as no frontend does. Returns the
        logits at each sequence's last real token, (B, V_padded)."""
        cfg = self.cfg
        B, S = tokens.shape
        if prompt_lens is None:
            prompt_lens = torch.full((B,), S, dtype=torch.int32, device=tokens.device)
        if cfg.attention_free:
            return self._prefill_rwkv(tokens, cache, prompt_lens)
        T = cache["k"].shape[2] if "k" in cache else S
        if S > T and not cfg.attn_window:
            raise ValueError(f"prompt of {S} tokens exceeds the cache's {T}")
        src = self._cross_source(frontend, B, required=False)
        if src is None and "xk" in cache:
            cache["xk"].zero_()
            cache["xv"].zero_()
        positions = torch.arange(S, device=tokens.device)
        x = self._embed(tokens, positions)
        rope = L.rope_tables(cfg, positions.expand(B, S))
        bidx = torch.arange(B, device=x.device)
        if S > T:
            # a ring shorter than the prompts: each prompt's own last T
            # positions (from 0 for one no longer than T), position p in
            # slot p % T
            src_pos = (prompt_lens.long() - T).clamp(min=0)[:, None] + torch.arange(
                T, device=x.device)
            dst = (bidx[:, None], src_pos % T)
        for i, (kind, blk) in enumerate(zip(self.kinds, self.blocks)):
            j = self.rows[i]
            if kind == "rglru":
                x, (_, conv) = blk.mix(cfg, x, lengths=prompt_lens, h_out=cache["h"][j])
                cache["conv"][j] = conv
                continue
            if kind != "xattn":
                x, k, v = self._attention(blk, x, rope)
                # pads sit after the valid tokens; decode overwrites them in turn
                for name, t in (("k", k), ("v", v)):
                    t = t.reshape(B, S, -1)
                    if S > T:
                        cache[name][j][dst] = t[bidx[:, None], src_pos]
                    else:
                        cache[name][j, :, :S] = t
            if kind != "attn":
                x = self._cross(blk, x, src, cache["xk"][j], cache["xv"][j])
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
        and token shifts), in place, and advances the position. The cross
        layers read the cross K/V that ``prefill`` wrote."""
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
            if kind != "xattn":
                h = L.apply_norm(cfg, blk.ln1, x)
                q, k, v = L.attn_qkv(cfg, blk.attn, h, rope)
                ck, cv = cache["k"][j], cache["v"][j]
                for c, t in ((ck, k), (cv, v)):
                    t = t.reshape(B, -1)
                    c[bidx, wpos] = t if in_range is None else torch.where(
                        in_range, t, c[bidx, wpos])
                o = _decode_attend(cfg, q, ck.view(B, T, hkv, dh),
                                   cv.view(B, T, hkv, dh), valid)
                x = x + L.attn_out(blk.attn, o)
            if kind != "attn":
                x = self._cross(blk, x, xk=cache["xk"][j], xv=cache["xv"][j], decode=True)
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


def loss_fn(model: LM, tokens: torch.Tensor, targets: torch.Tensor,
            mask: Optional[torch.Tensor] = None, frontend: Optional[torch.Tensor] = None,
            aux_weight: float = 0.01, z_weight: float = 1e-4):
    """The JAX ``loss_fn``: masked next-token cross-entropy over fp32
    logits plus ``z_weight`` times the mean squared log-partition and
    ``aux_weight`` times the MoE aux loss, summed over the MoE layers in
    layer order from 0 (0 for a model without experts). Returns (total,
    {"ce", "z_loss", "aux", "tokens"}), each a 0-dim fp32 tensor."""
    layer_aux = []
    logits = model(tokens, frontend, layer_aux).float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, targets.long()[..., None])[..., 0] - logz
    if mask is None:
        mask = torch.ones_like(targets, dtype=torch.float32)
    denom = mask.sum().clamp_min(1.0)
    ce = -(ll * mask).sum() / denom
    zl = z_weight * (logz.square() * mask).sum() / denom
    aux = sum(layer_aux, torch.zeros((), dtype=torch.float32, device=logits.device))
    return ce + zl + aux_weight * aux, {"ce": ce, "z_loss": zl, "aux": aux, "tokens": denom}


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> LM:
    """Random weights from a ``torch.Generator`` seeded with ``seed`` on the
    target device (the same shapes and scales as the JAX init, not the same
    numbers). On the meta device only the shapes are made."""
    dev = resolve_device(device)
    gen = None if dev.type == "meta" else torch.Generator(dev).manual_seed(seed)
    return LM(cfg, gen, dev)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> dict:
    """Fused bf16 K/V of (n_self, batch, T, Hkv*dh) for the self-attention
    layers (T = max_len, or min(max_len, attn_window) for a windowed model:
    the ring), bf16 cross K/V of (n_cross, batch, n_frontend_tokens,
    Hkv*dh) for the cross-attending layers, the fp32 RG-LRU state (n_rglru,
    batch, d) and bf16 conv carry (n_rglru, batch, W-1, d) of Griffin's
    recurrent layers, or for RWKV6 the fp32 state (n_layers, batch, H, N, N)
    and the bf16 token shifts (n_layers, batch, d) (no length limit); and
    the per-sequence positions."""
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
    kv = cfg.n_kv_heads * cfg.d_head
    n_self = kinds.count("attn") + kinds.count("encdec")
    if n_self:
        T = min(max_len, cfg.attn_window) if cfg.attn_window else max_len
        cache["k"] = torch.zeros((n_self, batch, T, kv), dtype=torch.bfloat16, device=dev)
        cache["v"] = torch.zeros_like(cache["k"])
    n_cross = kinds.count("xattn") + kinds.count("encdec")
    if n_cross:
        shape = (n_cross, batch, cfg.n_frontend_tokens, kv)
        cache["xk"] = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
        cache["xv"] = torch.zeros_like(cache["xk"])
    if "rglru" in kinds:
        n, d = kinds.count("rglru"), cfg.d_model
        cache["h"] = torch.zeros((n, batch, d), dtype=torch.float32, device=dev)
        cache["conv"] = torch.zeros((n, batch, cfg.rglru_conv_width - 1, d),
                                    dtype=torch.bfloat16, device=dev)
    cache["pos"] = pos
    return cache


__all__ = ["LM", "Block", "EncDecBlock", "XAttnBlock", "RGLRUBlock", "RWKVBlock",
           "init_params", "init_cache",
           "padded_vocab", "check_supported", "check_trainable", "needs_frontend", "loss_fn",
           "layer_kinds",
           "unit_structure", "kind_index",
           "VOCAB_PAD"]
