"""Training step of the port: ``repro.training.train_step``.

loss -> backward -> AdamW, with microbatch gradient accumulation. The model
stays an ``nn.Module`` and the step updates it in place: ``TrainState``
holds the model and the optimizer state, and ``step(state, batch)``
returns the same model with new weights and a new ``AdamWState``.

With ``microbatches > 1`` the batch (the frontend too) is split along its
leading axis; each microbatch's gradients are accumulated in fp32 and
divided by the count, and the step reports the mean loss and no
``ce``/``aux`` metrics, as the JAX scan does. An MoE layer routes each
microbatch's tokens on their own, with the capacity of a microbatch, as
each step of the JAX scan routes them. The JAX step's ``remat`` is a memory policy of its scan over
stacked units; numerically it is the same forward, and the port keeps
every activation instead.

The step's forward and backward run under ``fp32_reductions``: a bf16 GEMM
on the card sums its products in fp32 to the end, as the JAX package's
dots do.

``compress_int8``, ``decompress_int8`` and ``compress_grads`` (int8 with
error feedback) are the reference's functions; as in the reference, no
step calls them.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch

from ..configs.base import ModelConfig
from ..models.bridge import decayed_leaves, params_from_jax, params_to_jax, to_numpy
from ..models.lm import LM, check_trainable, init_params, loss_fn
from .optimizer import AdamW, AdamWState


class TrainState(NamedTuple):
    model: LM
    opt: AdamWState


class TrainTree(NamedTuple):
    """A TrainState in the JAX package's layout (the fields of its
    ``TrainState``), every leaf a host numpy array: what a checkpoint
    holds."""
    params: dict
    opt: AdamWState


def state_tree(state: TrainState) -> TrainTree:
    """A host copy of `state` in the JAX layout: parameters, master copy and
    moments restacked by ``params_to_jax``, the step an int32 scalar."""
    cfg, opt = state.model.cfg, state.opt
    return TrainTree(params_to_jax(cfg, state.model.state_dict()),
                     AdamWState(to_numpy(opt.step), *(params_to_jax(cfg, d)
                                                      for d in (opt.master, opt.m, opt.v))))


@torch.no_grad()
def load_state_tree(state: TrainState, tree: TrainTree) -> TrainState:
    """Copy a restored tree (``Checkpointer.restore(state_tree(state))``)
    into `state` in place, on the state's device; returns `state`."""
    cfg, opt = state.model.cfg, state.opt
    state.model.load_state_dict(params_from_jax(cfg, tree.params))
    for dst, src in ((opt.master, tree.opt.master), (opt.m, tree.opt.m), (opt.v, tree.opt.v)):
        for n, t in params_from_jax(cfg, src).items():
            dst[n].copy_(t)
    opt.step.copy_(tree.opt.step)
    return state


def compress_int8(g: torch.Tensor):
    """Per-tensor symmetric int8 quantization: (q int8, scale fp32)."""
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    return torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8), scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_grads(grads: dict, error_feedback: Optional[dict] = None):
    """int8 with error feedback; returns (dequantized grads in their own
    dtypes, new fp32 residuals), both keyed as `grads`."""
    if error_feedback is None:
        error_feedback = {n: torch.zeros_like(g) for n, g in grads.items()}
    deq, res = {}, {}
    for n, g in grads.items():
        gf = g.float() + error_feedback[n]
        d = decompress_int8(*compress_int8(gf))
        deq[n], res[n] = d.to(g.dtype), gf - d
    return deq, res


@contextlib.contextmanager
def fp32_reductions():
    """Within the block a bf16 GEMM on the card adds its partial sums in
    fp32: cuBLAS's default (``allow_bf16_reduced_precision_reduction``)
    lets a split-K product add them in bf16, which for the head's backward
    (K = the vocabulary) doubled the error of whisper-tiny's final-norm
    gradients against the CPU's. Restores the setting after."""
    flags = torch.backends.cuda.matmul
    allowed = flags.allow_bf16_reduced_precision_reduction
    flags.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        flags.allow_bf16_reduced_precision_reduction = allowed


def init_state(cfg: ModelConfig, opt: AdamW, seed: int = 0, device=None) -> TrainState:
    """A model from ``init_params`` made trainable, and its optimizer state."""
    check_trainable(cfg)
    model = init_params(cfg, seed, device).requires_grad_(True)
    return TrainState(model, opt.init(dict(model.named_parameters())))


def make_train_step(cfg: ModelConfig, opt: AdamW, microbatches: int = 1,
                    has_frontend: bool = False):
    """Returns step(state, batch) -> (state, metrics). batch: {tokens,
    targets[, mask][, frontend]} tensors on the model's device, global
    batch leading; the frontend (B, n_frontend_tokens, d) is read only with
    `has_frontend` (``needs_frontend(cfg)``), as the JAX step reads it.
    Metrics are 0-dim tensors (read them only where the host needs them)."""
    check_trainable(cfg)

    def step(state: TrainState, batch: dict):
        model = state.model
        params = dict(model.named_parameters())
        decayed = decayed_leaves(cfg, params)
        tokens, targets = batch["tokens"], batch["targets"]
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones_like(targets, dtype=torch.float32)
        frontend = batch.get("frontend") if has_frontend else None
        with fp32_reductions():
            lv, grads, met = loss_and_grads(model, params, tokens, targets, mask, frontend)
        new_opt, stats = opt.update(grads, state.opt, params, decayed)
        return TrainState(model, new_opt), {"loss": lv, **stats, **met}

    def loss_and_grads(model, params, tokens, targets, mask, frontend):
        """(loss, gradients keyed as `params`, metrics), detached."""
        names, leaves = list(params), list(params.values())
        if microbatches > 1:
            acc = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
            total = torch.zeros((), dtype=torch.float32, device=tokens.device)
            split = [a.reshape(microbatches, -1, *a.shape[1:]) for a in (tokens, targets, mask)]
            fronts = [None] * microbatches if frontend is None else \
                frontend.reshape(microbatches, -1, *frontend.shape[1:])
            for t, tg, mk, fe in zip(*split, fronts):
                lv, _ = loss_fn(model, t, tg, mask=mk, frontend=fe)
                for n, g in zip(names, torch.autograd.grad(lv, leaves)):
                    acc[n] += g.float()
                total += lv.detach()
            grads = {n: g / microbatches for n, g in acc.items()}
            return total / microbatches, grads, {}
        lv, met = loss_fn(model, tokens, targets, mask=mask, frontend=frontend)
        grads = dict(zip(names, torch.autograd.grad(lv, leaves)))
        return lv.detach(), grads, {k: v.detach() for k, v in met.items()}

    return step


__all__ = ["TrainState", "TrainTree", "state_tree", "load_state_tree", "init_state",
           "make_train_step", "fp32_reductions", "compress_int8", "decompress_int8",
           "compress_grads"]
