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

On a mesh (the model's ``par``, a ``distributed.sharding.ModelShard``)
every rank is handed the same global batch and keeps its data rank's rows
as the JAX layout places them (``ModelShard.local_rows``: microbatches
first, then each microbatch's rows over data); ``loss_fn`` divides by the
whole batch's token count, the gradients are summed over data (and over
model for the leaves each model rank holds a part of, ``sync_grads``) in
fp32, and the gradient norm is the whole model's (``global_sq``). The
leaves are the rank's shards, and the optimizer state their ZeRO slices
(``ModelShard.zero``: each rank updates its slice, the new values are
all-gathered). A pod axis splits the rows with data, pod the major axis.

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
from ..distributed.sharding import init_sharded
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


def state_tree(state: TrainState, gather: bool = True) -> TrainTree:
    """A host copy of `state` in the JAX layout: parameters, master copy and
    moments restacked by ``params_to_jax``, the step an int32 scalar. On a
    mesh every leaf is gathered whole first (every rank takes part), so a
    sharded run writes what a single-rank run writes; with `gather` False
    the leaves stay this rank's slices (a template for ``restore``)."""
    model, opt = state.model, state.opt
    par = model.par
    cfg = model.cfg if par is None else par.cfg
    def whole(d, zero=False):
        return d if par is None or not gather else par.gather_state(d, zero)

    return TrainTree(params_to_jax(cfg, whole(model.state_dict())),
                     AdamWState(to_numpy(opt.step), *(params_to_jax(cfg, whole(d, True))
                                                      for d in (opt.master, opt.m, opt.v))))


@torch.no_grad()
def load_state_tree(state: TrainState, tree: TrainTree) -> TrainState:
    """Copy a restored tree (``Checkpointer.restore(state_tree(state))``,
    on a mesh ``restore(..., mesh=, cfg=)``, which gives each rank its
    slices) into `state` in place, on the state's device; returns
    `state`."""
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


def init_state(cfg: ModelConfig, opt: AdamW, seed: int = 0, device=None,
               mesh=None) -> TrainState:
    """A model from ``init_params`` made trainable, and its optimizer state;
    on a `mesh` this rank's shards of it (``sharding.init_sharded``) and the
    state's ZeRO slices."""
    check_trainable(cfg)
    model = (init_params(cfg, seed, device) if mesh is None
             else init_sharded(cfg, mesh, seed, device)).requires_grad_(True)
    return TrainState(model, opt.init(dict(model.named_parameters()), model.par))


def step_grads(model: LM, batch: dict, microbatches: int = 1, has_frontend: bool = False,
               local: bool = False):
    """(loss, gradients keyed as the model's parameters, metrics) of one
    step on `batch`, detached: what ``make_train_step``'s step hands the
    optimizer. On a mesh the loss and metrics are the whole batch's and the
    gradients this rank's leaves' for the whole step, in fp32; the batch is
    the global one, or with `local` already this rank's rows
    (``ModelShard.local_rows``)."""
    par = model.par
    params = dict(model.named_parameters())
    tokens, targets = batch["tokens"], batch["targets"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones_like(targets, dtype=torch.float32)
    frontend = batch.get("frontend") if has_frontend else None
    if par is not None and not local:
        tokens, targets, mask, frontend = (par.local_rows(a, microbatches, train=True)
                                           for a in (tokens, targets, mask, frontend))
    names, leaves = list(params), list(params.values())
    with fp32_reductions():
        if microbatches > 1:
            acc = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
            total = torch.zeros((), dtype=torch.float32, device=tokens.device)
            split = [a.reshape(microbatches, -1, *a.shape[1:]) for a in (tokens, targets, mask)]
            fronts = [None] * microbatches if frontend is None else \
                frontend.reshape(microbatches, -1, *frontend.shape[1:])
            for t, tg, mk, fe in zip(*split, fronts):
                lv, met = loss_fn(model, t, tg, mask=mk, frontend=fe)
                for n, g in zip(names, torch.autograd.grad(lv, leaves)):
                    acc[n] += g.float()
                total += met.get("loss", lv).detach()
            lv, grads, met = total / microbatches, {n: g / microbatches
                                                    for n, g in acc.items()}, {}
        else:
            lv, met = loss_fn(model, tokens, targets, mask=mask, frontend=frontend)
            grads = dict(zip(names, torch.autograd.grad(lv, leaves)))
            # on a data axis lv is this rank's part, "loss" the whole batch's
            lv = met.pop("loss", lv).detach()
            met = {k: v.detach() for k, v in met.items()}
    if par is not None:
        grads = par.sync_grads(grads)
    return lv, grads, met


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
        lv, grads, met = step_grads(model, batch, microbatches, has_frontend)
        par = model.par
        new_opt, stats = opt.update(grads, state.opt, params, decayed_leaves(cfg, params),
                                    None if par is None else par.global_sq, par)
        return TrainState(model, new_opt), {"loss": lv, **stats, **met}

    return step


__all__ = ["TrainState", "TrainTree", "state_tree", "load_state_tree", "init_state",
           "make_train_step", "step_grads", "fp32_reductions", "compress_int8", "decompress_int8",
           "compress_grads"]
