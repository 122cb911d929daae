"""AdamW and LR schedules of the port: ``repro.training.optimizer``.

Mixed precision as in the JAX package: the model's parameters in their own
dtypes (bf16 weights, fp32 norm scales), and in the optimizer state an fp32
master copy and fp32 moments. Parameters, gradients and state are dicts
keyed by the model's parameter names (``LM.named_parameters()``).

``update`` works in place: it advances the moments and the master copy,
and writes each new master value into its parameter cast to the
parameter's dtype, as the JAX ``update`` returns ``p.astype(old.dtype)``.
The global gradient norm includes the reference's ``+ 1e-20`` and the bias
corrections are taken in fp32. Weight decay goes to the leaves that
``decayed`` names: the JAX rule is ``p.ndim >= 2`` on its own parameter
tree, whose layers are stacked along a leading axis, so it decays every
leaf of a stacked unit (norm scales and qkv biases included) and no 1-D
leaf outside them (``ROADMAP.md`` C14; ``models.bridge.decayed_leaves``
gives that set for the port's unstacked names).

On a mesh whose ``ModelShard`` (`par`) places ZeRO's axes (``zero``), the
state holds each leaf's ZeRO slice: ``init`` copies it, ``update`` updates
it from the slice of the gradient and all-gathers the new values, cast to
the parameter's dtype, into the parameter.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor    # int32, 0-dim
    master: dict          # fp32 copies of the parameters
    m: dict
    v: dict


@dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params: dict, par=None) -> AdamWState:
        """The state of `params`: on a mesh (`par`) each leaf's ZeRO slice."""
        master = {n: (p.detach() if par is None else par.zero_slice(n, p.detach())).to(
            torch.float32, copy=True) for n, p in params.items()}
        device = next(iter(master.values())).device
        return AdamWState(torch.zeros((), dtype=torch.int32, device=device), master,
                          {n: torch.zeros_like(p) for n, p in master.items()},
                          {n: torch.zeros_like(p) for n, p in master.items()})

    @torch.no_grad()
    def update(self, grads: dict, state: AdamWState, params: dict, decayed: set,
               global_sq: Optional[Callable[[dict], torch.Tensor]] = None, par=None):
        """grads: gradients keyed as `params` (any float dtype); decayed: the
        names of the leaves to decay. Updates the state's master copy and
        moments and `params` in place. Returns (the new state, {"grad_norm",
        "lr"}), 0-dim fp32 tensors. On a mesh the leaves are local shards and
        `global_sq` (``ModelShard.global_sq``) makes the squared norm of the
        whole model's gradients from each leaf's local one, so that clipping
        is the single-rank step's. With `par` the state is its ZeRO slices
        (``init(params, par)``): each rank updates its slice and the new
        values are all-gathered into the parameter."""
        names = list(state.master)
        if global_sq is None:
            sq = torch.zeros((), dtype=torch.float32, device=state.step.device)
            for n in names:
                sq += grads[n].float().square().sum()
        else:
            sq = global_sq({n: grads[n].float().square().sum() for n in names})
        gnorm = torch.sqrt(sq + 1e-20)
        scale = torch.clamp(self.clip_norm / gnorm, max=1.0)
        step = state.step + 1
        lr = self.lr(step)
        b1c = 1 - torch.pow(torch.tensor(self.b1, device=step.device), step.float())
        b2c = 1 - torch.pow(torch.tensor(self.b2, device=step.device), step.float())
        for n in names:
            p, m, v = state.master[n], state.m[n], state.v[n]
            g = grads[n] if par is None else par.zero_slice(n, grads[n])
            g = g.to(torch.float32, copy=True).mul_(scale)
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            upd = (m / b1c).div_((v / b2c).sqrt_().add_(self.eps))
            if n in decayed:
                upd.add_(p, alpha=self.weight_decay)
            p.sub_(upd.mul_(lr))
            if par is None or n not in par.zero:
                params[n].copy_(p)
            else:
                params[n].copy_(par.zero_gather(n, p.to(params[n].dtype)))
        return AdamWState(step, state.master, state.m, state.v), {"grad_norm": gnorm, "lr": lr}


def cosine_schedule(peak: float, warmup: int, total: int, floor_frac: float = 0.1):
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = peak * s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak * (floor_frac + (1 - floor_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(s < warmup, warm, cos)
    return lr


def constant_schedule(value: float):
    return lambda step: torch.tensor(value, dtype=torch.float32, device=step.device)
