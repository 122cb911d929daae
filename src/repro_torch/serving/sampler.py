"""Token samplers (greedy / temperature / top-k / top-p) of the port.

The same policies as ``repro.serving.sampler``, drawing from an explicit
``torch.Generator`` (which must live on the logits' device) where the JAX
version splits a PRNG key. The two frameworks draw different numbers from
the same seed; greedy rows are an argmax in both and consume no randomness.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0       # 0 -> greedy
    top_k: int = 0                 # 0 -> off
    top_p: float = 1.0             # 1 -> off


def sample(logits: torch.Tensor, generator: torch.Generator,
           params: SamplingParams) -> torch.Tensor:
    """logits: (B, V) -> (B,) int32."""
    if params.temperature <= 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    logits = logits.float() / params.temperature
    if params.top_k:
        kth = torch.topk(logits, params.top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if params.top_p < 1.0:
        sorted_ = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_, dim=-1), dim=-1)
        cutoff_idx = (cum < params.top_p).sum(dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_, -1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def sample_per_request(logits: torch.Tensor, generator: torch.Generator,
                       params: Sequence[SamplingParams]) -> torch.Tensor:
    """Per-row sampling: logits (B, V) with one SamplingParams PER ROW.

    Rows sharing identical params are sampled together through `sample`;
    greedy rows stay a pure argmax and never consume randomness, so a greedy
    request's stream does not depend on its batch neighbours. Non-greedy
    groups draw from the one generator in turn, so distinct groups never
    share a draw and a fixed seed and schedule reproduce the stream.
    Returns (B,) int32."""
    if len(params) != logits.shape[0]:
        raise ValueError(f"{len(params)} params for {logits.shape[0]} rows")
    groups: dict = {}
    for i, p in enumerate(params):
        groups.setdefault(p, []).append(i)
    if len(groups) == 1:
        (p, _), = groups.items()
        return sample(logits, generator, p)
    out = torch.empty(logits.shape[0], dtype=torch.int32, device=logits.device)
    for p, rows in groups.items():
        idx = torch.tensor(rows, device=logits.device)
        out[idx] = sample(logits[idx], generator, p)
    return out
