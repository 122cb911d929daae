"""Pipeline parallelism over the ``pod`` axis of the port: the GPipe
schedule of ``repro.distributed.pipeline``, with point-to-point sends.

The stacked-units layout makes pipelining natural: each pod rank holds
n_units / P consecutive units (``stage_params``), and activations travel
from stage to stage. The microbatch loop keeps every stage busy after the
fill: ``n_microbatches + n_stages - 1`` ticks, at tick t stage s runs
microbatch t - s. The last stage's outputs are broadcast to every stage,
as the JAX function's psum over ``pod`` leaves them on every rank.

Forward only: differentiating through the schedule is ROADMAP A12b (the
JAX package's ``pipeline_apply`` has no caller and no test of its own).
"""
from __future__ import annotations

from typing import Callable

import torch

from . import collectives as C


def stage_params(params, mesh):
    """This pod rank's units of `params`: a tensor, or a dict or list of
    them, each with the unit axis leading (the JAX ``P("pod")``)."""
    from .sharding import shard
    if isinstance(params, dict):
        return {k: stage_params(v, mesh) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(stage_params(v, mesh) for v in params)
    return shard(params, ("pod",), mesh)


@torch.no_grad()
def pipeline_apply(mesh, stage_fn: Callable, local_params, x: torch.Tensor,
                   n_microbatches: int) -> torch.Tensor:
    """Run x through every pipeline stage.

    stage_fn(local_params, x) -> x applies this pod rank's units;
    local_params: this stage's (``stage_params``); x: (B, ...) activations,
    the same on every stage, B % n_microbatches == 0. Returns the last
    stage's output for all of x on every stage."""
    n_stages = mesh.shape.get("pod", 1)
    group = mesh.group("pod")
    stage = mesh.index("pod")
    B = x.shape[0]
    if B % n_microbatches:
        raise ValueError(f"a batch of {B} does not split into {n_microbatches} microbatches")
    xs = x.reshape(n_microbatches, B // n_microbatches, *x.shape[1:])
    out = torch.zeros_like(xs)
    ranks = mesh.group_ranks("pod") if group is not None else [mesh.rank]
    for t in range(n_microbatches + n_stages - 1):
        mb = t - stage
        if not 0 <= mb < n_microbatches:
            continue
        if stage == 0:
            cur = xs[mb]
        else:
            cur = C.recv(torch.empty_like(xs[0]), ranks[stage - 1], group)
        y = stage_fn(local_params, cur)
        if stage == n_stages - 1:
            out[mb] = y
        else:
            C.send(y, ranks[stage + 1], group)
    if group is not None:
        out = C.broadcast(out, ranks[-1], group)
    return out.reshape(B, *x.shape[1:])


__all__ = ["pipeline_apply", "stage_params"]
