"""Fault tolerance of the port: ``repro.distributed.fault_tolerance``'s
restart manifest, straggler monitor and failure injector, copied (plain
Python and numpy), and ``remesh``, which builds the largest mesh from the
surviving ranks with the JAX function's arithmetic.

Recovery: every K steps the trainer commits (checkpoint, RestartManifest);
on failure the launcher restarts on the surviving ranks, calls ``remesh``,
restores the checkpoint onto the new mesh (``Checkpointer.restore`` with
the mesh's specs gives each rank its slices), and skips the data
pipeline, a pure function of step, to ``manifest.step + 1``, with no data
lost or duplicated.
StepMonitor tracks a rolling step-time distribution; steps beyond
``threshold_sigma`` trigger the ``on_straggler`` callback.
"""
from __future__ import annotations

import json
import math
import os
import time
from dataclasses import asdict, dataclass
from typing import Callable, List, Optional

import numpy as np


@dataclass
class RestartManifest:
    step: int
    data_step: int
    mesh_shape: dict
    rng_seed: int
    wall_time: float = 0.0

    def save(self, path: str):
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(asdict(self), f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "RestartManifest":
        with open(path) as f:
            return cls(**json.load(f))


def remesh_shape(n: int, model_parallel: int = 1, pods: int = 1) -> tuple:
    """(pod, data, model) of the largest mesh over `n` ranks: model the gcd
    of `model_parallel` and n, whole pods, the ranks past the last full
    model group of each pod dropped (the JAX ``remesh``'s arithmetic)."""
    model = math.gcd(model_parallel, n)
    usable_per_pod = (n // pods // model) * model
    return pods, usable_per_pod // model, model


def remesh(ranks=None, model_parallel: int = 1, pods: int = 1):
    """The largest (pod, data, model) mesh over the surviving `ranks` (the
    world's by default), the rest dropped: elastic down-scaling. Every rank
    of the world calls it (the mesh's groups are made collectively); a
    dropped rank gets a mesh it is not in."""
    import torch.distributed as dist

    from ..launch.mesh import _build
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    shape = remesh_shape(len(ranks), model_parallel, pods)
    return _build(shape, ("pod", "data", "model"), ranks[:int(np.prod(shape))])


class StepMonitor:
    """Rolling step-time stats + straggler detection."""

    def __init__(self, window: int = 50, threshold_sigma: float = 3.0,
                 on_straggler: Optional[Callable[[int, float], None]] = None):
        self.window = window
        self.sigma = threshold_sigma
        self.times: List[float] = []
        self.on_straggler = on_straggler
        self.straggler_steps: List[int] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, step: int) -> float:
        dt = time.perf_counter() - self._t0
        hist = self.times[-self.window:]
        if len(hist) >= 10:
            mu = float(np.mean(hist))
            sd = float(np.std(hist)) + 1e-9
            if dt > mu + self.sigma * sd:
                self.straggler_steps.append(step)
                if self.on_straggler:
                    self.on_straggler(step, dt)
        self.times.append(dt)
        return dt


class FailureInjector:
    """Test hook: raise at a chosen step to exercise restart-recovery."""

    def __init__(self, fail_at_step: Optional[int] = None):
        self.fail_at_step = fail_at_step
        self.fired = False

    def check(self, step: int):
        if (self.fail_at_step is not None and step == self.fail_at_step
                and not self.fired):
            self.fired = True
            raise RuntimeError(f"injected node failure at step {step}")
