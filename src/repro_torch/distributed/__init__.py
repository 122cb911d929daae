"""Distributed support of the port: ``repro.distributed`` on
``torch.distributed`` ranks: the sharding rules and their execution on
local shards, the collectives the sharded model calls, the GPipe pipeline,
and the fault-tolerance pieces with ``remesh``."""
from . import collectives, fault_tolerance, pipeline, sharding
from .fault_tolerance import FailureInjector, RestartManifest, StepMonitor, remesh
from .sharding import batch_spec, cache_shardings, data_shardings, param_spec, zero_spec

__all__ = ["collectives", "fault_tolerance", "pipeline", "sharding", "RestartManifest",
           "StepMonitor", "FailureInjector", "remesh", "param_spec", "zero_spec", "batch_spec",
           "data_shardings", "cache_shardings"]
