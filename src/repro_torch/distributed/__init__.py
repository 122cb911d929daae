"""Distributed support of the port: so far the plain-Python fault-tolerance
pieces of ``repro.distributed``."""
from .fault_tolerance import FailureInjector, RestartManifest, StepMonitor

__all__ = ["RestartManifest", "StepMonitor", "FailureInjector"]
