"""Serving layer of the port: so far only the fault injector, whose
seams the engine, the live catalog and the durability layer fire."""
from repro_torch.serve.faults import FaultInjector, FaultSpec

__all__ = ["FaultInjector", "FaultSpec"]
