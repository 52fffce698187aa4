"""Simulator core: config, state, the four phases and the driver."""
from .config import CacheConfig, SimConfig
from .sim import VectorSim, run

__all__ = ["CacheConfig", "SimConfig", "VectorSim", "run"]
