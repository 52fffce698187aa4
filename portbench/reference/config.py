"""The simulated machine's configuration and the protocol's constants.

A frozen copy of the port's ``core/config.py``: the same field names and
defaults, so a configuration file's fields read the same on both sides.
Message types, packet lengths (paper Table 1), FSM states and ports.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

MSG_REQ, MSG_RA, MSG_NACK, MSG_DA, MSG_DR, MSG_DU = 0, 1, 2, 3, 4, 5
MSG_WB, MSG_B2, MSG_MIG_ACK, MSG_REQ_FWD = 6, 7, 8, 9
NUM_MSG_TYPES = 10
#: packet length in flits, by message type
FLITS_OF = (1, 4, 1, 1, 1, 1, 4, 16, 1, 1)

ST_IDLE, ST_L1_WAIT, ST_L2_WAIT, ST_WAIT_DIR = 0, 1, 2, 3
ST_WAIT_DATA, ST_WAIT_MEM, ST_DONE = 4, 5, 6

NUM_PORTS = 4
INSTALL_L2, INSTALL_L1_ONLY = 0, 1


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Per-node cache geometry (paper Table 4)."""

    l1_sets: int = 32
    l1_ways: int = 2
    l1_block: int = 32
    l2_sets: int = 32
    l2_ways: int = 2
    l2_block: int = 64

    @property
    def l1_shift(self) -> int:
        return self.l1_block.bit_length() - 1

    @property
    def l2_shift(self) -> int:
        return self.l2_block.bit_length() - 1


@dataclasses.dataclass(frozen=True)
class Config:
    """The simulated machine: mesh, caches, latencies, policies."""

    rows: int = 8
    cols: int = 8
    cache: CacheConfig = dataclasses.field(default_factory=CacheConfig)
    l1_miss_cycles: int = 2
    l2_hit_cycles: int = 4
    mem_cycles: int = 80
    addr_bits: int = 20
    migration_enabled: bool = True
    migrate_threshold: int = 3
    fwd_entries: int = 4
    centralized_directory: bool = True
    rob_slots: int = 8
    send_queue: int = 64
    max_cycles: int = 200_000
    pc_depth: int = 4
    eject_age_threshold: int = 0
    req_timeout: int = 256
    livelock_window: Optional[int] = None
    sat_window: int = 1024
    flit_dtype: str = "int32"
    dir_layout: str = "flat"
    use_pallas_router: bool = False
    state_dtype_policy: str = "wide"

    @property
    def num_nodes(self) -> int:
        return self.rows * self.cols

    @property
    def livelock_window_effective(self) -> int:
        if self.livelock_window is None:
            return max(512, 4 * self.mem_cycles)
        return self.livelock_window

    @property
    def dir_entries(self) -> int:
        return (1 << self.addr_bits) >> self.cache.l2_shift

    @property
    def pkt_wrap(self) -> int:
        """Modulus of the per-source packet ids: 2**14 under the packed
        layout (int16 state), 2**30 under the wide one."""
        return (1 << 14) if self.state_dtype_policy == "packed" else (1 << 30)


#: the fields of :class:`Config`, for reading a configuration file
FIELDS = tuple(f.name for f in dataclasses.fields(Config))


def from_fields(fields: Dict[str, Any]) -> Config:
    """A :class:`Config` from a configuration file's field dict (the
    cache geometry as a nested dict); unknown keys raise."""
    fields = dict(fields)
    unknown = set(fields) - set(FIELDS)
    if unknown:
        raise ValueError(f"unknown configuration fields {sorted(unknown)}")
    if "cache" in fields:
        fields["cache"] = CacheConfig(**fields["cache"])
    return Config(**fields)
