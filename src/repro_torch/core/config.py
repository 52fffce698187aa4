"""Configuration for the PyTorch port of the bufferless-NoC simulator.

A field-for-field copy of the JAX package's ``repro.core.config``: every
field name and default is the same, so a config carries across through
its field dict (``dataclasses.asdict``).  This module holds the message
types, packet lengths (paper Table 1) and latency/geometry knobs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["CacheConfig", "SimConfig", "paper_small", "paper_large_cache",
           "APP_NAMES", "FLITS_OF", "NUM_MSG_TYPES"]

# ---------------------------------------------------------------------------
# Message types (paper Table 1 + control messages implied by §3.3/§3.4).
# Values are stable: they appear inside int8/int32 device arrays.
# ---------------------------------------------------------------------------
MSG_REQ = 0       # remote L2 read request                        (1 flit)
MSG_RA = 1        # data reply carrying one L1 block              (4 flits)
MSG_NACK = 2      # trap reply: block not found at owner          (1 flit)
MSG_DA = 3        # directory lookup request                      (1 flit)
MSG_DR = 4        # directory reply (payload: owner or -1)        (1 flit)
MSG_DU = 5        # directory update (payload: owner or -1=del)   (1 flit)
MSG_WB = 6        # L1 victim write-back to its L2 home           (4 flits)
MSG_B2 = 7        # L2 block migration / replacement transfer     (16 flits)
MSG_MIG_ACK = 8   # migration installed at destination            (1 flit)
MSG_REQ_FWD = 9   # redirected request (paper's RR)               (1 flit)

NUM_MSG_TYPES = 10

#: packet length in flits, indexed by message type (paper Table 1: DA=1,
#: DR=1, RR=1, RA=4, B2=16; WB carries an L1 block like RA).
FLITS_OF = (1, 4, 1, 1, 1, 1, 4, 16, 1, 1)

# FSM states of a core (phase 1).
ST_IDLE = 0       # ready to consume the next trace address
ST_L1_WAIT = 1    # counting down the L1 miss penalty
ST_L2_WAIT = 2    # counting down the local-L2 hit latency
ST_WAIT_DIR = 3   # DA sent, waiting for DR
ST_WAIT_DATA = 4  # REQ sent to owner, waiting for RA / NACK
ST_WAIT_MEM = 5   # counting down the off-chip memory latency
ST_DONE = 6       # trace exhausted (keeps routing + serving remote requests)

# Port indices. The "directions" of a 2-D mesh router; EJECT/INJECT are
# virtual ports used only during arbitration.
PORT_N, PORT_E, PORT_S, PORT_W = 0, 1, 2, 3
NUM_PORTS = 4
EJECT = 4
INJECT_SLOT = 4   # index of the injection candidate in the arbitration list

# Memory-install targets (trap path installs to L1 only — DESIGN.md §2).
INSTALL_L2 = 0
INSTALL_L1_ONLY = 1


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Geometry of the per-node caches (paper Table 4 rows)."""

    l1_sets: int = 32
    l1_ways: int = 2
    l1_block: int = 32          # bytes (paper: 32B L1 lines)
    l2_sets: int = 32
    l2_ways: int = 2
    l2_block: int = 64          # bytes (paper: 64B L2 lines)

    @property
    def l1_shift(self) -> int:
        return self.l1_block.bit_length() - 1

    @property
    def l2_shift(self) -> int:
        return self.l2_block.bit_length() - 1


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Full simulator configuration.

    ``rows`` × ``cols`` is the simulated mesh; every other field mirrors a
    knob of the paper's simulator (§3, §6).
    """

    rows: int = 8
    cols: int = 8
    cache: CacheConfig = dataclasses.field(default_factory=CacheConfig)

    # Latencies (cycles).
    l1_miss_cycles: int = 2     # paper §7.1.1 "wait up to L1 miss cycle"
    l2_hit_cycles: int = 4
    mem_cycles: int = 80        # off-chip fetch (no flits routed — DESIGN §2)

    # Address space of the simulated machine. Directory ("location array",
    # paper §6.2.2) has 2**addr_bits / l2_block entries.
    addr_bits: int = 20

    # LSPD management.
    migration_enabled: bool = True
    migrate_threshold: int = 3  # consecutive remote hits by the same node
    fwd_entries: int = 4        # per-node forwarding table (redirection)
    centralized_directory: bool = True   # paper default; False = tag-home

    # Node plumbing.
    rob_slots: int = 8          # reorder-buffer packet slots per node
    send_queue: int = 64        # outbound flit-queue depth per node
    max_cycles: int = 200_000

    # Pending-completion queue (ejection guarantee — docs/architecture.md).
    # The paper's S14 uses a single pending-completion register that bars
    # ejection while occupied; combined with S14 handler backpressure this
    # can livelock whole (cfg, trace) combos (the ROADMAP 16x16/matmul
    # wedge).  pc_depth > 1 turns the register into a small FIFO queue:
    # an *occupied* (but not full) queue no longer bars ejection, and the
    # phase-1a handler drains from the queue head.  pc_depth=1 is the
    # compatibility escape hatch — bit-identical to the single-register
    # semantics.  (Structural: changes state shapes / compiled programs.)
    pc_depth: int = 4
    # Guaranteed-ejection age threshold: with a non-empty (but not full)
    # completion queue, only flits that have deflected at least this many
    # times are ejected into the spare capacity; younger flits still see
    # the paper-faithful ejection bar.  0 = always eject while a slot is
    # free.  (Traced per-scenario knob — rides as SimState.knob_ej_age.)
    # Default 0 measured by benchmarks/zoo_tune.py across the pattern/
    # hotspot/rates/wedge zoo (benchmarks/zoo_thresholds.json): every
    # (age, timeout) grid point completes every scenario, and the
    # ungated setting is uniformly fastest (1.3% mean cycles over the
    # previous age-8 default, 10x fewer recovered drops).
    eject_age_threshold: int = 0
    # Transaction timeout (pc_depth > 1 only): a node stuck in
    # WAIT_DIR/WAIT_DATA for this many cycles restarts its transaction
    # with a fresh DA to the tag's directory home.  This is the
    # retransmit-once-style recovery that makes the guaranteed drain
    # safe: a response the saturated handler had to drop (send_drop) is
    # simply re-requested, and stale duplicates fall into the existing
    # `stray` accounting.  Static (compiled constant), not a traced knob.
    req_timeout: int = 256

    # Progress monitors (driver-level, repro_torch.core.sim).  They never alter
    # the cycle-by-cycle semantics of a healthy run — they only stop a run
    # early with a diagnostic instead of burning the whole cycle budget.
    #
    # Livelock: abort when no *progress* statistic (anything but the
    # pure-motion counters hops/deflections) changes for this many
    # consecutive cycles while the run is unfinished.  None = auto
    # (max(512, 4*mem_cycles) — comfortably above the longest legitimate
    # quiet period, a machine-wide off-chip memory stall); 0 disables.
    livelock_window: Optional[int] = None
    # Directory saturation (the paper's node-0 hotspot): evaluated every
    # sat_window cycles on centralized-directory runs at >= 256 nodes;
    # fires when at least half the nodes sit in WAIT_DIR/WAIT_DATA while
    # fewer than num_nodes/2 references retired over the window.
    # 0 disables.
    sat_window: int = 1024

    # Simulator implementation knobs (do not change semantics).
    flit_dtype: str = "int32"
    dir_layout: str = "flat"   # "flat" | "home" (home = sharded with nodes)
    # Kept only so configs carry across from the JAX package; it has no
    # effect here.  On CUDA the Phase-2 arbitration always runs the
    # hand-written kernel (repro_torch.kernels.router_phase), on the CPU
    # always its plain PyTorch version.
    use_pallas_router: bool = False
    # Storage layout of SimState (repro_torch.core.state.leaf_dtypes):
    #   "wide"   — every leaf is int32 (the historical layout).
    #   "packed" — each leaf gets the smallest of int8/int16/int32 that
    #              holds its validated value bounds (FSM states and flags
    #              in int8, tags/ids/addresses in int16 where addr_bits /
    #              num_nodes / max_cycles permit).  All phases still
    #              compute in int32 — state is widened on load and
    #              narrowed on store at the cycle boundary — so semantics
    #              and serial golden-model bit-parity are unchanged.
    #              Packet ids then wrap at 2**14 instead of 2**30
    #              (mirrored in the serial model), which is aliasing-free
    #              while in-flight packets per source stay below 16384.
    #              (Structural: changes buffer dtypes / compiled programs.)
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
        """Modulus of the per-source packet-id counter.  The wide layout
        keeps the historical 2**30; the packed layout wraps at 2**14 so
        packet ids fit int16 state (unique while in-flight packets per
        source stay below 16384 — far beyond ROB/queue capacity)."""
        return (1 << 14) if self.state_dtype_policy == "packed" else (1 << 30)

    def dir_home(self, tag: int) -> int:
        """Node id owning the directory entry for ``tag``."""
        if self.centralized_directory:
            return 0
        return tag % self.num_nodes

    def validate(self) -> None:
        assert self.rows >= 2 and self.cols >= 2, "mesh must be at least 2x2"
        assert self.cache.l2_block % self.cache.l1_block == 0
        assert self.migrate_threshold >= 1
        assert self.rob_slots >= 2
        assert self.pc_depth >= 1, "pending-completion queue needs >= 1 slot"
        assert self.eject_age_threshold >= 0
        assert self.req_timeout >= 1
        if self.state_dtype_policy not in ("wide", "packed"):
            raise ValueError(
                f"state_dtype_policy must be 'wide' or 'packed', got "
                f"{self.state_dtype_policy!r}")
        if self.state_dtype_policy == "packed":
            # l2_streak is stored int16 with a saturating narrow at 32767;
            # every threshold comparison is then exact iff the threshold
            # itself stays below the saturation point.
            if self.migrate_threshold > 32766:
                raise ValueError(
                    "packed state layout stores migration streaks in int16 "
                    f"(saturating at 32767); migrate_threshold="
                    f"{self.migrate_threshold} would make threshold "
                    "comparisons inexact — use the wide layout")
            if self.addr_bits > 30:
                raise ValueError(
                    "packed state layout needs addresses (and their "
                    f"packet-id headroom) inside int32; addr_bits="
                    f"{self.addr_bits} > 30")


# Paper presets -------------------------------------------------------------

def paper_small() -> SimConfig:
    """Table 4 row 3/4 cache geometry (32,2,32 / 32,2,32)."""
    return SimConfig(cache=CacheConfig(32, 2, 32, 32, 2, 32 * 2))


def paper_large_cache() -> SimConfig:
    """Table 4 row 1 geometry (L1 128,4,32; L2 512,8,64)."""
    return SimConfig(cache=CacheConfig(128, 4, 32, 512, 8, 64))


APP_NAMES = ("matmul", "apsi", "mgrid", "wupwise", "equake")
