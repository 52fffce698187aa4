"""The benchmark's fixed arithmetic: peaks, Phase 2's bytes, the trace's
reduction and the comparison that decides ``correct``.

Later changes to the program change none of this.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from .reference.state import (NUM_F, NUM_P, NUM_Q, NUM_R, NUM_STATS,
                              leaf_dtypes)

HERE = Path(__file__).resolve().parent


def peaks(device_name: str) -> Optional[Dict[str, float]]:
    """The card's published peaks (``peaks.json``), or ``None`` for a card
    the table does not hold."""
    with open(HERE / "peaks.json") as f:
        table = json.load(f)
    return table.get(device_name)


def phase2_bytes(cfg, trace_len: int) -> int:
    """Bytes Phase 2 must move in one cycle of one scenario, each read or
    written once, at the storage types of the configuration's layout.

    Read: each router's four input flits, its ROB and pending-completion
    queue, the head descriptor of its send queue and the queue's head,
    size and flit cursor; the statistics and the ejection knob.  Written:
    the four outgoing flits, the queue's three words, one byte for the
    ejected port, and the statistics.  The routers' ids, rows, columns and
    links follow from their index and are not counted."""
    dt = leaf_dtypes(cfg, trace_len)
    b = {k: v.itemsize for k, v in dt.items()}
    queue = b["q_head"] + b["q_size"] + b["q_fid"]
    flits = 4 * NUM_F * b["inp"]
    read = (flits + cfg.rob_slots * NUM_R * b["rob"]
            + cfg.pc_depth * NUM_P * b["pc"] + NUM_Q * b["q_desc"] + queue)
    written = flits + queue + 1
    return cfg.num_nodes * (read + written) + 2 * NUM_STATS * 4 + 4


def union_seconds(intervals: Sequence[Tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals, in their unit."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def idle_gaps(intervals: Sequence[Tuple[float, float]]
              ) -> List[Tuple[float, float]]:
    """The gaps between the union's pieces, ``(start, end)``."""
    out, end = [], None
    for a, b in sorted(intervals):
        if end is not None and a > end:
            out.append((end, a))
        end = b if end is None else max(end, b)
    return out


def compare(got: Sequence[Optional[Dict]], want: Sequence[Dict]
            ) -> Tuple[int, int]:
    """``(mismatches, failed scenarios)``: the statistics of each scenario
    (every counter, ``cycles``, ``finished`` and any abort record) against
    the reference's; a missing scenario counts every key of the
    reference's as a mismatch."""
    mism = failed = 0
    for b, w in enumerate(want):
        g = got[b] if b < len(got) else None
        if g is None:
            mism += len(w)
            failed += 1
            continue
        bad = sum(g.get(k) != w.get(k) for k in set(g) | set(w))
        mism += bad
        failed += bad > 0
    return mism, failed
