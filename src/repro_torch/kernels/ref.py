"""Plain PyTorch versions of the port's kernels.

``arbitrate_ref`` is the semantic definition of the paper's Phase-2 router
arbitration (age-priority sort + PMDR port selection + deflection), the
counterpart of the JAX package's ``repro.kernels.ref.arbitrate_ref``.  On
the CPU the simulator calls it directly; on CUDA the hand-written kernel
in :mod:`repro_torch.kernels.router_phase` runs instead and must match it
bit for bit.

``random_arb_case`` makes seeded arbitration inputs with numpy, so the
kernel can be held against this version without the test suite.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

I32 = torch.int32


def arbitrate_ref(age: torch.Tensor, valid: torch.Tensor, we: torch.Tensor,
                  dc: torch.Tensor, dr: torch.Tensor,
                  vp: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Age-priority greedy port assignment for all routers at once.

    Args:
      age:   (N, S) int32 candidate flit ages (S=5: 4 input ports +
             injection).
      valid: (N, S) bool candidate present.
      we:    (N, S) bool candidate wanted to eject but was refused.
      dc:    (N, S) int32 dst_col - col (sign gives the desired X direction).
      dr:    (N, S) int32 dst_row - row.
      vp:    (N, 4) bool port physically exists (mesh edges).

    Returns:
      assigned: (N, S) int32 port index in 0..3, or -1 for invalid
                candidates.
      deflect:  (N, S) bool — candidate did not get its first preference
                (or had been refused ejection).
    """
    n, s_ = age.shape
    dev = age.device
    ports = torch.arange(4, dtype=I32, device=dev)
    slot = torch.arange(s_, dtype=I32, device=dev)

    # priority key: age desc, slot asc (injection = last slot, loses ties)
    key = torch.where(valid, age * 8 + (s_ + 2 - slot), -1)

    # PMDR preference scores (S9): lower = preferred.  A desired direction
    # only scores if the port exists.
    score = (10 + ports).expand(n, s_, 4).clone()
    score[:, :, 1] = torch.where(dc > 0, 0, score[:, :, 1])
    score[:, :, 3] = torch.where(dc < 0, 0, score[:, :, 3])
    score[:, :, 2] = torch.where(dr > 0, 1, score[:, :, 2])
    score[:, :, 0] = torch.where(dr < 0, 1, score[:, :, 0])
    score = torch.where(vp[:, None, :], score, 1000)
    first_pref = torch.argmin(score, dim=2)

    taken = torch.zeros((n, 4), dtype=torch.bool, device=dev)
    done = ~valid
    assigned = torch.full((n, s_), -1, dtype=I32, device=dev)
    deflect = torch.zeros((n, s_), dtype=torch.bool, device=dev)
    for _ in range(s_):
        kk = torch.where(done, -1, key)
        best = torch.argmax(kk, dim=1)          # first index of the max
        has = kk.amax(dim=1) >= 0
        bscore = torch.take_along_dim(score, best[:, None, None], dim=1)[:, 0]
        eff = bscore + taken.to(I32) * 10000
        port = torch.argmin(eff, dim=1)         # ties -> lowest port
        onehot_b = (slot[None, :] == best[:, None]) & has[:, None]
        onehot_p = (ports[None, :] == port[:, None]) & has[:, None]
        assigned = torch.where(onehot_b, port[:, None].to(I32), assigned)
        fp = torch.take_along_dim(first_pref, best[:, None], dim=1)[:, 0]
        wej = torch.take_along_dim(we, best[:, None], dim=1)[:, 0]
        defl = wej | (port != fp)
        deflect = torch.where(onehot_b, defl[:, None], deflect)
        taken = taken | onehot_p
        done = done | onehot_b
    return assigned, deflect


def random_arb_case(rng: np.random.Generator, n: int):
    """Seeded arbitration inputs for ``n`` routers, as numpy arrays:
    ``(age, valid, we, dc, dr, vp)`` with the bufferless invariant (no
    router has more candidates than existing ports)."""
    age = rng.integers(0, 64, (n, 5)).astype(np.int32)
    vp = rng.random((n, 4)) < 0.85
    vp |= np.sum(vp, 1, keepdims=True) == 0
    valid = rng.random((n, 5)) < 0.6
    # bufferless invariant: candidates <= valid ports
    for i in range(n):
        nv = int(vp[i].sum())
        idx = np.where(valid[i])[0]
        for j in idx[nv:]:
            valid[i, j] = False
    we = (rng.random((n, 5)) < 0.2) & valid
    dc = rng.integers(-3, 4, (n, 5)).astype(np.int32)
    dr = rng.integers(-3, 4, (n, 5)).astype(np.int32)
    return age, valid, we, dc, dr, vp
