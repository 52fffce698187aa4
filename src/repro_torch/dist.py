"""Process groups for the port's multi-device simulator.

The JAX package runs one program over a device mesh (``shard_map``).  The
port runs one process per rank, each with a device of its own, all
running the same program (SPMD) over ``torch.distributed``:

* :func:`init_rank` joins this process to its group.  It resolves and
  checks the rank's device, picks the backend from it (``nccl`` for
  ``cuda``, ``gloo`` for ``cpu``) unless the caller names one, and gives
  ``init_process_group`` a timeout, so a lost message fails instead of
  hanging.  Under ``torchrun`` it reads the rank and the world size from
  the environment (``env://``).
* :func:`spawn` starts ``nprocs`` ranks on this host with the ``spawn``
  start method, runs a function in each and returns every rank's
  result.  A rank that raises, dies or outlasts the timeout fails the
  whole call, and the other ranks are killed.
* :func:`world_size` and :func:`rank` read the default group: 1 and 0
  without one.

NCCL cannot hold two ranks on one GPU; :func:`init_rank` refuses that
with a message.  gloo can: several ranks may share one card over gloo,
which is how the one-card machine checks a real multi-rank
decomposition.  gloo's point-to-point operations read host memory, so
the sharded backend stages its halo slabs through host tensors on that
combination (``repro_torch.core.sharded``).  DTensor's collectives (the
functional collectives of ``torch.distributed._functional_collectives``)
crash a gloo rank on CUDA tensors, all but ``all_reduce``, though the
same collectives called directly run (torch 2.11 on the H100):
:func:`stage_through_host` routes them through host copies, and
``launch.mesh.make_mesh`` turns it on for a CUDA mesh over gloo.
"""
from __future__ import annotations

import datetime
import os
import pickle
import queue as queue_mod
import shutil
import socket
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .device import resolve_device

__all__ = ["init_rank", "spawn", "world_size", "rank", "check_devices",
           "stage_through_host", "DEFAULT_TIMEOUT_S"]

#: seconds a collective may wait for its peers before it fails
DEFAULT_TIMEOUT_S = 600


def world_size() -> int:
    """Ranks in the default process group; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank in the default process group; 0 without one."""
    return dist.get_rank() if dist.is_initialized() else 0


def check_devices(keys: Sequence[str]) -> None:
    """Raise unless NCCL can drive the ranks' devices: ``keys`` names each
    rank's device (host and card), rank by rank.  NCCL cannot put two
    ranks on one card."""
    seen = {}
    for r, k in enumerate(keys):
        if k in seen:
            raise RuntimeError(
                f"NCCL cannot hold two ranks on one GPU: ranks {seen[k]} "
                f"and {r} are both on {k}; give each rank a GPU of its own, "
                f"or share the card over backend='gloo'")
        seen[k] = r


def _card_key(dev: torch.device) -> str:
    return (f"{socket.gethostname()}:GPU "
            f"{torch.cuda.get_device_properties(dev).uuid}")


def init_rank(device=None, backend: Optional[str] = None, *,
              rank: Optional[int] = None, world_size: Optional[int] = None,
              init_method: str = "env://",
              timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join this process to the default process group; returns its device.

    Args:
        device: the rank's device: ``"cpu"``, ``"cuda:<i>"``, or
            ``"cuda"``/``None`` for ``cuda:$LOCAL_RANK`` (0 when unset).
            A CUDA device that does not exist raises.
        backend: ``"nccl"`` or ``"gloo"``; default ``nccl`` for a CUDA
            device, ``gloo`` for the CPU.
        rank, world_size: this rank and the group's size; ``None`` reads
            them from the environment (``torchrun``).
        init_method: the rendezvous, e.g. ``"env://"`` or
            ``"file:///path/to/store"``.
        timeout_s: how long a collective waits for its peers.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        resolve_device(dev)                 # raises without a GPU
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {dev} does not exist: this host has "
                f"{torch.cuda.device_count()} CUDA device(s)")
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device, got {dev}")
    dist.init_process_group(
        backend, init_method=init_method,
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    if backend == "nccl" and dist.get_world_size() > 1:
        # compare the ranks' cards over a gloo group: an NCCL collective
        # between two ranks of one card would fail only later, and less
        # clearly
        probe = dist.new_group(backend="gloo")
        keys: List[Optional[str]] = [None] * dist.get_world_size()
        dist.all_gather_object(keys, _card_key(dev), group=probe)
        dist.destroy_process_group(probe)
        check_devices(keys)
    return dev


def _rank_main(r: int, nprocs: int, fn: Callable, args: tuple, device,
               backend, init_method: str, timeout_s: float,
               results) -> None:
    """One rank of :func:`spawn`: report ``fn(*args)`` or the traceback.
    One intra-op thread: ranks share the host's cores, and the
    simulator's small eager ops run slower on several."""
    torch.set_num_threads(1)
    try:
        init_rank(device, backend, rank=r, world_size=nprocs,
                  init_method=init_method, timeout_s=timeout_s)
        out = fn(*args)
    except BaseException:
        results.put((r, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    # pickled here, by value: the queue's own pickler would hand tensors
    # over through shared memory that dies with this process
    results.put((r, True, pickle.dumps(out)))


def _rank_device(device, r: int) -> str:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return f"cuda:{r}"
    return str(d)


def spawn(fn: Callable, nprocs: int, args: tuple = (), *, device="cpu",
          backend: Optional[str] = None, init_method: Optional[str] = None,
          timeout_s: float = DEFAULT_TIMEOUT_S) -> List[Any]:
    """Run ``fn(*args)`` on ``nprocs`` new ranks of one process group on
    this host; returns the results in rank order.

    ``fn`` must be importable by a fresh interpreter (a module-level
    function), and its result picklable.  ``device`` applies to every
    rank, except that ``"cuda"`` gives rank ``r`` the card ``cuda:r``;
    ``backend`` is as :func:`init_rank`'s.  ``init_method`` defaults to a
    ``file://`` store in a new temporary directory, removed afterwards.
    Each rank runs one intra-op thread.  The ranks, and each of
    their collectives, get ``timeout_s`` seconds.  The first rank to
    raise, to die or to run out of time fails the call (RuntimeError or
    TimeoutError, with the rank's traceback), and every rank still
    running is killed."""
    ctx = mp.get_context("spawn")
    store_dir = None
    if init_method is None:
        store_dir = tempfile.mkdtemp(prefix="repro_torch_ranks_")
        init_method = "file://" + os.path.join(store_dir, "store")
    results = ctx.Queue()
    procs = [ctx.Process(
        target=_rank_main, name=f"rank {r}",
        args=(r, nprocs, fn, args, _rank_device(device, r), backend,
              init_method, timeout_s, results))
        for r in range(nprocs)]
    got = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while len(got) < nprocs:
            try:
                r, ok, val = results.get(timeout=0.2)
            except queue_mod.Empty:
                if time.monotonic() > deadline:
                    missing = sorted(set(range(nprocs)) - set(got))
                    raise TimeoutError(
                        f"ranks {missing} did not finish within "
                        f"{timeout_s} s") from None
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    # a failing rank posts its traceback before it exits:
                    # give the message a moment to arrive
                    try:
                        r, ok, val = results.get(timeout=2.0)
                    except queue_mod.Empty:
                        r, code = dead[0]
                        raise RuntimeError(
                            f"rank {r} died with exit code {code} and "
                            f"reported nothing") from None
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {r} of {nprocs} failed:\n{val}")
            got[r] = pickle.loads(val)
        for p in procs:
            p.join(timeout=60)
            if p.exitcode != 0:
                raise RuntimeError(f"{p.name} exited with code {p.exitcode} "
                                   f"after reporting its result")
    finally:
        for p in procs:
            if p.pid is None:           # never started
                continue
            if p.is_alive():
                p.kill()
            p.join()
        results.close()
        if store_dir is not None:
            shutil.rmtree(store_dir, ignore_errors=True)
    return [got[r] for r in range(nprocs)]


# ---------------------------------------------------------------------------
# functional collectives through host copies
# ---------------------------------------------------------------------------

#: the ``torch.library`` registrations of :func:`stage_through_host`, by
#: dispatch key
_STAGED = {}

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.SUM,
               "product": dist.ReduceOp.PRODUCT, "min": dist.ReduceOp.MIN,
               "max": dist.ReduceOp.MAX}


def _group(name):
    if isinstance(name, dist.ProcessGroup):
        return name
    return torch._C._distributed_c10d._resolve_process_group(name)


def _reduce(op: str):
    if op not in _REDUCE_OPS:
        raise NotImplementedError(f"reduce op {op!r} is not staged")
    return _REDUCE_OPS[op]


def _avg(t: torch.Tensor, op: str, n: int) -> torch.Tensor:
    return t / n if op == "avg" else t


def _host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t`` that the collective may overwrite."""
    return t.detach().to("cpu", copy=True).contiguous()


def _staged_all_gather(inp, group_size, group_name):
    h = _host(inp)
    out = h.new_empty((group_size * h.shape[0],) + tuple(h.shape[1:]))
    dist.all_gather_into_tensor(out, h, group=_group(group_name))
    return out.to(inp.device)


def _staged_reduce_scatter(inp, reduce_op, group_size, group_name):
    h = _host(inp)
    out = h.new_empty((h.shape[0] // group_size,) + tuple(h.shape[1:]))
    dist.reduce_scatter_tensor(out, h, op=_reduce(reduce_op),
                               group=_group(group_name))
    return _avg(out, reduce_op, group_size).to(inp.device)


def _staged_all_reduce(inp, reduce_op, group_name):
    pg = _group(group_name)
    h = _host(inp)
    dist.all_reduce(h, op=_reduce(reduce_op), group=pg)
    return _avg(h, reduce_op, pg.size()).to(inp.device)


def _staged_all_to_all(inp, output_split_sizes, input_split_sizes,
                       group_name):
    h = _host(inp)
    rows = sum(output_split_sizes) if output_split_sizes else h.shape[0]
    out = h.new_empty((rows,) + tuple(h.shape[1:]))
    dist.all_to_all_single(out, h, list(output_split_sizes) or None,
                           list(input_split_sizes) or None,
                           group=_group(group_name))
    return out.to(inp.device)


def stage_through_host(dispatch_key: str = "CUDA") -> None:
    """Run the functional collectives that DTensor's redistributions call
    (``_c10d_functional``: all-gather, reduce-scatter, all-reduce and
    all-to-all of one tensor) through host copies for tensors of
    ``dispatch_key``: each kernel copies its input to the host, runs the
    collective there with ``torch.distributed``'s own call on the copy,
    and copies the result back.  The result is ready when the kernel
    returns, so the later ``wait_tensor`` finds nothing to wait for.
    Idempotent; for this process only."""
    if dispatch_key in _STAGED:
        return
    lib = torch.library.Library("_c10d_functional", "IMPL")
    for op, fn in (("all_gather_into_tensor", _staged_all_gather),
                   ("reduce_scatter_tensor", _staged_reduce_scatter),
                   ("all_reduce", _staged_all_reduce),
                   ("all_to_all_single", _staged_all_to_all)):
        lib.impl(op, fn, dispatch_key)
    _STAGED[dispatch_key] = lib
