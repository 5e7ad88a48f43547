"""Process-group bring-up and the communicator of a domain-decomposed run
(torch form of ``macroc_tpu/parallel/distributed.py``).

The reference initialises MPI (PetscInitialize, src/main.c:33); here
``maybe_initialize`` brings up a ``torch.distributed`` process group from
the environment the JAX package reads:

  MACROC_COORDINATOR    host:port of rank 0's rendezvous
  MACROC_NUM_PROCESSES  number of ranks
  MACROC_PROCESS_ID     this process's rank

With none of them set it does nothing and the run is one process.  The
backend is decided once, at init, by ``backend_for``: gloo on the CPU;
NCCL when every rank has a card of its own; gloo with ranks sharing cards
otherwise (NCCL refuses two ranks on one device).  Under gloo, CUDA
tensors travel through pinned host buffers: every kernel still runs on the
card, only the bytes between ranks cross the host.

``Comm`` is what the solver, the halo exchange and the diagnostics call:
all-reduces and the neighbour shift of one axis.  On one process every
reduction is the identity and every neighbour is missing.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

#: seconds a collective may wait for its peers before the run fails
TIMEOUT_S = 90


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def platform_from_env() -> str:
    """MACROC_PLATFORM: ``cuda`` (the default) or ``cpu``."""
    plat = os.environ.get("MACROC_PLATFORM", "cuda")
    if plat not in ("cuda", "cpu"):
        raise ValueError(f"MACROC_PLATFORM must be cuda or cpu, got {plat!r}")
    return plat


def backend_for(platform: str, world_size: int) -> str:
    """gloo on the CPU; NCCL when each of the ``world_size`` ranks has a
    card of its own; gloo when ranks share cards."""
    if platform == "cpu":
        return "gloo"
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: macroc_tpu_torch runs on the GPU by default; set "
            "MACROC_PLATFORM=cpu to run the plain PyTorch versions on the CPU"
        )
    return "nccl" if world_size <= torch.cuda.device_count() else "gloo"


def maybe_initialize(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialise the default process group when configured (arguments or
    the MACROC_* environment); returns True if this call did so.  A failed
    init raises: nothing falls back to one process."""
    coordinator = coordinator or os.environ.get("MACROC_COORDINATOR")
    if num_processes is None:
        num_processes = _env_int("MACROC_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("MACROC_PROCESS_ID")
    if coordinator is None and num_processes is None and process_id is None:
        return False
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError(
            "a multi-process run needs MACROC_COORDINATOR, MACROC_NUM_PROCESSES "
            "and MACROC_PROCESS_ID"
        )
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialised")
    platform = platform_from_env()
    backend = backend_for(platform, num_processes)
    if platform == "cuda":
        # before the group exists: NCCL binds its communicator to this card
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend,
        init_method=f"tcp://{coordinator}",
        world_size=num_processes,
        rank=process_id,
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
    )
    # one collective over every rank before any point-to-point traffic:
    # NCCL forms its communicator here, and a rank that cannot reach the
    # others fails now rather than inside the first halo exchange
    probe = torch.ones(1, device=local_device(platform) if backend == "nccl" else "cpu")
    dist.all_reduce(probe)
    if int(probe.item()) != num_processes:
        raise RuntimeError(f"rank count check gave {probe.item()}, want {num_processes}")
    return True


def shutdown() -> None:
    """Destroy the default process group, if any."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """Rank 0 (PetscPrintf semantics): the rank that logs and writes."""
    return rank() == 0


def local_device(platform: str) -> torch.device:
    """The rank's device: ``cuda:<rank % cards>`` (set as the current
    card), or ``cpu``."""
    if platform == "cpu":
        return torch.device("cpu")
    index = rank() % torch.cuda.device_count()
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


class Comm:
    """Collectives of one run on the tensors of ``device``.

    ``Comm(device)`` on one process (no process group) reduces nothing and
    has no neighbours.  ``staged`` (gloo with a CUDA device) moves every
    tensor through host memory before it reaches the backend."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.rank = rank()
        self.world = world()
        self.backend = dist.get_backend() if dist.is_initialized() else None
        self.staged = self.backend == "gloo" and self.device.type == "cuda"

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        """t as the backend takes it (a pinned host copy when staged)."""
        if not self.staged:
            return t.contiguous()
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        # a synchronous copy: the device has written t before gloo reads h
        h.copy_(t)
        return h

    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        if self.world == 1:
            return t
        buf = self._out(t)
        if buf is t:
            buf = t.clone()
        dist.all_reduce(buf, op=op)
        return buf.to(t.device)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """All-reduce SUM of a tensor of per-rank partial sums."""
        return self._reduce(t, dist.ReduceOp.SUM)

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """All-reduce MAX."""
        return self._reduce(t, dist.ReduceOp.MAX)

    def barrier(self) -> None:
        """Wait until every rank has reached this call (nothing on one
        process)."""
        if self.world > 1:
            dist.barrier()

    def gather(self, t: torch.Tensor) -> list:
        """Every rank's ``t`` (of one shape on all ranks), in rank order, as
        CPU tensors on every rank."""
        if self.world == 1:
            return [t.detach().cpu()]
        local = t.detach().contiguous()
        if self.backend == "gloo":
            local = local.cpu()
        parts = [torch.empty_like(local) for _ in range(self.world)]
        dist.all_gather(parts, local)
        return [p.cpu() for p in parts]

    def shift(
        self,
        to_lo: Optional[torch.Tensor],
        to_hi: Optional[torch.Tensor],
        lo: Optional[int],
        hi: Optional[int],
    ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """One axis of the rank grid: send ``to_lo`` to rank ``lo`` and
        ``to_hi`` to rank ``hi``; return (from_lo, from_hi), the lo
        neighbour's ``to_hi`` and the hi neighbour's ``to_lo``.  Every rank
        of the axis calls it with the same pattern: a None tensor carries
        nothing in its direction, and then nothing comes back the other
        way (None).  A missing neighbour (None rank: the global boundary)
        yields zeros, as ``lax.ppermute`` gives to a device no one sends
        to.  All sends and receives are posted before any is waited on."""
        ops, landed = [], []
        from_lo = from_hi = None
        for out, peer, src, tag in ((to_hi, hi, lo, 0), (to_lo, lo, hi, 1)):
            if out is None:
                continue
            got = torch.zeros(out.shape, dtype=out.dtype, device=out.device)
            if src is not None:
                buf = (torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
                       if self.staged else got)
                ops.append(dist.P2POp(dist.irecv, buf, src, tag=tag))
                landed.append((got, buf))
            if peer is not None:
                ops.append(dist.P2POp(dist.isend, self._out(out), peer, tag=tag))
            if tag == 0:
                from_lo = got
            else:
                from_hi = got
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
            for got, buf in landed:
                if buf is not got:
                    got.copy_(buf)
        return from_lo, from_hi
