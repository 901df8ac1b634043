"""Process groups and device meshes for data-parallel and observation-sharded
runs (port of ``macvo_tpu/parallel/mesh.py``).

The JAX package builds a ``jax.sharding.Mesh`` over every device of a
process and lets XLA insert the collectives of a sharded program. PyTorch has
neither of those: here one process drives one device (``torchrun`` or
:func:`torch.multiprocessing.spawn` starts them), :func:`init_distributed`
joins them into a ``torch.distributed`` process group, and the code that
needs a collective writes its ``all_reduce`` / ``all_gather`` itself (the
sharded solve's normal equations, the data-parallel step's gradients and
global-batch statistics). :func:`make_mesh` returns the matching
``DeviceMesh`` for callers that want named axes, and :func:`replicated` /
:func:`sharded` the ``torch.distributed.tensor`` placements that stand for
``P()`` and ``P(axis)``.

The backend is ``nccl`` on the card and ``gloo`` on the CPU. A failing NCCL
init raises: nothing drops to ``gloo`` or to one process.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

#: how long a collective (and the rendezvous) may wait before it raises
DEFAULT_TIMEOUT = datetime.timedelta(seconds=120)


def backend_for(device: torch.device | str) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, backend: Optional[str] = None,
                     device: torch.device | str = "cuda",
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> None:
    """Join this process to the default process group: a no-op for a single
    process, as ``jax.distributed.initialize`` is skipped there.
    ``coordinator`` is ``host:port`` (``tcp://`` optional); without it the
    ``MASTER_ADDR`` / ``MASTER_PORT`` of ``torchrun`` are used. ``backend``
    defaults to :func:`backend_for` ``device``; with ``nccl`` this process
    takes the card of its local rank."""
    if num_processes is None or num_processes <= 1:
        return
    join_group(coordinator, num_processes, process_id, backend, device, timeout)


def join_group(coordinator: Optional[str], num_processes: int, process_id: int, backend: Optional[str] = None,
               device: torch.device | str = "cuda", timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> None:
    """:func:`init_distributed` without its single-process shortcut: a group
    of one process is made too (a world-size-1 NCCL group on one card)."""
    backend = backend or backend_for(device)
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", process_id or 0)) % torch.cuda.device_count())
    init_method = None
    if coordinator:
        init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend=backend, init_method=init_method, world_size=num_processes,
                            rank=process_id, timeout=timeout)


def world() -> tuple[int, int]:
    """(rank, world size) of the default group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(axis_sizes: Optional[Sequence[int]] = None, axis_names: Sequence[str] = ("data",),
              device: torch.device | str = "cuda"):
    """``DeviceMesh`` over the default group's ranks, one device a rank:
    1-D ``data`` over every rank by default, or e.g. ``(2, 2), ("data", "obs")``."""
    from torch.distributed.device_mesh import init_device_mesh

    _, size = world()
    if axis_sizes is None:
        axis_sizes = (size,)
    return init_device_mesh(torch.device(device).type, tuple(int(s) for s in axis_sizes),
                            mesh_dim_names=tuple(axis_names))


def replicated(mesh=None):
    """The placement of a tensor every rank holds whole (JAX's ``P()``)."""
    from torch.distributed.tensor import Replicate

    return Replicate()


def sharded(mesh, *axes: Optional[str]):
    """One placement a mesh dimension: ``Shard(0)`` along each named axis,
    ``Replicate()`` along the others (JAX's ``P(axis)`` over dim 0)."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names or ()
    return [Shard(0) if name in axes else Replicate() for name in names]


def free_port() -> int:
    """A free TCP port on 127.0.0.1 for a group's rendezvous."""
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _group_worker(rank: int, size: int, port: int, device_type: str, fn, args: tuple, out_dir: str) -> None:
    if device_type == "cpu":
        torch.set_num_threads(2)
    join_group(f"127.0.0.1:{port}", size, rank, device=device_type)
    try:
        device = torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda" else torch.device("cpu")
        try:
            result = fn(rank, size, device, *args)
        except BaseException as exc:
            with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
                f.write(repr(exc))
            raise
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
        # rank 0 hosts the rendezvous store: no rank may leave while another still talks to it
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_group(fn, nprocs: int, args: tuple = (), device: torch.device | str = "cuda",
                timeout_s: float = DEFAULT_TIMEOUT.total_seconds()) -> list:
    """Start ``nprocs`` processes joined in one group on 127.0.0.1 (``nccl``
    on the cards, one a process; ``gloo`` on the CPU), call
    ``fn(rank, size, device, *args)`` in each (``fn`` importable by name),
    and return what each returned, in rank order. Raises (with every rank's
    own error) if a process fails, or if the group outlives ``timeout_s``;
    every process is gone on return."""
    import tempfile
    import time

    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    device_type = torch.device(device).type
    with tempfile.TemporaryDirectory() as out_dir:
        procs = mp.start_processes(_group_worker, args=(nprocs, free_port(), device_type, fn, args, out_dir),
                                   nprocs=nprocs, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not procs.join(timeout=max(0.1, min(2.0, deadline - time.monotonic()))):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{nprocs} processes of {fn.__name__} still running after {timeout_s} s")
        except ProcessException as exc:
            # the first process to end names its own error; another rank's may be the cause
            errors = {r: open(os.path.join(out_dir, f"rank{r}.err")).read() for r in range(nprocs)
                      if os.path.exists(os.path.join(out_dir, f"rank{r}.err"))}
            raise RuntimeError(f"{fn.__name__} failed in ranks {sorted(errors)}: {errors}") from exc
        finally:
            for p in procs.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False) for r in range(nprocs)]
