"""Multi-process initialisation: the port of parallel/distributed.py.

One process per rank, joined by ``torch.distributed.init_process_group``.
``maybe_initialize_distributed()`` runs at entry-point start on every rank
and is a no-op (False) when nothing names a cluster. It reads, in order:

- its arguments, else the JAX package's environment contract
  ``COORDINATOR_ADDRESS`` ("host:port", or an ``init_method`` URL such as
  ``file:///path``) / ``NUM_PROCESSES`` / ``PROCESS_ID``;
- else torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` /
  ``RANK`` (and ``LOCAL_RANK`` for the card), the environment a torch
  launcher sets as the JAX package's cluster auto-detection would.

The backend is NCCL for ``device="cuda"`` (the default) and gloo for the
CPU, unless the caller names one; NCCL asked for and missing raises. On
the card each rank takes ``LOCAL_RANK`` (else its rank) modulo the cards
in the machine as its device, so several gloo ranks may share one card.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

# the rendezvous and every collective give up after this long
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def _int_env(name: str) -> int | None:
    v = os.environ.get(name)
    return int(v) if v else None


def maybe_initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    device: torch.device | str | None = None,
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> bool:
    """Initialise the default process group from the arguments or the
    environment (module docstring); True if it ran (or had run)."""
    if dist.is_initialized():
        return True
    coordinator_address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS")
    num_processes = num_processes or _int_env("NUM_PROCESSES")
    if process_id is None:
        process_id = _int_env("PROCESS_ID")
    if coordinator_address is None and num_processes is None:
        if not all(k in os.environ for k in ("MASTER_ADDR", "WORLD_SIZE",
                                             "RANK")):
            return False
        init_method = "env://"
        num_processes, process_id = _int_env("WORLD_SIZE"), _int_env("RANK")
    else:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError(
                "maybe_initialize_distributed needs the coordinator address, "
                "the number of processes and this process's id together "
                f"(got {coordinator_address!r}, {num_processes!r}, "
                f"{process_id!r})")
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")

    device = torch.device(device or "cuda")
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("backend 'nccl' asked for, and this torch build "
                           "has no NCCL")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "maybe_initialize_distributed(device='cuda'): "
                "torch.cuda.is_available() is false; pass device='cpu'")
        local = _int_env("LOCAL_RANK")
        torch.cuda.set_device(device.index if device.index is not None else
                              (process_id if local is None else local)
                              % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id,
                            timeout=timeout)
    return True
