"""Multi-process initialization (larvanet_tpu/parallel/distributed.py).

One process drives every device of its mesh (parallel/mesh.py), so a
single host needs nothing here. Across processes, call
`init_distributed()` once per process before the first step: the
data-parallel train step (mesh.use_data_parallel) then all-reduces its
gradients and loss over the default process group after averaging them
over the process's own devices, and the directory checkpoints
(`--orbax_checkpoint`, models/base.py) are written by every process
together. NCCL carries the collectives between cards (one process per
card: NCCL refuses two ranks on one card), gloo between CPU processes.

Launch, one process per card:

    COORDINATOR=host0:29500 NUM_PROCESSES=4 PROCESS_ID=$i \\
        python my_trainer.py

The JAX package's auto-detection of a TPU pod's workers
(distributed.py:37-47) has no counterpart on the card: nothing on a card's
machine names its cluster, so the coordinator, the number of processes and
each one's id are given, by argument or environment.
"""

from __future__ import annotations

import os
from typing import Optional


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> bool:
    """Initialize torch.distributed's default process group from the
    arguments or the environment (COORDINATOR as host:port,
    NUM_PROCESSES, PROCESS_ID). Returns False, and does nothing, when no
    coordinator is configured: the caller's code is the same either way.
    `backend` defaults to NCCL where a card is visible, gloo otherwise."""
    import torch
    import torch.distributed as dist

    coordinator_address = coordinator_address or os.environ.get("COORDINATOR")
    if coordinator_address is None:
        return False
    # `x or env[...]` would be wrong for the process id: 0, the primary,
    # is falsy and would fall through to the environment
    if num_processes is None and os.environ.get("NUM_PROCESSES"):
        num_processes = os.environ["NUM_PROCESSES"]
    if process_id is None and os.environ.get("PROCESS_ID"):
        process_id = os.environ["PROCESS_ID"]
    if num_processes is None or process_id is None:
        raise ValueError("init_distributed: a coordinator (%s) needs the number of "
                         "processes and this process's id (NUM_PROCESSES, PROCESS_ID)"
                         % (coordinator_address,))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method="tcp://%s" % (coordinator_address,),
                            world_size=int(num_processes), rank=int(process_id))
    return True


def world_size() -> int:
    """The number of processes of the default group (1 without one)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def is_primary() -> bool:
    """True on the process that should write logs: rank 0, or the only
    process when no group is initialized."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0
