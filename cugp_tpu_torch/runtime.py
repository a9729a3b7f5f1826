"""Multi-process runtime bring-up, as ``cugp_tpu/runtime.py``.

``initialize`` starts ``torch.distributed`` (the counterpart of
``jax.distributed.initialize``) from explicit arguments, or from the
environment ``torchrun`` sets (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``/``MASTER_PORT``, ``LOCAL_RANK``); with neither, it is a
no-op and the process is a world of one. One rank drives one device: on
the card it sets ``torch.cuda.set_device(LOCAL_RANK % device_count)``.
The backend defaults to NCCL for the card and gloo for the CPU; a caller
may ask for gloo on the card (several ranks sharing one card, where NCCL
refuses two ranks on one device). There is no silent switch:
``device="cuda"`` without a card raises.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass
class RuntimeInfo:
    process_index: int
    process_count: int
    local_devices: int
    global_devices: int
    backend: str


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, device="cuda",
               backend=None, timeout: Optional[float] = None):
    """Bring up torch.distributed when running multi-process; no-op for
    one process.

    coordinator_address: "host:port" (a TCP store), or a URL that
    init_process_group takes ("tcp://...", "file:///path"); with
    num_processes and process_id. Without it, the torchrun environment
    (RANK and WORLD_SIZE set) initializes from env://. device: "cuda"
    (one card per rank, LOCAL_RANK % device_count) or "cpu". backend:
    "nccl" or "gloo"; None picks NCCL for "cuda", gloo for "cpu".
    timeout: seconds the group's joining and each of its collectives may
    wait for the other ranks before failing (None: torch's default).
    Returns RuntimeInfo; its backend is the process group's, or the
    device type for a world of one that initialized nothing.
    """
    device = torch.device(device).type
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("runtime.initialize(device='cuda'): no CUDA "
                               "device is available (pass device='cpu' to "
                               "run on the CPU)")
        local = int(os.environ.get("LOCAL_RANK", process_id or 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    if backend is None:
        backend = "nccl" if device == "cuda" else "gloo"
    explicit = coordinator_address is not None
    from_env = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    kw = ({} if timeout is None
          else {"timeout": datetime.timedelta(seconds=timeout)})
    if (explicit or from_env) and not dist.is_initialized():
        if explicit:
            url = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
            if num_processes is None or process_id is None:
                raise ValueError("an explicit coordinator_address needs "
                                 "num_processes and process_id")
            dist.init_process_group(backend, init_method=url,
                                    world_size=num_processes,
                                    rank=process_id, **kw)
        else:
            dist.init_process_group(backend, init_method="env://", **kw)
    if dist.is_initialized():
        count, index = dist.get_world_size(), dist.get_rank()
        used = dist.get_backend()
    else:
        count, index, used = 1, 0, device
    local_devices = torch.cuda.device_count() if device == "cuda" else 1
    return RuntimeInfo(process_index=index, process_count=count,
                       local_devices=local_devices, global_devices=count,
                       backend=used)
