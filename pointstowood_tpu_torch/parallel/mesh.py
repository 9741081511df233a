"""Data parallelism over ``torch.distributed`` (port of
pointstowood_tpu/parallel/mesh.py).

The workload's parallelism is pure data parallelism over independent
voxel tiles: every process holds the same global host batch (the input
pipeline is seeded, so every process builds it alike), uploads only its
own contiguous rows (``shard_rows``), and runs the forward on them. The
contract is the JAX package's: a run of W processes with global batch B
computes what one process computes with batch B. In the JAX package
XLA's partitioner gives that for free; here the pieces that couple the
rows of a batch do it by hand:

* ``model.layers.MaskedBatchNorm`` all-reduces its masked batch
  statistics (and their gradients) over the group (``set_data_group``),
  summed in float64, so that the split does not change them;
* ``ops.sampling.random_sample`` draws the global batch's scores and
  keeps this process's rows, so every process picks the centres one
  process would pick;
* the loss divides by the global count of valid points, the trainer sums
  the gradients over the group in one flat bucket, and the reported loss
  and counts are the global ones;
* ``fetch`` gathers each batch's probabilities to every process, and
  only process 0 writes files.

One process per card: on CUDA ``maybe_init_distributed`` pins a process
to ``cuda:LOCAL_RANK`` before it joins the group.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from pointstowood_tpu_torch.utils.device import pin_cuda_device


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """The processes of a data-parallel run (the counterpart of the JAX
    package's 1-D ``('data',)`` mesh): this process's rank, their number,
    and the ``torch.distributed`` process group they share.
    ``DataGroup(0, 1, None)`` runs the data-parallel numerics (float64
    batch statistics, ``model.layers.MaskedBatchNorm``) in one process
    without ``torch.distributed``: what a run split over several processes
    reproduces."""

    rank: int
    world_size: int
    process_group: object


def _launch_env(n_cards: int):
    """(init_method, rank, world size, local rank) from the JAX package's
    variables (``PTW_COORDINATOR_ADDRESS=host:port``,
    ``PTW_NUM_PROCESSES``, ``PTW_PROCESS_ID``; the local rank defaults to
    the rank modulo ``n_cards``) or torchrun's (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), or None when
    neither set is present."""
    env = os.environ
    if "PTW_COORDINATOR_ADDRESS" in env:
        rank = int(env["PTW_PROCESS_ID"])
        local = int(env.get("LOCAL_RANK", rank % max(n_cards, 1)))
        return (f"tcp://{env['PTW_COORDINATOR_ADDRESS']}", rank,
                int(env["PTW_NUM_PROCESSES"]), local)
    if "MASTER_ADDR" in env and "WORLD_SIZE" in env and "RANK" in env:
        return ("env://", int(env["RANK"]), int(env["WORLD_SIZE"]),
                int(env.get("LOCAL_RANK", 0)))
    return None


def maybe_init_distributed(verbose: bool = False,
                           backend: str | None = None,
                           device=None) -> bool:
    """Env-gated bootstrap of the process group; True when the run has
    more than one process.

    Launch each process with the JAX package's variables

        PTW_COORDINATOR_ADDRESS=host:port PTW_NUM_PROCESSES=N PTW_PROCESS_ID=i

    or through ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT``). Without either set it returns
    False and changes nothing. Idempotent: a call after the group exists
    only reports it. ``device`` is the device the run computes on (the
    entry points' resolved device; CUDA by default, as
    ``utils.device.resolve_device``): on CUDA the process is pinned to
    ``cuda:LOCAL_RANK`` first (``LOCAL_RANK`` defaults to the rank modulo
    the host's card count under the ``PTW_*`` variables) and ``backend``
    defaults to NCCL; on the CPU nothing is pinned and it defaults to
    gloo. Both CLIs call it first thing in ``main``."""
    dev = torch.device("cuda" if device is None else device)
    on_cuda = dev.type == "cuda"
    if not dist.is_initialized():
        launch = _launch_env(torch.cuda.device_count() if on_cuda else 1)
        if launch is None:
            return False
        init_method, rank, world, local = launch
        if on_cuda:
            pin_cuda_device(local)
        dist.init_process_group(
            backend or ("nccl" if on_cuda else "gloo"),
            init_method=init_method, rank=rank, world_size=world)
    if verbose:
        where = f"cuda:{torch.cuda.current_device()}" if on_cuda else "cpu"
        print(f"distributed: process {dist.get_rank()}/"
              f"{dist.get_world_size()} backend={dist.get_backend()} "
              f"device={where}")
    return dist.get_world_size() > 1


def data_group() -> DataGroup | None:
    """The data-parallel group of every process of the run, or None for
    one process (the counterpart of ``data_mesh``, which returns None on
    one device)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return None
    return DataGroup(dist.get_rank(), dist.get_world_size(),
                     dist.group.WORLD)


def spans_processes(group: DataGroup | None) -> bool:
    """Whether ``group`` has more than one process (collectives to run)."""
    return group is not None and group.world_size > 1


def is_primary(group: DataGroup | None) -> bool:
    """Whether this process writes files: process 0, or the only one."""
    return group is None or group.rank == 0


def round_batch_size(batch_size: int, group: DataGroup | None) -> int:
    """The JAX package's rounding of a batch size to a multiple of the
    number of processes (``trainer.py:251-256``): down to the multiple,
    and at least one row per process."""
    if not spans_processes(group) or batch_size % group.world_size == 0:
        return batch_size
    w = group.world_size
    return max(w, (batch_size // w) * w)


def shard_rows(group: DataGroup | None, *arrays):
    """This process's rows ``[rank * B / W, (rank + 1) * B / W)`` of each
    global host batch array (the counterpart of ``put_sharded``); the
    arrays themselves for one process. Raises unless W divides B."""
    if not spans_processes(group):
        return arrays
    out = []
    for a in arrays:
        b = a.shape[0]
        if b % group.world_size:
            raise ValueError(f"a batch of {b} rows does not split over "
                             f"{group.world_size} processes")
        per = b // group.world_size
        out.append(a[group.rank * per:(group.rank + 1) * per])
    return tuple(out)


def fetch(group: DataGroup | None, tensor: torch.Tensor) -> torch.Tensor:
    """The global batch of ``tensor`` (this process's rows, split by
    ``shard_rows``) on every process: an all-gather along the leading
    dimension; the tensor itself for one process."""
    if not spans_processes(group):
        return tensor
    local = tensor.contiguous()
    out = local.new_empty((local.shape[0] * group.world_size,)
                          + tuple(local.shape[1:]))
    dist.all_gather_into_tensor(out, local, group=group.process_group)
    return out


def all_reduce_sum_(group: DataGroup | None, tensor: torch.Tensor):
    """Sum ``tensor`` over the group in place (nothing for one process);
    returns it."""
    if spans_processes(group):
        dist.all_reduce(tensor, group=group.process_group)
    return tensor

