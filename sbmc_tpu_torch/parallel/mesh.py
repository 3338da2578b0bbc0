"""Data parallelism over processes and devices (counterpart of
``sbmc_tpu/parallel/mesh.py``).

The JAX package runs one program over a 1-D ``("data",)`` device mesh:
parameters replicated, the batch sharded on its leading axis, and XLA
inserts the gradient ``psum``. PyTorch's idiom is one process per device,
started by ``torchrun`` (``python -m torch.distributed.run``), a process
group joining them, and ``DistributedDataParallel`` (DDP) averaging the
gradients during the backward. What takes the place of each JAX helper:

- ``make_mesh`` and ``maybe_init_distributed``: :func:`init_distributed`.
  The process group is the mesh, one rank per device, and it is read from
  torchrun's environment. The JAX script's own ``SBMC_*`` variables are
  refused rather than ignored.
- ``data_sharding`` and ``shard_batch``: nothing. Each process loads its
  own shard of the items (``Loader(shard_id=rank, num_shards=world)``) and
  its own batch of ``--bs`` items. No global batch is ever split, so none
  can fail to divide.
- ``replicate``: DDP broadcasts rank 0's parameters when it wraps the
  model (training); :func:`replicas` copies a model onto each device
  (inference).
"""

import copy
import os

import torch
import torch.distributed as dist

from sbmc_tpu_torch.utils.device import resolve_device

__all__ = ["init_distributed", "shutdown", "is_main", "barrier", "all_mean",
           "replicas", "local_devices"]

#: What torchrun sets in each process it starts.
TORCHRUN_VARS = ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR",
                 "MASTER_PORT")
#: The JAX script's multi-host variables (sbmc_tpu/parallel/mesh.py).
JAX_VARS = ("SBMC_COORDINATOR", "SBMC_NUM_PROCESSES", "SBMC_PROCESS_ID")

TORCHRUN = ("python -m torch.distributed.run --nnodes NODES "
            "--nproc_per_node GPUS_PER_NODE --rdzv_backend c10d "
            "--rdzv_endpoint HOST:PORT -m sbmc_tpu_torch.train ...")


def init_distributed(device="cuda"):
    """Join the process group torchrun's environment describes; returns
    ``(rank, world_size, device)``.

    On ``cuda`` the process takes ``cuda:LOCAL_RANK`` and the NCCL backend,
    on ``cpu`` gloo. A process group that already exists is reused when its
    rank and size agree with the environment (a launcher may create it, as
    ``chip_smoke.py`` does for two ranks in gloo on one card). Without
    torchrun's environment: ``(0, 1, device)`` and no group. Raises when the
    JAX script's ``SBMC_*`` variables are set without torchrun's (the port
    never trains on one process when several were asked for), when the
    environment is incomplete, and when the local rank has no card."""
    env = os.environ
    dev = resolve_device(device)
    if "WORLD_SIZE" not in env:
        set_jax = [v for v in JAX_VARS if v in env]
        if set_jax:
            raise RuntimeError(
                "%s set, but the port starts its processes with torchrun: "
                "%s" % (", ".join(set_jax), TORCHRUN))
        return 0, 1, dev
    rank, world = int(env.get("RANK", -1)), int(env["WORLD_SIZE"])
    local = int(env.get("LOCAL_RANK", -1))
    if not (0 <= rank < world and local >= 0):
        raise RuntimeError("incomplete torchrun environment: RANK=%s "
                           "LOCAL_RANK=%s WORLD_SIZE=%s" % (
                               env.get("RANK"), env.get("LOCAL_RANK"),
                               env["WORLD_SIZE"]))
    if dev.type == "cuda":
        if local >= torch.cuda.device_count():
            raise RuntimeError("LOCAL_RANK %d but %d CUDA device(s)"
                               % (local, torch.cuda.device_count()))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        if (dist.get_rank(), dist.get_world_size()) != (rank, world):
            raise RuntimeError(
                "the process group is rank %d of %d, the environment says "
                "%d of %d" % (dist.get_rank(), dist.get_world_size(), rank,
                              world))
        return rank, world, dev
    missing = [v for v in TORCHRUN_VARS if v not in env]
    if missing:
        raise RuntimeError("incomplete torchrun environment: %s unset"
                           % ", ".join(missing))
    if dev.type == "cuda":
        dist.init_process_group("nccl", rank=rank, world_size=world,
                                device_id=dev)
    else:
        dist.init_process_group("gloo", rank=rank, world_size=world)
    return rank, world, dev


def shutdown():
    """Leave the process group, if the process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_main():
    """True in rank 0, and in a process outside any group: the one that
    writes checkpoints, logs and images."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier():
    """Wait for every rank (nothing to wait for outside a group)."""
    if dist.is_initialized():
        dist.barrier()


def all_mean(tensors):
    """The mean over the ranks of each 0-dim tensor in ``tensors``, as a
    list, in one all-reduce on their device; the tensors themselves outside
    a group."""
    if not dist.is_initialized():
        return list(tensors)
    flat = torch.stack([t.detach().float() for t in tensors])
    dist.all_reduce(flat)
    return list((flat / dist.get_world_size()).unbind())


def replicas(model, devices):
    """``model`` moved to ``devices[0]`` and a deep copy of it on each
    further device; a device named twice gets two copies, as two cards
    would hold two."""
    return [model.to(devices[0])] + [copy.deepcopy(model).to(d)
                                     for d in devices[1:]]


def local_devices(device, n=None):
    """The devices the denoise CLI spreads tiles over: on ``cuda`` the first
    ``n`` cards (default: every visible one; a card named by its index, as
    ``cuda:1``, alone), raising when ``n`` exceeds them (JAX's
    ``local_devices()[:n]`` would give fewer); on the CPU ``n`` replicas on
    the CPU (default 1), the counterpart of JAX's forced host devices."""
    dev = resolve_device(device)
    if n is not None and n < 1:
        raise ValueError("--num_devices must be at least 1, got %d" % n)
    if dev.type != "cuda":
        return [dev] * (n or 1)
    count = torch.cuda.device_count()
    if n is not None and n > count:
        raise ValueError("--num_devices %d but %d CUDA device(s) visible"
                         % (n, count))
    if dev.index is not None and n in (None, 1):
        return [dev]
    return [torch.device("cuda", i) for i in range(n or count)]
