"""One rank of a data-parallel run of the port on the CPU, in gloo.

    python tests/torch_rank_worker.py SPEC RANK WORLD STORE OUT

Joins a group of WORLD ranks through a ``FileStore`` at STORE (no port to
pick, so runs in parallel never collide), then trains the model SPEC (a
pickle this package's tests wrote) describes with
``DenoiserInterface(distributed=True)``: each global batch of SPEC is cut
into WORLD contiguous shards, as the JAX mesh's ``data_sharding`` cuts it,
and this rank takes shard RANK. Writes the metrics of every step and, after
the last, the gradients, Adam's state and the parameters (flat, in the flax
layout) to OUT. With ``"trainer"`` in SPEC the steps run through
``Trainer.train``, whose finite-loss guard raises; a SPEC of ``{"jobs":
[...]}`` runs each job in turn, each with a model of its own, and writes
their results as a list. Imports no JAX.
"""

import os
import pickle
import sys

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from sbmc_tpu_torch.models.build import build_model  # noqa: E402
from sbmc_tpu_torch.parallel.mesh import init_distributed  # noqa: E402
from sbmc_tpu_torch.params import (export_adam_state,  # noqa: E402
                                   export_jax_params, flatten,
                                   load_jax_params)
from sbmc_tpu_torch.train import DenoiserInterface, Trainer  # noqa: E402


def shard(batch, rank, world):
    """Items ``[rank * n, (rank + 1) * n)`` of every array, n = bs / world."""
    out = {}
    for k, v in batch.items():
        n = len(v) // world
        out[k] = v[rank * n:(rank + 1) * n]
    return out


def grads_of(model):
    """The gradients, flat, in the flax layout of the parameters."""
    saved = [p.detach().clone() for p in model.parameters()]
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(p.grad)
    flat = flatten(export_jax_params(model)["params"])
    with torch.no_grad():
        for p, s in zip(model.parameters(), saved):
            p.copy_(s)
    return flat


def main(spec_path, rank, world, store_path, out_path):
    torch.set_num_threads(1)
    rank, world = int(rank), int(world)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    os.environ.update(RANK=str(rank), LOCAL_RANK="0", WORLD_SIZE=str(world))
    got = init_distributed("cpu")
    assert got[:2] == (rank, world), got
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    if "jobs" in spec:
        out = [run(job, rank, world) for job in spec["jobs"]]
    else:
        out = run(spec, rank, world)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def run(spec, rank, world):
    model = build_model({"arch": spec["arch"], "model_params": spec["model"]})
    load_jax_params(model, spec["params"])
    iface = DenoiserInterface(model, lr=spec["lr"], device="cpu",
                              distributed=True)
    batches = [shard(b, rank, world) for b in spec["batches"]]
    metrics = []
    if spec.get("trainer"):
        Trainer(iface).train(batches, num_epochs=1)
    else:
        for b in batches:
            m = iface.train_step(b)
            metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "grads": grads_of(model),
            "opt": flatten(export_adam_state(model, iface.optimizer)),
            "params": flatten(export_jax_params(model)["params"]),
            "step": iface.step}


if __name__ == "__main__":
    main(*sys.argv[1:])
