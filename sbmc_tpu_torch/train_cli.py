"""Train a denoiser (counterpart of ``scripts/train.py``).

    python -m sbmc_tpu_torch.train DATA CKPT_DIR --bs 4 --spp 8
    python -m sbmc_tpu_torch.train DATA CKPT_DIR --bs 4 --kpcn_mode
    python -m sbmc_tpu_torch.train DATA CKPT_DIR --bs 4 --gather
    python -m sbmc_tpu_torch.train DATA CKPT_DIR --bs 4 --lbf_mode

The default model is SBMC (``Multisteps`` with splat kernels); ``--gather``
trains its gather-kernel ablation, ``--kpcn_mode`` the KPCN baseline on the
pixel statistics of the same tiles (constant sample count, no display
strip) and ``--lbf_mode`` the learned bilateral filter.

(the module is ``train_cli`` because ``sbmc_tpu_torch/train/`` is the
package of the training classes; ``python -m sbmc_tpu_torch.train`` runs
it). Flags mirror the JAX script. Variable-spp batches are padded and
masked to one shape. Runs on ``--device cuda`` unless told otherwise, and
raises when that device is missing. Checkpoints are written in the JAX
package's format, so either package resumes and denoises from them.

``--device_reservoir N`` holds N preprocessed tiles on the device and
draws every batch there (:mod:`sbmc_tpu_torch.train.reservoir`); with more
tiles than that, a background thread decodes the rest and one slot is
refreshed every ``--refresh_every`` steps. ``--kpcn_mode`` keeps the host
loader, as in the JAX script.

On several GPUs, one process each, started by torchrun::

    python -m torch.distributed.run --standalone --nproc_per_node N \
        -m sbmc_tpu_torch.train DATA CKPT_DIR --bs 4 --spp 8

Training is data-parallel (:mod:`sbmc_tpu_torch.parallel.mesh`): ``--bs``
is the batch of each process, as in the JAX script's multi-process branch,
so the global batch is ``bs x N``; each process reads its own equal shard
of the tiles; the logged metrics are the global batch's; only rank 0
writes the checkpoint, ``train_log.csv``, ``viz/`` and the progress lines;
validation runs whole on every rank; ``--device_reservoir`` is ignored
(the host loader feeds every rank).
"""

import argparse
import os

import numpy as np
import torch
import torch.distributed as dist

from sbmc_tpu_torch.data import Loader, MultiSampleCountDataset, TilesDataset
from sbmc_tpu_torch.models import KPCN, LBF, Multisteps
from sbmc_tpu_torch.models.build import model_meta
from sbmc_tpu_torch.parallel.mesh import init_distributed, is_main, shutdown
from sbmc_tpu_torch.train import (Checkpointer, DenoiserInterface, Trainer,
                                  callbacks)
from sbmc_tpu_torch.train.reservoir import DeviceReservoir, ReservoirFeeder
from sbmc_tpu_torch.utils.logging import get_logger, set_logger

__all__ = ["main", "parse_args", "cli"]


def main(args):
    """Train as ``args`` say; returns the interface (model, optimizer and
    step count) when training ends."""
    set_logger(args.verbose)
    log = get_logger("sbmc_tpu_torch.train")
    if args.kpcn_mode and args.lbf_mode:
        raise SystemExit("--kpcn_mode and --lbf_mode are mutually exclusive")
    rank, world, device = init_distributed(args.device)
    np.random.seed(0)
    torch.manual_seed(0)
    # Float32 stays float32: no TF32 in matmuls or cuDNN convolutions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    data_args = dict(
        spp=args.spp,
        mode=TilesDataset.KPCN_MODE if args.kpcn_mode
        else TilesDataset.SBMC_MODE,
        load_coords=not args.dont_use_coords,
        load_gbuffer=not args.dont_use_gbuffer,
        load_p=not args.dont_use_p,
        load_ld=not args.dont_use_ld,
        load_bt=not args.dont_use_bt,
    )

    pad_spp = None
    random_mask_spp = None
    if args.randomize_spp and not args.kpcn_mode:
        if args.cache_ram:
            # Cached mode: keep every tile at full spp (preprocessed once,
            # float16) and randomize the valid sample count per item via
            # the mask: masked samples contribute exactly zero.
            data = TilesDataset(args.data, cache_preprocessed=True,
                                **data_args)
            random_mask_spp = (2, args.spp)
        else:
            data = MultiSampleCountDataset(args.data, **data_args)
            pad_spp = args.spp
        log.info("Training with randomized sample count (2..%d, padded "
                 "+ masked to a single shape)", args.spp)
    else:
        data = TilesDataset(args.data, cache_preprocessed=args.cache_ram,
                            **data_args)
    log.info("Training dataset: %s", data)

    val_data = None
    if args.val_data:
        val_data = TilesDataset(args.val_data, **data_args)

    conv_dtype = "bfloat16" if args.bf16 else None
    if args.kpcn_mode:
        log.info("Model: KPCN (gather baseline, [Bako2017])")
        arch = "kpcn"
        model_params = dict(n_in=data.num_features, ksize=args.ksize,
                            depth=args.kpcn_depth, width=args.kpcn_width,
                            conv_dtype=conv_dtype)
        model = KPCN(**model_params)
    elif args.lbf_mode:
        log.info("Model: LBF (learned bilateral filter, [Kalantari2015])")
        arch = "lbf"
        model_params = dict(
            n_features=data.num_features,
            n_global_features=data.num_global_features,
            window_r=args.lbf_window_r, conv_dtype=conv_dtype)
        model = LBF(**model_params)
    else:
        log.info("Model: Multisteps (SBMC), splat=%s", not args.gather)
        arch = "sbmc"
        model_params = dict(
            n_features=data.num_features,
            n_global_features=data.num_global_features,
            ksize=args.ksize, splat=not args.gather, pixel=args.pixel,
            conv_dtype=conv_dtype, remat=args.remat)
        model = Multisteps(**model_params)
    interface = DenoiserInterface(model, lr=args.lr, device=device,
                                  distributed=dist.is_initialized())

    meta = model_meta(args.kpcn_mode, model_params, data_args, arch=arch)
    checkpointer = Checkpointer(args.checkpoint_dir,
                                meta=meta if is_main() else None)

    loader = Loader(data, batch_size=args.bs, shuffle=True, pad_spp=pad_spp,
                    num_threads=args.num_worker_threads,
                    shard_id=rank, num_shards=world,
                    random_mask_spp=random_mask_spp)
    if dist.is_initialized():
        log.info("Data-parallel: process %d of %d on %s, items %d::%d "
                 "(%d of %d), %d steps an epoch of %d x %d", rank, world,
                 device, rank, world, len(data) // world, len(data),
                 len(loader), world, args.bs)
    val_loader = None
    if val_data is not None:
        val_loader = Loader(val_data, batch_size=args.bs, shuffle=False,
                            num_threads=args.num_worker_threads)

    first = next(iter(loader))
    state, step = checkpointer.load_latest(interface.state_tree())
    if step is not None:
        interface.load_state_tree(state)
        log.info("Resumed from checkpoint step %s", step)

    # Every rank checkpoints (rank 0 writes, all wait for it); only rank 0
    # logs and draws.
    cbs = [callbacks.CheckpointingCallback(
        checkpointer, interface, interval_steps=args.checkpoint_interval)]
    if is_main():
        cbs += [
            callbacks.ProgressCallback(interval=args.log_interval),
            callbacks.ScalarLogCallback(
                os.path.join(args.checkpoint_dir, "train_log.csv"),
                interval=args.log_interval)]
        if not args.kpcn_mode:
            cbs.append(callbacks.DenoisingDisplayCallback(
                interface, lambda: first,
                os.path.join(args.checkpoint_dir, "viz")))
    trainer = Trainer(interface, cbs)
    if args.device_reservoir > 0 and not args.kpcn_mode and world == 1:
        _train_from_reservoir(args, log, trainer, interface, data,
                              val_loader)
    else:
        if args.device_reservoir > 0:
            log.info("--device_reservoir ignored (data-parallel processes "
                     "or kpcn mode keep the host loader)")
        trainer.train(loader, num_epochs=args.num_epochs,
                      val_dataloader=val_loader, max_steps=args.max_steps)
    return interface


def _train_from_reservoir(args, log, trainer, interface, data, val_loader):
    cap = min(args.device_reservoir, len(data))
    spp_range = (2, args.spp) if args.randomize_spp else None
    reservoir = DeviceReservoir(interface, capacity=cap, batch_size=args.bs,
                                spp_mask_range=spp_range)
    log.info("Device reservoir: %d tiles on %s, batches drawn on the device "
             "(spp mask range %s)", cap, interface.device, spp_range)
    reservoir.fill([data[i] for i in range(cap)])
    feeder = None
    if cap < len(data):
        feeder = ReservoirFeeder(data, depth=2).start()
    max_steps = args.max_steps
    if max_steps is None and args.num_epochs is not None:
        # The reservoir loop counts steps: --num_epochs becomes the steps
        # that many epochs of the host loader would take.
        max_steps = max(1, args.num_epochs * len(data) // args.bs)
        log.info("Reservoir: --num_epochs %d -> max_steps %d",
                 args.num_epochs, max_steps)
    trainer.train_reservoir(reservoir, feeder=feeder, max_steps=max_steps,
                            refresh_every=args.refresh_every,
                            val_dataloader=val_loader)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("data", help=".bin data folder or filelist .txt")
    parser.add_argument("checkpoint_dir", help="checkpoint output directory")
    parser.add_argument("--val_data", help="validation data folder")
    parser.add_argument("--num_epochs", type=int, default=None)
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--bs", type=int, default=1,
                        help="batch size of each process (under torchrun "
                        "the global batch is bs x processes)")
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--spp", type=int, default=8,
                        help="max samples per pixel")
    parser.add_argument("--ksize", type=int, default=21,
                        help="kernel size for the predicted kernels")
    parser.add_argument("--lbf_mode", action="store_true",
                        help="train the LBF learned-bilateral-filter "
                        "baseline [Kalantari2015] instead of SBMC")
    parser.add_argument("--lbf_window_r", type=int, default=8,
                        help="LBF filter window radius")
    parser.add_argument("--kpcn_mode", action="store_true",
                        help="train the [Bako2017] KPCN baseline")
    parser.add_argument("--kpcn_depth", type=int, default=9,
                        help="KPCN conv depth (valid convs consume a "
                        "4*depth pixel border)")
    parser.add_argument("--kpcn_width", type=int, default=100)
    parser.add_argument("--gather", action="store_true",
                        help="ablation: use gather kernels instead of splat")
    parser.add_argument("--pixel", action="store_true",
                        help="ablation: collapse samples to a 1-spp image")
    parser.add_argument("--constant_spp", dest="randomize_spp",
                        action="store_false", default=True,
                        help="disable randomized sample count")
    parser.add_argument("--dont_use_coords", action="store_true")
    parser.add_argument("--dont_use_gbuffer", action="store_true")
    parser.add_argument("--dont_use_p", action="store_true")
    parser.add_argument("--dont_use_ld", action="store_true")
    parser.add_argument("--dont_use_bt", action="store_true")
    parser.add_argument("--num_worker_threads", type=int, default=4)
    parser.add_argument("--device_reservoir", type=int, default=0,
                        help="hold this many preprocessed tiles on the "
                        "device and draw every batch there (no per-step "
                        "host stack and copy; SBMC and LBF, ignored with "
                        "--kpcn_mode). 0 disables.")
    parser.add_argument("--refresh_every", type=int, default=2,
                        help="with --device_reservoir and more tiles than "
                        "it holds: overwrite one slot with a freshly "
                        "decoded tile every N steps.")
    parser.add_argument("--trust_reservoir", action="store_true",
                        help="accepted no-op, as in the JAX script.")
    parser.add_argument("--trust_bf16", action="store_true",
                        help="accepted no-op, as in the JAX script.")
    parser.add_argument("--no_cache_ram", dest="cache_ram",
                        action="store_false", default=True,
                        help="disable the RAM cache of preprocessed tiles "
                        "(the cache makes the host-side work of epochs 2+ a "
                        "single array stack; disable on small-memory "
                        "hosts).")
    parser.add_argument("--log_interval", type=int, default=100)
    parser.add_argument("--checkpoint_interval", type=int, default=1000)
    parser.add_argument("--remat", action="store_true",
                        help="recompute conv activations in the backward "
                        "pass (larger batches at the cost of recompute)")
    parser.add_argument("--bf16", action="store_true",
                        help="run the conv stacks in bfloat16 (params and "
                        "the splat path stay float32)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (default: cuda).")
    parser.add_argument("--verbose", action="store_true")
    args = parser.parse_args(argv)
    if args.refresh_every < 1:
        parser.error("--refresh_every must be at least 1")
    return args


def cli(argv=None):
    """The command line: train, then leave the process group."""
    main(parse_args(argv))
    shutdown()


if __name__ == "__main__":
    cli()
