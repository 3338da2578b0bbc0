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

Not ported yet, and refused rather than replaced by something else:
``--device_reservoir`` (with ``--refresh_every``, which only tunes it) and
training on several GPUs.
"""

import argparse
import os

import numpy as np
import torch

from sbmc_tpu_torch.data import Loader, MultiSampleCountDataset, TilesDataset
from sbmc_tpu_torch.models import KPCN, LBF, Multisteps
from sbmc_tpu_torch.models.build import model_meta
from sbmc_tpu_torch.train import (Checkpointer, DenoiserInterface, Trainer,
                                  callbacks)
from sbmc_tpu_torch.utils.logging import get_logger, set_logger

__all__ = ["main", "parse_args"]


def _refuse_unported(args):
    if args.device_reservoir > 0:
        raise NotImplementedError(
            "--device_reservoir is not ported yet (slice 2, the GPU-resident "
            "tile reservoir)")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError(
            "training on several GPUs is not ported yet (slice 2, "
            "data-parallel training)")


def main(args):
    """Train as ``args`` say; returns the interface (model, optimizer and
    step count) when training ends."""
    set_logger(args.verbose)
    log = get_logger("sbmc_tpu_torch.train")
    _refuse_unported(args)
    if args.kpcn_mode and args.lbf_mode:
        raise SystemExit("--kpcn_mode and --lbf_mode are mutually exclusive")
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
    interface = DenoiserInterface(model, lr=args.lr, device=args.device)

    meta = model_meta(args.kpcn_mode, model_params, data_args, arch=arch)
    checkpointer = Checkpointer(args.checkpoint_dir, meta=meta)

    loader = Loader(data, batch_size=args.bs, shuffle=True, pad_spp=pad_spp,
                    num_threads=args.num_worker_threads,
                    random_mask_spp=random_mask_spp)
    val_loader = None
    if val_data is not None:
        val_loader = Loader(val_data, batch_size=args.bs, shuffle=False,
                            num_threads=args.num_worker_threads)

    first = next(iter(loader))
    state, step = checkpointer.load_latest(interface.state_tree())
    if step is not None:
        interface.load_state_tree(state)
        log.info("Resumed from checkpoint step %s", step)

    cbs = [
        callbacks.ProgressCallback(interval=args.log_interval),
        callbacks.CheckpointingCallback(
            checkpointer, interface,
            interval_steps=args.checkpoint_interval),
        callbacks.ScalarLogCallback(
            os.path.join(args.checkpoint_dir, "train_log.csv"),
            interval=args.log_interval),
    ]
    if not args.kpcn_mode:
        cbs.append(callbacks.DenoisingDisplayCallback(
            interface, lambda: first,
            os.path.join(args.checkpoint_dir, "viz")))
    Trainer(interface, cbs).train(loader, num_epochs=args.num_epochs,
                                  val_dataloader=val_loader,
                                  max_steps=args.max_steps)
    return interface


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("data", help=".bin data folder or filelist .txt")
    parser.add_argument("checkpoint_dir", help="checkpoint output directory")
    parser.add_argument("--val_data", help="validation data folder")
    parser.add_argument("--num_epochs", type=int, default=None)
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--bs", type=int, default=1, help="batch size")
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
                        help="not ported yet (the GPU-resident tile "
                        "reservoir); "
                        "0 disables.")
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
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
