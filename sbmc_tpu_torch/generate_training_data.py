"""Render a training corpus with the wavefront path tracer.

    python -m sbmc_tpu_torch.generate_training_data - - assets OUT \\
        --renderer wavefront --count 2 --width 256 --height 256 \\
        --tile_size 128 --spp 8 --gt_spp 512 --obj_dir assets/objs \\
        --tex_dir assets/textures --env_dir assets/envmaps

The port of ``scripts/generate_training_data.py``'s wavefront branch, with
that script's arguments. Worker ``--worker_id`` of ``--num_workers``
renders scenes ``i = --start_index + s * --num_workers + --worker_id`` for
``s < --count``, so that the workers' scenes are disjoint (the JAX script
renders ``--start_index + --worker_id + s``, which overlaps between workers:
the same scenes at one worker). Scene ``i`` is drawn from
``RandomState(i)`` and traced from ``PRNGKey(i)`` into
``OUT/scene_%05d/tile_%04d_%04d.bin``, as the JAX package writes it. Runs
on ``--device cuda`` unless told otherwise, and raises when that device is
missing. ``--renderer pbrt`` (the default, as in the script) raises
``NotImplementedError``: the scene generator and the PBRT drivers are not
ported yet (ROADMAP.md, Queue 1 item 10).
"""

import argparse
import logging
import os

from sbmc_tpu_torch.utils.device import resolve_device

LOG = logging.getLogger("sbmc_tpu_torch.datagen")


def main(args):
    """Render ``args.count`` scenes (1 when it is not positive); returns
    the phase seconds of ``generate_wavefront_dataset`` and the scene
    count."""
    if args.width % args.tile_size or args.height % args.tile_size:
        raise ValueError("Block size should divide width and height.")
    if args.renderer != "wavefront":
        raise NotImplementedError(
            "--renderer pbrt needs the procedural scene generator and the "
            "PBRT drivers, which the port does not have yet (ROADMAP.md, "
            "Queue 1 item 10); use --renderer wavefront")
    from sbmc_tpu_torch.render import assets, pathtracer
    device = resolve_device(args.device)
    count = args.count if args.count > 0 else 1
    LOG.info("Wavefront renderer: %d scenes at %dx%d, %d spp (gt %d) on %s",
             count, args.width, args.height, args.spp, args.gt_spp, device)
    pools = {}
    for name, cls, folder in (("obj_pool", assets.ObjPool, args.obj_dir),
                              ("tex_pool", assets.TexturePool, args.tex_dir),
                              ("env_pool", assets.EnvmapPool, args.env_dir)):
        if folder:
            pools[name] = cls(folder)
            LOG.info("%s: %d files from %s", cls.__name__, len(pools[name]),
                     folder)
    stats = {}
    pathtracer.generate_wavefront_dataset(
        args.output, n_scenes=count, ts=args.tile_size,
        tiles_per_side=args.width // args.tile_size,
        tiles_y=args.height // args.tile_size, spp=args.spp,
        gt_spp=args.gt_spp, start_index=args.start_index + args.worker_id,
        stride=max(args.num_workers, 1), seed=0, kpcn_mode=args.kpcn_data,
        device=device, stats=stats, **pools)
    print("wavefront datagen: %d scenes in %.2f s (%.2f s/scene): device "
          "%.2f s, compile %.2f s, host %.2f s, write %.2f s, sample %.2f s"
          % (count, stats["total"], stats["total"] / count, stats["device"],
             stats["compile"], stats["host"], stats["write"],
             stats["sample"]), flush=True)
    return stats, count


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("pbrt_exe", help="path to the `pbrt` executable "
                        "(ignored with --renderer wavefront; pass '-').")
    parser.add_argument("obj2pbrt_exe",
                        help="path to PBRT's `obj2pbrt` executable "
                        "(ignored with --renderer wavefront; pass '-').")
    parser.add_argument("--renderer", default="pbrt",
                        choices=["pbrt", "wavefront"],
                        help="'pbrt': external instrumented renderer (not "
                        "ported yet); 'wavefront': the built-in path tracer.")
    parser.add_argument("--tex_dir", type=str, default=None,
                        help="directory of image textures (png/exr) "
                        "randomly assigned to materials and the ground.")
    parser.add_argument("--env_dir", type=str, default=None,
                        help="directory of equirect HDR envmaps (exr/png) "
                        "randomly substituted for the procedural sky lobes.")
    parser.add_argument("--obj_dir", type=str, default=None,
                        help="directory of .obj meshes to ingest as props.")
    parser.add_argument("--kpcn_data", action="store_true", default=False,
                        help="record with the PathKPCNIntegrator "
                        "conventions (unnormalized distances/probabilities).")
    parser.add_argument("assets", help="path to the assets to use.")
    parser.add_argument("output")
    parser.add_argument("--start_index", type=int, default=0)
    parser.add_argument("--worker_id", type=int, default=0)
    parser.add_argument("--num_workers", type=int, default=1)
    parser.add_argument("--threads", type=int,
                        default=max((os.cpu_count() or 2) // 2, 1))
    parser.add_argument("--count", type=int, default=-1,
                        help="scenes to generate per worker (-1: one)")
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--verbose", action="store_true", default=False)
    parser.add_argument("--generators", nargs="+",
                        default=["OutdoorSceneGenerator"])
    parser.add_argument("--suncg_root", type=str, default=None)
    parser.add_argument("--spp", type=int, default=32)
    parser.add_argument("--gt_spp", type=int, default=512)
    parser.add_argument("--width", type=int, default=512)
    parser.add_argument("--height", type=int, default=512)
    parser.add_argument("--path_depth", type=int, default=5)
    parser.add_argument("--tile_size", type=int, default=128)
    parser.add_argument("--no-clean", dest="clean", action="store_false",
                        default=True)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to render on (default: cuda).")
    return parser.parse_args(argv)


if __name__ == "__main__":
    _args = parse_args()
    logging.basicConfig(level=logging.DEBUG if _args.verbose
                        else logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    main(_args)
