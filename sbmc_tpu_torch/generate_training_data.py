"""Procedural training-data synthesis: the PBRT scene swarm, or the
wavefront path tracer.

    python -m sbmc_tpu_torch.generate_training_data PBRT OBJ2PBRT ASSETS OUT \\
        --count 2 --threads 2
    python -m sbmc_tpu_torch.generate_training_data - - assets OUT \\
        --renderer wavefront --count 2 --width 256 --height 256 \\
        --tile_size 128 --spp 8 --gt_spp 512 --obj_dir assets/objs \\
        --tex_dir assets/textures --env_dir assets/envmaps

The port of ``scripts/generate_training_data.py``, with that script's
arguments.

``--renderer pbrt`` (the default) runs two pools of ``--threads`` worker
processes joined by queues: scene synthesizers draw scene ``idx`` from
``np.random.seed(idx)`` (a random resolution scale in {1, 2, 4, 8} cropped
back to ``--width`` x ``--height``, then one of ``--generators``) and write
``OUT/<host>_<time>_<uuid>/scene.pbrt`` with its converted geometry
(``OBJ2PBRT``, PBRT's converter); renderers run the instrumented ``PBRT``
in that folder, delete the folder when it wrote no ``.bin`` tile, and
without ``--no-clean`` keep only the tiles. Asset lists come from
``ASSETS/envmaps.txt``, ``textures.txt`` and ``models.txt``. Worker
``--worker_id`` of ``--num_workers`` makes scenes ``idx = --start_index +
s * --num_workers + --worker_id``; ``--count -1`` runs forever. The scene
files are the JAX script's byte for byte but for the ``uuid4`` ids, and
unlike its workers (pool initializers that never return) the port's end
once ``--count`` scenes are done. This branch is host work and external
processes only: it touches no GPU and imports no torch.

``--renderer wavefront`` renders scenes ``i = --start_index + s *
--num_workers + --worker_id`` for ``s < --count`` (so that the workers'
scenes are disjoint; the JAX script renders ``--start_index + --worker_id +
s``, which overlaps between workers: the same scenes at one worker). Scene
``i`` is drawn from ``RandomState(i)`` and traced from ``PRNGKey(i)`` into
``OUT/scene_%05d/tile_%04d_%04d.bin``, as the JAX package writes it. Runs
on ``--device cuda`` unless told otherwise, and raises when that device is
missing.
"""

import argparse
import multiprocessing
import os
import shutil
import subprocess
import time
import uuid

import numpy as np

from sbmc_tpu_torch.utils.logging import get_logger, set_logger

LOG = get_logger("sbmc_tpu_torch.datagen")

MAX_SCENE_ATTEMPTS = 20


def _validate_render(path):
    """A render is valid iff it produced at least one .bin tile."""
    return any(f.endswith(".bin") for f in os.listdir(path))


def _clean_bin_folder(path):
    """Delete everything but the .bin tiles (scene file, geometry, links)."""
    for f in os.listdir(path):
        f = os.path.join(path, f)
        if os.path.splitext(f)[-1] == ".bin":
            continue
        if os.path.islink(f) or os.path.isfile(f):
            os.remove(f)
        elif os.path.isdir(f):
            shutil.rmtree(f)


def _random_dirname():
    """Host + timestamp + uuid so distributed workers never collide."""
    return "%s_%s_%s" % (os.uname()[1],
                         time.strftime("%Y-%m-%d-%H%M%S", time.localtime()),
                         str(uuid.uuid4())[:8])


class GeneratorParams:
    """Resolved asset lists + instantiated scene generators."""

    def __init__(self, args):
        from sbmc_tpu_torch import scene_generator as scenegen
        self.working_dir = os.getcwd()
        self.output = args.output
        self.converter = os.path.abspath(args.obj2pbrt_exe)
        self.renderer = os.path.abspath(args.pbrt_exe)

        assets = os.path.abspath(args.assets)
        if not os.path.exists(assets):
            LOG.warning("No valid assets folder provided.")
        self.envmaps = self._filelist(os.path.join(assets, "envmaps.txt"))
        self.textures = self._filelist(os.path.join(assets, "textures.txt"))
        self.models = self._filelist(os.path.join(assets, "models.txt"))
        LOG.debug("Assets: %d envmaps, %d textures, %d models",
                  len(self.envmaps), len(self.textures), len(self.models))

        self.gen = []
        for name in args.generators:
            cls = getattr(scenegen, name, None)
            if cls is None:
                raise RuntimeError("Unknown generator `%s`" % name)
            extra = ()
            if cls is scenegen.SunCGSceneGenerator:
                # Legacy indoor generator; needs the (withdrawn) SunCG
                # distribution on disk.
                if not getattr(args, "suncg_root", None):
                    raise RuntimeError(
                        "SunCGSceneGenerator requires --suncg_root")
                extra = (os.path.abspath(args.suncg_root),)
            self.gen.append(cls(self.envmaps, self.textures, self.models,
                                self.converter, *extra))

    @staticmethod
    def _filelist(listpath):
        if not os.path.exists(listpath):
            return []
        root = os.path.dirname(listpath)
        out = []
        with open(listpath) as fid:
            for line in fid:
                path = os.path.join(root, line.strip()).replace("./", "")
                if os.path.exists(path):
                    out.append(path)
        return out


def synthesize(data):
    """Draw scene ``data["idx"]`` and write its folder; returns the folder,
    or None when the scene could not be made (the folder may stay, as in
    the JAX script)."""
    from sbmc_tpu_torch import scene_generator as scenegen
    idx = data["idx"]
    params = data["gen_params"]
    rparams = dict(data["render_params"])
    np.random.seed(idx)

    dst_dir = os.path.abspath(os.path.join(params.output, _random_dirname()))
    try:
        os.makedirs(os.path.join(dst_dir, "geometry"), exist_ok=True)
    except OSError as e:
        LOG.warning("Could not setup %s: %s", dst_dir, e)
        return None

    # Render at a random resolution multiple, cropped back to the target
    # size so object scale statistics vary.
    scale = int(np.random.choice([1, 2, 4, 8]))
    rparams["random_crop_w"] = rparams["width"]
    rparams["random_crop_h"] = rparams["height"]
    rparams["width"] = rparams["width"] * scale
    rparams["height"] = rparams["height"] * scale

    scn = scenegen.Scene(renderer=scenegen.Renderer(**rparams))
    try:
        gen = np.random.choice(params.gen)
        for _ in range(MAX_SCENE_ATTEMPTS):
            if gen.sample(scn, dst_dir):
                break
            LOG.warning("Sampling another Scene %s", gen)
        else:
            LOG.warning("Could not generate scene %d, skipping", idx)
            return None
    except Exception as e:
        LOG.warning("Scene sampling failed: %s, continuing", e)
        return None

    try:
        with open(os.path.join(dst_dir, "scene.pbrt"), "w") as fid:
            fid.write(scn.pbrt())
    except OSError:
        LOG.error("Failed to save .pbrt file, continuing")
        return None
    return dst_dir


def render_scene(data):
    """Run pbrt in ``data["scene_dir"]``, validate, clean; True when the
    scene left ``.bin`` tiles."""
    params = data["gen_params"]
    dst_dir = data["scene_dir"]
    LOG.info("Rendering scene '%s'", dst_dir)
    try:
        stderr = None if data["verbose"] else subprocess.DEVNULL
        subprocess.check_output([params.renderer, "scene.pbrt"],
                                stderr=stderr, cwd=dst_dir)
    except Exception as e:
        LOG.warning("Rendering failed for scene %s: %s", dst_dir, e)
        return False

    if not _validate_render(dst_dir):
        LOG.warning("Render did not complete properly, deleting %s", dst_dir)
        shutil.rmtree(dst_dir)
        return False

    if data["clean"]:
        _clean_bin_folder(dst_dir)
    LOG.info("Finished rendering scene #%d", data["idx"])
    return True


def create_scene_file(q, render_queue, done):
    """Scene-synthesis worker: ends at a None item."""
    while True:
        data = q.get(block=True)
        if data is None:
            q.task_done()
            return
        t0 = time.perf_counter()
        dst_dir = synthesize(data)
        seconds = time.perf_counter() - t0
        if dst_dir is None:
            done.put({"idx": data["idx"], "ok": False,
                      "synthesis_s": seconds, "render_s": 0.0})
        else:
            render_queue.put({"idx": data["idx"],
                              "gen_params": data["gen_params"],
                              "scene_dir": dst_dir,
                              "verbose": data["verbose"],
                              "clean": data["clean"],
                              "synthesis_s": seconds}, block=False)
        q.task_done()


def render(render_queue, done):
    """Render worker: ends at a None item."""
    while True:
        data = render_queue.get(block=True)
        if data is None:
            render_queue.task_done()
            return
        t0 = time.perf_counter()
        ok = render_scene(data)
        done.put({"idx": data["idx"], "ok": ok, "scene_dir": data["scene_dir"],
                  "synthesis_s": data["synthesis_s"],
                  "render_s": time.perf_counter() - t0})
        render_queue.task_done()


def render_params(args):
    """The ``scene_generator.Renderer`` arguments of the CLI's ``args``."""
    return dict(spp=args.spp, gt_spp=args.gt_spp, height=args.height,
                width=args.width, path_depth=args.path_depth,
                tile_size=args.tile_size)


def _pbrt_main(args):
    """The PBRT branch; returns one record a scene (``idx``, ``ok``,
    ``scene_dir``, ``synthesis_s``, ``render_s``)."""
    LOG.info("Starting job on worker %d of %d with %d threads",
             args.worker_id, args.num_workers, args.threads)
    gen_params = GeneratorParams(args)

    # fork, as the JAX script's pools do: this process has not touched a
    # GPU, and the workers need nothing re-imported.
    ctx = multiprocessing.get_context("fork")
    scene_queue, render_queue = ctx.JoinableQueue(), ctx.JoinableQueue()
    done = ctx.Queue()
    synths = [ctx.Process(target=create_scene_file,
                          args=(scene_queue, render_queue, done))
              for _ in range(args.threads)]
    renders = [ctx.Process(target=render, args=(render_queue, done))
               for _ in range(args.threads)]
    for p in synths + renders:
        p.start()

    records = []
    t0 = time.perf_counter()
    try:
        count = 0
        while True:
            queued = 0
            for _ in range(min(args.batch_size, max(args.count, 1))):
                if args.count > 0 and count == args.count:
                    break
                # Deterministic per-scene seed, sharded across workers.
                idx = (args.start_index + count * args.num_workers
                       + args.worker_id)
                scene_queue.put({"idx": idx, "gen_params": gen_params,
                                 "render_params": render_params(args),
                                 "verbose": args.verbose,
                                 "clean": args.clean}, block=False)
                count += 1
                queued += 1
            scene_queue.join()
            render_queue.join()
            records += [done.get() for _ in range(queued)]
            if args.count > 0 and count == args.count:
                break
        for q, workers in ((scene_queue, synths), (render_queue, renders)):
            for _ in workers:
                q.put(None)
            for p in workers:
                p.join()
    finally:
        for p in synths + renders:
            if p.is_alive():
                p.terminate()
                p.join()
    wall = time.perf_counter() - t0
    ok = [r for r in records if r["ok"]]
    n = max(len(records), 1)
    print("pbrt datagen: %d of %d scenes rendered in %.2f s with %d "
          "threads; per scene: synthesis %.3f s, render %.3f s"
          % (len(ok), len(records), wall, args.threads,
             sum(r["synthesis_s"] for r in records) / n,
             sum(r["render_s"] for r in records) / n), flush=True)
    return records


def _wavefront_main(args):
    """Render ``args.count`` scenes (1 when it is not positive); returns
    the phase seconds of ``generate_wavefront_dataset`` and the scene
    count."""
    from sbmc_tpu_torch.render import assets, pathtracer
    from sbmc_tpu_torch.utils.device import resolve_device
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


def main(args):
    """``--renderer pbrt``: the scene records of :func:`_pbrt_main`;
    ``--renderer wavefront``: the stats and scene count of
    :func:`_wavefront_main`."""
    set_logger(args.verbose)
    if args.width % args.tile_size or args.height % args.tile_size:
        raise ValueError("Block size should divide width and height.")
    if args.renderer == "wavefront":
        return _wavefront_main(args)
    return _pbrt_main(args)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("pbrt_exe", help="path to the `pbrt` executable "
                        "(ignored with --renderer wavefront; pass '-').")
    parser.add_argument("obj2pbrt_exe",
                        help="path to PBRT's `obj2pbrt` executable "
                        "(ignored with --renderer wavefront; pass '-').")
    parser.add_argument("--renderer", default="pbrt",
                        choices=["pbrt", "wavefront"],
                        help="'pbrt': external instrumented renderer; "
                        "'wavefront': the built-in path tracer.")
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
                        help="scenes to generate per worker (-1: forever "
                        "with --renderer pbrt, one with wavefront)")
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--verbose", action="store_true", default=False)
    parser.add_argument("--generators", nargs="+",
                        default=["OutdoorSceneGenerator"])
    parser.add_argument("--suncg_root", type=str, default=None,
                        help="root of a SunCG distribution (only needed "
                        "for the legacy SunCGSceneGenerator).")
    parser.add_argument("--spp", type=int, default=32)
    parser.add_argument("--gt_spp", type=int, default=512)
    parser.add_argument("--width", type=int, default=512)
    parser.add_argument("--height", type=int, default=512)
    parser.add_argument("--path_depth", type=int, default=5)
    parser.add_argument("--tile_size", type=int, default=128)
    parser.add_argument("--no-clean", dest="clean", action="store_false",
                        default=True)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to render on with --renderer "
                        "wavefront (default: cuda); --renderer pbrt runs on "
                        "the host and ignores it.")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
