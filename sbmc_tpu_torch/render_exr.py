"""Render a .pbrt scene to a .exr image with the external ``pbrt``.

    python -m sbmc_tpu_torch.render_exr PBRT SCENE.pbrt OUT.exr \\
        [--spp 8] [--width 512] [--height 512] [--tmp_dir DIR]

The port of ``scripts/render_exr.py``: prepends a path-integrator header
to the scene, runs ``pbrt`` in a temporary directory beside symlinks to
the scene's assets and moves its ``scene.exr`` to ``OUT.exr``. Host work
only; it touches no GPU.
"""

from sbmc_tpu_torch.rendering import PBRTRenderer, PBRTRenderingParser


def main(argv=None):
    args = PBRTRenderingParser(description=__doc__.split("\n")[0]).parse_args(
        argv)
    PBRTRenderer(args).render()
    return args


if __name__ == "__main__":
    main()
