"""Render the per-sample ``.bin`` tiles of a .pbrt scene with the
instrumented ``pbrt``.

    python -m sbmc_tpu_torch.render_samples PBRT SCENE.pbrt OUT_DIR \\
        [--spp 8] [--gt_spp 512] [--tile_size 128] [--tmp_dir DIR]

The port of ``scripts/render_samples.py``: prepends the sample-recording
renderer's header to the scene, runs ``pbrt`` in ``TMP_DIR/bin`` and moves
the ``.bin`` tiles it writes there into ``OUT_DIR``. Host work only; it
touches no GPU.
"""

from sbmc_tpu_torch.rendering import (PBRTSamplesRenderer,
                                      SamplesRenderingParser)


def main(argv=None):
    args = SamplesRenderingParser(
        description=__doc__.split("\n")[0]).parse_args(argv)
    PBRTSamplesRenderer(args).render()
    return args


if __name__ == "__main__":
    main()
