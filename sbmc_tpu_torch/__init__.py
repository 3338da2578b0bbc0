"""sbmc_tpu_torch: the PyTorch/CUDA port of sbmc_tpu.

The port denoises and trains on an NVIDIA Hopper GPU: the SBMC model and its
gather-kernel ablation, the KPCN baseline and the LBF learned bilateral
filter. Its module tree mirrors ``sbmc_tpu`` so each counterpart is easy to
find; it imports neither JAX nor anything of ``sbmc_tpu``.

- ``ops``: the differentiable splat/gather operators, each a hand-written
  CUDA kernel with its plain PyTorch version: ``progressive_splat_update``
  (the fused progressive splat and its two backward kernels),
  ``kernel_weighting`` (forward and weight-gradient kernels) and
  ``scatter2gather``.
- ``nn``: conv stacks (weight-normalised or plain, "same" or valid), the
  U-Net, ``kernel_apply`` and the progressive kernel accumulator.
- ``models``: ``Multisteps``, ``KPCN``, ``LBF`` and the meta-driven factory.
- ``params``/``train.checkpointer``: loading the JAX package's checkpoints.
- ``data``, ``parallel``, ``utils``: ``.bin`` IO, tiling and EXR output.
- ``train``, ``losses``, ``train_cli``: the training interface, loop and
  entry point (``python -m sbmc_tpu_torch.train``, with ``--kpcn_mode``,
  ``--lbf_mode`` and ``--gather``).
- ``denoise``: the inference entry point
  (``python -m sbmc_tpu_torch.denoise``); ``profile``: device time by
  kernel class.
- ``render`` and ``generate_training_data``: training data, from the
  wavefront path tracer on the card or, by default, from the procedural
  PBRT scenes of ``scene_generator`` rendered by an external ``pbrt``
  through ``rendering`` (``render_exr``, ``render_samples``); host work.
  ``pbrt_stand_ins`` holds test doubles for the two PBRT binaries.
"""

__version__ = "0.1.0"
