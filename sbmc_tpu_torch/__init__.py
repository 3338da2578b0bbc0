"""sbmc_tpu_torch: the PyTorch/CUDA port of sbmc_tpu.

The port runs SBMC inference on an NVIDIA Hopper GPU. Its module tree mirrors
``sbmc_tpu`` so each counterpart is easy to find; it imports neither JAX nor
anything of ``sbmc_tpu``.

- ``ops``: the fused progressive splat, a hand-written CUDA kernel with its
  plain PyTorch version.
- ``nn``: weight-normalised conv stacks, the U-Net and the progressive kernel
  accumulator.
- ``models``: ``Multisteps`` and the meta-driven factory.
- ``params``/``train.checkpointer``: loading the JAX package's checkpoints.
- ``data``, ``parallel``, ``utils``: ``.bin`` IO, tiling and EXR output.
- ``denoise``: the inference entry point
  (``python -m sbmc_tpu_torch.denoise``); ``profile``: device time by
  kernel class.
"""

__version__ = "0.1.0"
