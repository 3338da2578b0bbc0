"""Plain float32 PyTorch reference of the benchmarked models and of the
train step.

A frozen copy written for the benchmark: it imports nothing of the program
under test (``sbmc_tpu_torch``), of the JAX package or of JAX. Parameters
are a flat dict of float32 tensors under the reference's own names
(:mod:`benchmark.reference.names` maps them to the program's). Every
function takes an optional quantiser ``q`` that rounds a tensor before it
enters a convolution or a splat; the reference proper uses none. The
comparison also runs it with :func:`benchmark.reference.nn.bf16`, the
configuration's own rounding emulated, to measure how far rounding alone
moves a seed's answer; the control passes :func:`benchmark.reference.nn.fp8`
to compute the same model a precision below the configuration's.
"""
