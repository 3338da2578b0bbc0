from sbmc_tpu_torch.nn.kernel_apply import (  # noqa: F401
    KernelApply,
    ProgressiveKernelApply,
    ProgressiveState,
    kernel_apply,
    progressive_init,
    progressive_kernel_apply,
)
from sbmc_tpu_torch.nn.layers import (  # noqa: F401
    Autoencoder,
    ConvChain,
    WNConv2D,
)
