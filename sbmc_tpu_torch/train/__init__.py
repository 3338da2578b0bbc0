from sbmc_tpu_torch.train.checkpointer import Checkpointer  # noqa: F401
