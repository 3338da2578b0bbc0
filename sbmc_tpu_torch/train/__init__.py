from sbmc_tpu_torch.train.checkpointer import Checkpointer  # noqa: F401
from sbmc_tpu_torch.train.interface import DenoiserInterface  # noqa: F401
from sbmc_tpu_torch.train.trainer import Trainer  # noqa: F401
from sbmc_tpu_torch.train import callbacks  # noqa: F401
