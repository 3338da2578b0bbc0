from sbmc_tpu_torch.models.multisteps import Multisteps  # noqa: F401
