from sbmc_tpu_torch.models.kpcn import KPCN  # noqa: F401
from sbmc_tpu_torch.models.lbf import LBF  # noqa: F401
from sbmc_tpu_torch.models.multisteps import Multisteps  # noqa: F401
