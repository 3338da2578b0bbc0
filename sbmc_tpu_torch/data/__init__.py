"""Host-side ``.bin`` tile IO, datasets and the batch loader (numpy
only)."""
from sbmc_tpu_torch.data.datasets import (  # noqa: F401
    FullImagesDataset,
    MultiSampleCountDataset,
    TilesDataset,
)
from sbmc_tpu_torch.data.loader import Loader, collate  # noqa: F401
