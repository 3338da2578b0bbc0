"""One cell of the benchmark as a run sees it: its configuration, traffic,
seed and device, and the seeds derived from it."""

import zlib

import torch

__all__ = ["Cell", "sync"]


class Cell:
    """A workload entry resolved to its files."""

    def __init__(self, name, config, traffic, seed, device):
        self.name, self.config, self.traffic = name, config, traffic
        self.seed = int(seed)
        self.device = torch.device(device)

    def seed_of(self, what):
        """A seed of its own for each use (weights, inputs, draws, the
        sample of checked answers), fixed by the run's seed."""
        return (self.seed * 1000003 + zlib.crc32(what.encode())) % 2 ** 62


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
