"""Faults of a KPCN denoising cell: it keeps no state between samples and
takes one tile, so only an altered answer."""

from benchmark.tests.faults import alter_radiance


def _answer_altered(mp):
    from sbmc_tpu_torch.models import KPCN
    alter_radiance(mp, KPCN)


FAULTS = {"answer_altered": _answer_altered}
