"""The benchmarked models in plain float32 PyTorch, found by the
configuration's ``arch``: ``benchmark/reference/<arch>.py`` holds its
``leaves(cfg)`` and ``forward(cfg, p, x, q)``.

``leaves(cfg)`` lists each parameter as ``(name, shape, gain, kind)``,
``kind`` one of ``w``, ``g``, ``b``; ``gain`` is the initialiser's gain of
the layer's activation. ``forward`` runs the model on inputs ``x`` (a dict
of tensors with a batch axis) and returns its output radiance.
"""

import importlib

__all__ = ["leaves", "forward"]


def _arch(cfg):
    return importlib.import_module("benchmark.reference." + cfg["arch"])


def leaves(cfg):
    """The parameters of the configuration's model, in order."""
    return _arch(cfg).leaves(cfg)


def forward(cfg, p, x, q=None):
    """The configuration's model on inputs ``x``: its output radiance
    ``[bs, 3, h', w']``, less the border the model crops."""
    return _arch(cfg).forward(cfg, p, x, q)
