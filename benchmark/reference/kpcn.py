"""Kernel-Predicting Convolutional Networks (Bako et al., SIGGRAPH 2017)
in plain float32 PyTorch.

Two chains of ``depth`` valid 5x5 convolutions (no weight normalisation)
predict gather logits for the diffuse and the specular buffers; softmax
over the taps, kernel application, and ``albedo * diffuse +
exp(specular) - 1``. The output loses a ``2 * depth`` border.
"""

import torch

from benchmark.reference.nn import chain, chain_leaves, gather_apply

__all__ = ["leaves", "forward"]

STREAMS = ("diffuse", "specular")


def leaves(cfg):
    m = cfg["model"]
    return [leaf for stream in STREAMS
            for leaf in chain_leaves(
                stream, m["n_in"], m["ksize"] ** 2, m["width"], m["depth"],
                5, "relu", "linear", weight_norm=False)]


def _center(t, h, w):
    dy, dx = (t.shape[-2] - h) // 2, (t.shape[-1] - w) // 2
    return t[..., dy:dy + h, dx:dx + w]


def forward(cfg, p, x, q=None):
    m = cfg["model"]

    def stream(name):
        lg = chain(x["kpcn_%s_in" % name].float(), p, name, m["depth"],
                   "relu", "linear", same=False, weight_norm=False, q=q)
        if q is not None:
            lg = q(lg)
        buf = _center(x["kpcn_%s_buffer" % name].float(), *lg.shape[-2:])
        return gather_apply(buf, lg, m["ksize"])

    diffuse, specular = map(stream, STREAMS)
    albedo = _center(x["kpcn_albedo"].float(), *diffuse.shape[-2:])
    return albedo * diffuse + (torch.exp(specular) - 1)
