"""Sample-based kernel splatting (Gharbi et al., SIGGRAPH 2019) in plain
float32 PyTorch.

``nsteps`` rounds of a per-sample 1x1 embedding chain (its input: the
sample's features and, in the first round, the global features, later the
previous round's propagated pixel features) and a U-Net on the samples'
masked mean; then a per-sample 1x1 regressor from ``[embedding,
propagated]`` to ``ksize**2`` splat logits (clamped to +-3e4) and one
softmax over every valid sample's taps; the output loses a ``(ksize -
1) / 2`` border.
"""

import torch

from benchmark.reference.nn import chain, chain_leaves, splat_frame, unet

__all__ = ["leaves", "forward"]


def _unet_leaves(name, cin, cout, width, levels, convs):
    out = []
    widths = [min(int(width * 2 ** lvl), 512) for lvl in range(levels)]
    for lvl in range(levels):
        out += chain_leaves("%s.down%d" % (name, lvl), cin, widths[lvl],
                            widths[lvl], convs, 3, "relu", "relu")
        cin = widths[lvl]
    for lvl in range(levels - 2, -1, -1):
        co = cout if lvl == 0 else widths[lvl]
        out += chain_leaves("%s.up%d" % (name, lvl), cin + widths[lvl], co,
                            widths[lvl], convs, 3, "relu",
                            "leaky_relu" if lvl == 0 else "relu")
        cin = co
    return out


def leaves(cfg):
    m = cfg["model"]
    ew, w = m["embedding_width"], m["width"]
    out = []
    for s in range(m["nsteps"]):
        cin = m["n_features"] + m["n_global_features"] if s == 0 else ew + w
        out += chain_leaves("embed%d" % s, cin, ew, w, 3, 1, "relu",
                            "linear")
        out += _unet_leaves("unet%d" % s, ew, w, w, 3, 3)
    out += chain_leaves("regress", ew + w, m["ksize"] ** 2, w, 3, 1,
                        "leaky_relu", "linear")
    return out


def forward(cfg, p, x, q=None):
    m = cfg["model"]
    radiance = x["radiance"].float()
    feats = x["features"].float()
    bs, spp, _, h, w = feats.shape
    valid = x.get("sample_mask")
    mask = (torch.ones(bs, spp, device=feats.device) if valid is None
            else valid.float())
    n_valid = mask.sum(1).clamp(min=1.0)
    extra = x["global_features"].float().reshape(bs, -1, 1, 1)
    prop = None
    for s in range(m["nsteps"]):
        ex = (extra if s == 0 else prop)[:, None].expand(
            bs, spp, -1, h, w)
        flat = torch.cat([feats, ex], 2).reshape(bs * spp, -1, h, w)
        feats = chain(flat, p, "embed%d" % s, 3, q=q).reshape(
            bs, spp, -1, h, w)
        mean = (feats * mask[:, :, None, None, None]).sum(1) \
            / n_valid[:, None, None, None]
        prop = unet(mean, p, "unet%d" % s, 3, 3, "leaky_relu", q=q)
    logits = []
    for s in range(spp):
        lg = chain(torch.cat([feats[:, s], prop], 1), p, "regress", 3,
                   "leaky_relu", "linear", q=q).clamp(-3e4, 3e4)
        logits.append(q(lg) if q is not None else lg)
    out = splat_frame(radiance, logits, m["ksize"], valid)
    o = (m["ksize"] - 1) // 2
    return out[..., o:-o, o:-o]
