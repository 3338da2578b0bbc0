"""LBF learned-bilateral-filter baseline (counterpart of
``sbmc_tpu/models/lbf.py``; Kalantari, Bako & Sen 2015, "A Machine Learning
Approach for Filtering Monte Carlo Noise").

A small per-pixel network maps sample statistics (means and variances) to
the parameters of an edge-aware cross-bilateral filter, trained end to end
through the differentiable filter against the reference image. It shares
the SBMC batch contract (``radiance`` / ``features`` / ``global_features``
/ ``sample_mask``), so it trains and denoises through the same entry
points.

- The per-pixel network is a stack of 1x1 convs.
- The filter's range features are a learned linear projection of the mean
  feature vector to ``n_guides`` channels.
- The window loop is a Python loop over the ``(2r+1)^2`` offsets of shifted
  slices of the edge-padded range features and colours; it runs no hand-written
  kernel.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from sbmc_tpu_torch.nn.layers import ConvChain, dtype_of

__all__ = ["LBF"]


class _Conv1x1(nn.Module):
    """A plain 1x1 convolution with the flax ``nn.Conv`` parameter names
    (``kernel`` ``[out, in, 1, 1]``, ``bias`` ``[out]``) and its default
    initialisation (LeCun normal kernel, zero bias)."""

    def __init__(self, in_features, features, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(
            torch.randn(features, in_features, 1, 1) * in_features ** -0.5)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        kernel, bias = self.kernel, self.bias
        if self.dtype is not None:
            x, kernel, bias = (t.to(self.dtype) for t in (x, kernel, bias))
        return F.conv2d(x, kernel, bias)


class LBF(nn.Module):
    """Learned cross-bilateral filter denoiser.

    Call with the SBMC sample dict:
      "radiance": ``[bs, spp, 3, h, w]``
      "features": ``[bs, spp, n_features, h, w]``
      "global_features": ``[bs, n_global_features, 1, 1]`` (or ``[bs, n]``)
      "sample_mask" (optional): ``[bs, spp]`` validity mask.

    Returns ``{"radiance": [bs, 3, h - 2*window_r, w - 2*window_r]}`` (the
    filter border that cannot be produced is cropped, as in Multisteps).
    """

    def __init__(self, n_features, n_global_features, window_r=8, n_guides=8,
                 width=64, depth=3, conv_dtype=None):
        super().__init__()
        self.n_global_features = n_global_features
        self.window_r = window_r
        self.n_guides = n_guides
        self.conv_dtype = dtype_of(conv_dtype)
        self.param_net = ConvChain(
            2 * n_features + 6 + n_global_features, n_guides + 1, depth=depth,
            width=width, ksize=1, activation="leaky_relu", pad=False,
            output_type="linear", dtype=self.conv_dtype or torch.float32)
        self.guide_proj = _Conv1x1(n_features, n_guides,
                                   dtype=self.conv_dtype or torch.float32)

    def forward(self, samples):
        dt = self.conv_dtype or torch.float32
        radiance = samples["radiance"]
        features = samples["features"].to(dt)
        gfeatures = samples["global_features"]
        mask = samples.get("sample_mask", None)

        bs, spp = features.shape[:2]
        h, w = features.shape[-2:]
        r = self.window_r
        if h <= 2 * r or w <= 2 * r:
            raise ValueError(
                "LBF(window_r=%d) needs inputs larger than %dx%d (got %dx%d)"
                % (r, 2 * r, 2 * r, h, w))

        if mask is None:
            mask = torch.ones((bs, spp), dtype=torch.bool,
                              device=features.device)
        m = mask.to(dt)[:, :, None, None, None]
        n_valid = m.sum(1).clamp(min=1.0)

        def mean_var(x):
            mu = (x * m).sum(1) / n_valid
            var = ((x - mu[:, None]) ** 2 * m).sum(1) / n_valid
            return mu, var

        r_mu, r_var = mean_var(radiance.to(dt))
        f_mu, f_var = mean_var(features)

        # Per-pixel parameter network (1x1 convs).
        gf = gfeatures.reshape(bs, -1, 1, 1).to(dt).expand(
            bs, self.n_global_features, h, w)
        stats = torch.cat([f_mu, f_var, r_mu, r_var, gf], dim=1)
        # Inverse squared bandwidths per pixel: n_guides feature terms and
        # one spatial term. softplus keeps them positive; the -1 bias makes
        # the initial filter broad, so early training gets gradient from
        # the whole window.
        inv_bw = F.softplus(self.param_net(stats) - 1.0).float()

        # Range features: a learned projection of the mean features.
        proj = self.guide_proj(f_mu).float()

        # Cross-bilateral filter over the edge-padded window.
        win = 2 * r + 1
        r_mu32 = r_mu.float()
        g_pad = F.pad(proj, (r, r, r, r), mode="replicate")
        c_pad = F.pad(r_mu32, (r, r, r, r), mode="replicate")
        a_g = inv_bw[:, :self.n_guides]
        a_s = inv_bw[:, self.n_guides] / float(r * r)  # [bs, h, w]
        acc = torch.zeros_like(r_mu32)
        wsum = torch.zeros((bs, h, w), dtype=torch.float32,
                           device=r_mu32.device)
        for dy in range(win):
            for dx in range(win):
                g_q = g_pad[:, :, dy:dy + h, dx:dx + w]
                c_q = c_pad[:, :, dy:dy + h, dx:dx + w]
                d = (a_g * (proj - g_q) ** 2).sum(1)
                d = d + a_s * float((dy - r) ** 2 + (dx - r) ** 2)
                wgt = torch.exp(-d)
                acc = acc + wgt[:, None] * c_q
                wsum = wsum + wgt
        out = acc / (wsum[:, None] + 1e-8)
        return {"radiance": out[..., r:h - r, r:w - r]}
