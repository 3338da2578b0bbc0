"""Classical comparison denoisers (counterpart of ``sbmc_tpu/comparisons.py``).

The four prior-work baselines the evaluation scores SBMC against, on
``[c, h, w]`` float32 tensors of any device:

- :func:`nlm_denoise` — dual-buffer non-local means with variance
  cancellation (Rousselle/Knaus/Zwicker 2012), single scale.
- :func:`cross_bilateral_denoise` — a feature-weighted cross-bilateral
  filter over the g-buffer (albedo/normal/depth), the Sen2011 RPF family.
- :func:`rpf_denoise` — Random Parameter Filtering (Sen & Darabi 2012):
  histogram mutual information between sample colors / scene features and
  the sampler's random parameters sets per-feature bilateral bandwidths over
  a coarse-to-fine window ladder (statistics pooled over pixel cells).
- :func:`nfor_denoise` — Bitterli2016 NFOR: NL-means-weighted collaborative
  first-order regression on prefiltered features, cross-filtered between the
  half buffers, two bandwidth candidates blended by a dual-buffer MSE
  estimate.

The simplifications against the papers are the JAX package's, documented at
each function there; this module computes the same functions. Where the JAX
package runs a ``lax.scan`` over window offsets, this one runs a Python loop
over the static offsets, each a few batched tensor operations (eager, so on
a GPU they are many small launches). Edge padding is ``replicate``,
population statistics are ``correction=0`` (``jnp.std``/``np.var``), and
the box filter keeps the cumulative-sum form, its prefix sums taken in the
order XLA sums ``jnp.cumsum`` on the CPU (:func:`_prefix_sum`).
Accumulators are updated in place, which changes no value. There is no
hand-written kernel here: the JAX package has no Pallas kernel for the
baselines either.
"""

import torch
import torch.nn.functional as F

from sbmc_tpu_torch.utils.device import resolve_device

__all__ = ["nlm_denoise", "cross_bilateral_denoise", "rpf_denoise",
           "nfor_denoise", "denoise_buffers"]

_F32 = torch.float32


#: Block length of :func:`_prefix_sum`'s two-level scan.
_SCAN_BLOCK = 16


def _prefix_sum(v):
    """Inclusive prefix sum along the last dim, in float32, summed in the
    order XLA's CPU backend sums ``jnp.cumsum``: sequentially within blocks
    of 16, then the block totals scanned the same way (recursively) and
    added to each block. Every step is an elementwise add, so the result is
    the same on any device; a sequential or tree scan would round otherwise,
    and the box filter below cancels large prefix sums, where that shows."""
    n = v.shape[-1]
    if n <= _SCAN_BLOCK:
        out = v.clone()
        for i in range(1, n):
            out[..., i] += out[..., i - 1]
        return out
    nb = -(-n // _SCAN_BLOCK)
    blocks = F.pad(v, (0, nb * _SCAN_BLOCK - n)).reshape(
        v.shape[:-1] + (nb, _SCAN_BLOCK))
    inner = _prefix_sum(blocks)
    before = F.pad(_prefix_sum(inner[..., -1])[..., :-1], (1, 0))
    out = (inner + before[..., None]).reshape(v.shape[:-1]
                                              + (nb * _SCAN_BLOCK,))
    return out[..., :n]


def _box_filter(x, r):
    """Separable (2r+1)^2 mean filter over the trailing 2 dims, 'same' size,
    normalized by the in-bounds sample count at borders (the cumulative-sum
    form of the JAX package: a window sum is the difference of two prefix
    sums, the prefix index clamped at both ends)."""

    def filt1d(v, dim):
        v = v.movedim(dim, -1)
        n = v.shape[-1]
        c = _prefix_sum(F.pad(v, (1, 0)))                 # c[j] = sum v[:j]
        i = torch.arange(n, device=v.device)
        hi = c.index_select(-1, torch.clamp(i + r + 1, max=n))
        lo = c.index_select(-1, torch.clamp(i - r, min=0))
        return (hi - lo).movedim(-1, dim)

    def count(n):
        i = torch.arange(n, device=x.device)
        return (torch.clamp(i + r + 1, max=n)
                - torch.clamp(i - r, min=0)).to(x.dtype)

    # The in-bounds count is an integer, exact in float32 however summed.
    h, w = x.shape[-2:]
    return filt1d(filt1d(x, -1), -2) / (count(h)[:, None] * count(w)[None])


def _pad_edge(x, r):
    """``x`` edge-padded by ``r`` on its trailing 2 dims."""
    h, w = x.shape[-2:]
    xp = F.pad(x.reshape(-1, 1, h, w), (r, r, r, r), mode="replicate")
    return xp.reshape(x.shape[:-2] + (h + 2 * r, w + 2 * r))


def _window(xp, dy, dx, h, w):
    """The ``h x w`` view of an edge-padded tensor at offset ``(dy, dx)``."""
    return xp[..., dy:dy + h, dx:dx + w]


def _shifted(x, dy, dx, r):
    """x shifted by (dy - r, dx - r) with edge padding."""
    h, w = x.shape[-2:]
    return _window(_pad_edge(x, r), dy, dx, h, w)


def nlm_denoise(buf_a, buf_b, var, patch_r=3, window_r=7, k=0.45,
                alpha=0.5):
    """Dual-buffer non-local means with variance cancellation
    (Rousselle2012 family).

    Args:
      buf_a, buf_b: ``[c, h, w]`` independent half-buffer means.
      var: ``[c, h, w]`` variance of each half-buffer's *mean* estimate.
      patch_r: patch radius (7x7 patches by default).
      window_r: search-window radius (15x15 window).
      k: filter sensitivity (paper's ``k``).
      alpha: variance cancellation factor.

    Returns:
      ``[c, h, w]`` denoised image (average of the two cross-filtered half
      buffers).
    """
    return 0.5 * (_nlm_filter(buf_a, buf_b, var, patch_r, window_r, k,
                              alpha=alpha)
                  + _nlm_filter(buf_b, buf_a, var, patch_r, window_r, k,
                                alpha=alpha))


def cross_bilateral_denoise(color, var, albedo, normal, depth, window_r=7,
                            sigma_s=5.0, sigma_c=0.65, sigma_a=0.1,
                            sigma_n=0.25, sigma_z=0.01):
    """Feature-weighted cross-bilateral filter (RPF/Sen2011 family).

    Args:
      color: ``[c, h, w]`` noisy mean radiance.
      var: ``[c, h, w]`` variance of the mean estimate (the range kernel is
        noise-aware: color differences are normalized by it).
      albedo: ``[3, h, w]``; normal: ``[3, h, w]``; depth: ``[1, h, w]``
        g-buffer guides.
      window_r: search-window radius.
      sigma_*: spatial / color / albedo / normal / depth bandwidths.

    Returns:
      ``[c, h, w]`` filtered radiance.
    """
    eps = 1e-10
    win = 2 * window_r + 1
    h, w = color.shape[-2:]
    pads = [_pad_edge(t, window_r) for t in (color, var, albedo, normal,
                                             depth)]
    acc = torch.zeros_like(color)
    wsum = torch.zeros((h, w), dtype=_F32, device=color.device)
    two_s2 = torch.tensor(2 * sigma_s ** 2, dtype=_F32)
    for dy in range(win):
        for dx in range(win):
            fy, fx = float(dy - window_r), float(dx - window_r)
            # The spatial weight in float32, as the JAX package forms it.
            ws = float(torch.exp(-torch.tensor(fy * fy + fx * fx,
                                               dtype=_F32) / two_s2))
            c_q, v_q, a_q, n_q, z_q = (_window(p, dy, dx, h, w)
                                       for p in pads)
            # Noise-aware range kernel: subtract the expected squared noise
            # difference so equal-signal pairs keep weight ~1.
            d2 = torch.clamp((color - c_q) ** 2 - (var + v_q), min=0.0)
            dc = (d2 / (eps + 2 * sigma_c ** 2 * (var + v_q + 1e-4))).mean(0)
            da = ((albedo - a_q) ** 2).sum(0) / (2 * sigma_a ** 2)
            dn = torch.clamp(1.0 - (normal * n_q).sum(0), min=0.0) / sigma_n
            dz = ((depth - z_q) ** 2).sum(0) / (2 * sigma_z ** 2)
            wgt = ws * torch.exp(-dc - da - dn - dz)
            acc += wgt[None] * c_q
            wsum += wgt
    return acc / (wsum[None] + eps)


def _pool_samples(vals, cell):
    """``[s, q, h, w]`` -> per-cell sample values ``[n_cells, q, s*cell^2]``
    (cells in row-major order; within a cell, sample-major then row-major
    pixels). h, w must be multiples of ``cell``."""
    s, q, h, w = vals.shape
    hc, wc = h // cell, w // cell
    x = vals.reshape(s, q, hc, cell, wc, cell).permute(2, 4, 1, 0, 3, 5)
    return x.reshape(hc * wc, q, s * cell * cell)


def _cell_broadcast(v, cell, h, w):
    """``[n_cells, q]`` per-cell scalars -> ``[q, h, w]`` (nearest
    upsample)."""
    hc, wc = h // cell, w // cell
    v = v.reshape(hc, wc, -1).permute(2, 0, 1)
    return v.repeat_interleave(cell, dim=-2).repeat_interleave(cell, dim=-1)


def _bins(pooled, n_bins):
    """Histogram bin of each standardized value (clipped to +-2 sigma; the
    float-to-int conversion truncates, as ``astype(int32)`` does)."""
    b = torch.clamp((pooled / 4.0 + 0.5) * n_bins, 0, n_bins - 1e-3)
    return b.to(torch.int64)


def _mi_cells(pooled, hc, wc, n_bins):
    """Pairwise histogram mutual information per cell, with the joint
    histogram counts aggregated over each cell's 3x3 cell neighborhood
    (edge-padded).

    Args:
      pooled: ``[n_cells, q, n]`` consistently standardized values.
      hc, wc: cell-grid shape (``n_cells == hc * wc``).
      n_bins: histogram quantization.

    Returns:
      ``[n_cells, q, q]`` MI estimates (nats). The counts are a batched
      product of one-hot tensors, exact in float32.
    """
    nc, q, n = pooled.shape
    levels = torch.arange(n_bins, device=pooled.device)[:, None]
    one = (_bins(pooled, n_bins)[:, :, None] == levels).to(pooled.dtype)
    one = one.reshape(nc, q * n_bins, n)                 # one-hot [nc, qB, n]
    joint = torch.bmm(one, one.transpose(1, 2))                # [nc, qB, qB]
    del one
    jg = joint.reshape(hc, wc, q, n_bins, q, n_bins)
    del joint
    rows = torch.arange(hc, device=pooled.device)
    cols = torch.arange(wc, device=pooled.device)
    agg = None
    for dy in range(3):
        ry = torch.clamp(rows + dy - 1, 0, hc - 1)
        for dx in range(3):
            rx = torch.clamp(cols + dx - 1, 0, wc - 1)
            term = jg.index_select(0, ry).index_select(1, rx)
            if agg is None:
                agg = term
            else:
                agg += term
    del jg, term
    # [hc, wc, q, B, r, D] -> [n_cells, q, r, B, D]
    agg = agg.permute(0, 1, 2, 4, 3, 5).reshape(nc, q, q, n_bins, n_bins)
    p = agg / agg.sum((-1, -2), keepdim=True)
    del agg
    pa = p.sum(-1, keepdim=True)
    pb = p.sum(-2, keepdim=True)
    eps = 1e-9
    return (p * (torch.log(p + eps) - torch.log(pa * pb + eps))).sum((-1, -2))


def rpf_denoise(colors, feats, randoms, radii=(7, 5, 3, 2), cell=8,
                n_bins=8, sigma_c=0.45, sigma_f=0.45):
    """Random Parameter Filtering (Sen & Darabi 2012), as
    ``sbmc_tpu.comparisons.rpf_denoise`` computes it: per iteration over the
    coarse-to-fine window radii, the mutual information of every quantity
    pair per cell sets the color bandwidth scale ``alpha`` and the feature
    weights ``beta`` (paper eqs. 6-9); then each sample's color is
    re-estimated from neighbor-pixel sample means by a cross-bilateral
    filter on the standardized values.

    Args:
      colors: ``[s, 3, h, w]`` per-sample radiance.
      feats: ``[s, f, h, w]`` scene features (albedo/normal/depth...).
      randoms: ``[s, r, h, w]`` random parameters (subpixel/lens/time).

    Returns:
      ``[3, h, w]`` denoised radiance.
    """
    s, _, h, w = colors.shape
    pad_h, pad_w = (-h) % cell, (-w) % cell
    if pad_h or pad_w:
        def grow(x):
            return F.pad(x, (0, pad_w, 0, pad_h), mode="replicate")
        out = rpf_denoise(grow(colors), grow(feats), grow(randoms),
                          radii=radii, cell=cell, n_bins=n_bins,
                          sigma_c=sigma_c, sigma_f=sigma_f)
        return out[..., :h, :w]

    hc, wc = h // cell, w // cell
    dev = colors.device

    def global_std(v):
        # Frame-global standardization (population statistics).
        mu = v.mean((0, 2, 3), keepdim=True)
        sd = v.std((0, 2, 3), keepdim=True, correction=0) + 1e-6
        return (v - mu) / sd

    # Position quantities: within-cell pixel offsets, standardized.
    p_sd = float(((cell * cell - 1) / 12.0) ** 0.5) + 1e-6
    loc = (torch.arange(h, dtype=colors.dtype, device=dev) % cell
           - (cell - 1) / 2) / p_sd
    locx = (torch.arange(w, dtype=colors.dtype, device=dev) % cell
            - (cell - 1) / 2) / p_sd
    pos = torch.stack(torch.meshgrid(loc, locx, indexing="ij"))[None]
    pos = pos.expand(s, 2, h, w)

    f_std = global_std(feats)
    f_pool = _pool_samples(f_std, cell)
    r_pool = _pool_samples(global_std(randoms), cell)
    p_pool = _pool_samples(pos, cell)

    nf, nr = feats.shape[1], randoms.shape[1]
    sl_c = slice(0, 3)
    sl_f = slice(3, 3 + nf)
    sl_r = slice(3 + nf, 3 + nf + nr)
    sl_p = slice(3 + nf + nr, 3 + nf + nr + 2)
    inv2c = 1.0 / (2.0 * sigma_c ** 2)
    inv2f = 1.0 / (2.0 * sigma_f ** 2)
    for t, radius in enumerate(radii):
        c_std = global_std(colors)
        mi = _mi_cells(torch.cat([_pool_samples(c_std, cell), f_pool, r_pool,
                                  p_pool], 1), hc, wc, n_bins)
        d_rc = mi[:, sl_c, sl_r].sum(-1)                  # [nc, 3]
        d_pc = mi[:, sl_c, sl_p].sum(-1)
        d_fc = mi[:, sl_c, sl_f].sum(-1)
        w_rc = d_rc / (d_rc + d_pc + d_fc + 1e-9)
        alpha = torch.clamp(1.0 - 2.0 * (1 + 0.1 * t) * w_rc, min=0.0)
        d_rf = mi[:, sl_f, sl_r].sum(-1)                  # [nc, nf]
        d_pf = mi[:, sl_f, sl_p].sum(-1)
        d_cf = mi[:, sl_f, sl_c].sum(-1)
        w_rf = d_rf / (d_rf + d_pf + d_cf + 1e-9)
        w_fc = d_cf / (d_cf.sum(-1, keepdim=True) + 1e-9)
        beta = w_fc * torch.clamp(1.0 - (1 + 0.1 * t) * w_rf, min=0.0)
        alpha_f = _cell_broadcast(alpha, cell, h, w)      # [3, h, w]
        beta_f = _cell_broadcast(beta, cell, h, w)        # [nf, h, w]

        c_mean = c_std.mean(0)                            # [3, h, w]
        f_mean = f_std.mean(0)
        raw_mean = colors.mean(0)
        pads = [_pad_edge(x, radius) for x in (c_mean, f_mean, raw_mean)]
        win = 2 * radius + 1
        acc = torch.zeros_like(colors)
        wsum = torch.zeros((s, h, w), dtype=_F32, device=dev)
        for dy in range(win):
            for dx in range(win):
                cq, fq, raw_q = (_window(p, dy, dx, h, w) for p in pads)
                dc = (alpha_f[None] * (c_std - cq[None]) ** 2).sum(1) * inv2c
                df = (beta_f * (f_mean - fq) ** 2).sum(0) * inv2f
                wgt = torch.exp(-dc - df[None])           # [s, h, w]
                acc += wgt[:, None] * raw_q[None]
                wsum += wgt
        colors = acc / (wsum[:, None] + 1e-9)
    return colors.mean(0)


def _nlm_weight_field(guide, var, padded, dy, dx, patch_r, k, alpha=0.5):
    """Per-pixel NL-means weight for the window offset ``(dy, dx)``,
    measured on ``guide`` with variance cancellation (the weight of
    Rousselle2012 that NFOR reuses as its regression weight). ``padded``
    holds ``guide`` and ``var`` edge-padded by the window radius."""
    eps = 1e-10
    h, w = guide.shape[-2:]
    gp, vp = padded
    g_q = _window(gp, dy, dx, h, w)
    v_q = _window(vp, dy, dx, h, w)
    d2 = ((guide - g_q) ** 2 - alpha * (var + torch.minimum(var, v_q))
          ) / (eps + k * k * (var + v_q))
    d2 = _box_filter(d2, patch_r).mean(0)
    return torch.exp(-torch.clamp(d2, min=0.0))           # [h, w]


def _nlm_filter(src, guide, var, patch_r, window_r, k, alpha=0.5):
    """NL-means filter of ``src`` with weights measured on ``guide``
    (nlm_denoise's per-buffer pass; also NFOR's feature prefilter)."""
    h, w = src.shape[-2:]
    padded = (_pad_edge(guide, window_r), _pad_edge(var, window_r))
    sp = _pad_edge(src, window_r)
    win = 2 * window_r + 1
    acc = torch.zeros_like(src)
    wsum = torch.zeros((h, w), dtype=_F32, device=src.device)
    for dy in range(win):
        for dx in range(win):
            wgt = _nlm_weight_field(guide, var, padded, dy, dx, patch_r, k,
                                    alpha=alpha)
            acc += wgt[None] * _window(sp, dy, dx, h, w)
            wsum += wgt
    return acc / (wsum[None] + 1e-10)


def _regression_filter(y, guide, var, feat, window_r, patch_r, k):
    """Collaborative NL-means-weighted first-order regression filter of
    ``y`` (NFOR's core estimator).

    For every window center ``p`` a weighted least-squares fit
    ``y_q ~ beta_0(p) + beta(p)^T (f_q - f_p)`` is solved over the
    ``(2R+1)^2`` window with NL-means weights ``w_pq`` measured on
    ``guide``; each pixel's output averages the predictions of every window
    containing it, weighted by the same ``w_pq``.

    Args:
      y: ``[c, h, w]`` buffer to filter.
      guide: ``[c, h, w]`` the *other* half buffer (weight source).
      var: ``[c, h, w]`` variance of the half-buffer means.
      feat: ``[nf, h, w]`` noise-free (prefiltered), standardized features.
      window_r: regression window radius ``R``.
      patch_r: NL-means patch radius.
      k: NL-means sensitivity (the candidate bandwidth).

    Returns:
      ``[c, h, w]`` filtered buffer.
    """
    c, h, w = y.shape
    nf = feat.shape[0]
    d = 1 + nf
    win = 2 * window_r + 1
    dev = y.device
    one = torch.ones((1, h, w), dtype=y.dtype, device=dev)
    padded = (_pad_edge(guide, window_r), _pad_edge(var, window_r))
    fp = _pad_edge(feat, window_r)
    yp = _pad_edge(y, window_r)

    def wfield(dy, dx):
        return _nlm_weight_field(guide, var, padded, dy, dx, patch_r, k)

    # Pass 1: accumulate the normal equations per window center.
    m_acc = torch.zeros((d * d, h, w), dtype=_F32, device=dev)
    b_acc = torch.zeros((d * c, h, w), dtype=_F32, device=dev)
    for dy in range(win):
        for dx in range(win):
            wgt = wfield(dy, dx)                              # [h, w]
            df = _window(fp, dy, dx, h, w) - feat             # f_q - f_p
            phi = torch.cat([one, df], 0)                     # [d, h, w]
            outer = (phi[:, None] * phi[None]).reshape(d * d, h, w)
            y_q = _window(yp, dy, dx, h, w)
            rhs = (phi[:, None] * y_q[None]).reshape(d * c, h, w)
            m_acc += wgt[None] * outer
            b_acc += wgt[None] * rhs

    # Tikhonov-regularized batched solve of the d x d systems.
    mat = m_acc.reshape(d, d, h, w).permute(2, 3, 0, 1)
    mat = mat + 1e-3 * torch.eye(d, dtype=_F32, device=dev)
    rhs = b_acc.reshape(d, c, h, w).permute(2, 3, 0, 1)
    del m_acc, b_acc
    beta = torch.linalg.solve(mat, rhs)                       # [h, w, d, c]
    del mat, rhs
    beta = beta.permute(2, 3, 0, 1).reshape(d * c, h, w)
    bp = _pad_edge(beta, window_r)

    # Pass 2: collaborative reconstruction -- each output pixel q averages
    # beta_0(p) + beta(p)^T (f_q - f_p) over all centers p = q - offset.
    acc = torch.zeros_like(y)
    wsum = torch.zeros((h, w), dtype=_F32, device=dev)
    for dy in range(win):
        for dx in range(win):
            rdy, rdx = win - 1 - dy, win - 1 - dx             # reverse shift
            w_at = _shifted(wfield(dy, dx), rdy, rdx, window_r)
            b_at = _window(bp, rdy, rdx, h, w).reshape(d, c, h, w)
            df = feat - _window(fp, rdy, rdx, h, w)           # f_q - f_p at q
            pred = b_at[0] + torch.einsum("jhw,jchw->chw", df, b_at[1:])
            acc += w_at[None] * pred
            wsum += w_at
    return acc / (wsum[None] + 1e-10)


def nfor_denoise(buf_a, buf_b, var, feat_a, feat_b, feat_var,
                 window_r=8, patch_r=3, ks=(0.5, 1.0), prefilter_r=3):
    """Nonlinearly weighted first-order regression (Bitterli et al. 2016),
    as ``sbmc_tpu.comparisons.nfor_denoise`` computes it:

    1. *Feature prefiltering*: each half buffer's features are NL-means
       filtered with weights measured on the other half buffer; the two are
       averaged and standardized frame-globally.
    2. *Candidates*: for each bandwidth ``k`` the half buffers are
       cross-filtered by :func:`_regression_filter`.
    3. *Selection*: a per-pixel dual-buffer MSE estimate of each candidate,
       box-smoothed; the smoothed binary argmin map blends the candidates.

    Args:
      buf_a, buf_b: ``[c, h, w]`` independent half-buffer radiance means.
      var: ``[c, h, w]`` variance of each half-buffer's mean.
      feat_a, feat_b: ``[nf, h, w]`` half-buffer feature means.
      feat_var: ``[nf, h, w]`` variance of the feature half-buffer means.
      window_r: regression window radius.
      patch_r: NL-means patch radius.
      ks: candidate NL-means sensitivities (the paper's {0.5, 1.0}).
      prefilter_r: feature-prefilter window radius.

    Returns:
      ``[c, h, w]`` denoised radiance.
    """
    f_a = _nlm_filter(feat_a, feat_b, feat_var, 1, prefilter_r, 1.0)
    f_b = _nlm_filter(feat_b, feat_a, feat_var, 1, prefilter_r, 1.0)
    feat = 0.5 * (f_a + f_b)
    mu = feat.mean((1, 2), keepdim=True)
    sd = feat.std((1, 2), keepdim=True, correction=0) + 1e-6
    feat = (feat - mu) / sd

    cands, mses = [], []
    for k in ks:
        filt_a = _regression_filter(buf_a, buf_b, var, feat, window_r,
                                    patch_r, k)
        filt_b = _regression_filter(buf_b, buf_a, var, feat, window_r,
                                    patch_r, k)
        cands.append(0.5 * (filt_a + filt_b))
        res = 0.5 * (((filt_a - buf_b) ** 2 - var)
                     + ((filt_b - buf_a) ** 2 - var))
        mses.append(_box_filter(res.mean(0)[None], 2)[0])

    out = cands[0]
    mse = mses[0]
    for cand, m in zip(cands[1:], mses[1:]):
        sel = _box_filter((m < mse).to(out.dtype)[None], 2)[0]
        out = (1.0 - sel)[None] * out + sel[None] * cand
        mse = torch.minimum(mse, m)
    return out


def _var0(x):
    """Population variance over dim 0, as ``np.var(x, 0)`` forms it: the
    mean first, then the mean of the squared deviations."""
    n = x.shape[0]
    return ((x - x.sum(0, keepdim=True) / n) ** 2).sum(0) / n


def denoise_buffers(features, labels, method="nlm", device=None, **kw):
    """Run a baseline on raw sample records (RAW_MODE feature stacks).

    Args:
      features: ``[spp, n_features, h, w]`` raw per-sample features (the
        RAW_MODE layout), a numpy array or a tensor.
      labels: feature-label list (``TilesDataset.labels``).
      method: "nlm", "cbf", "rpf", or "nfor".
      device: where to compute; by default the tensor's device, or the
        card (``resolve_device("cuda")``, which raises without CUDA) for a
        numpy array. Pass ``"cpu"`` to run a numpy array on the CPU.
      **kw: the method's own keyword arguments.

    Returns:
      ``[3, h, w]`` float32 numpy radiance.
    """
    if method not in ("nlm", "cbf", "rpf", "nfor"):
        raise ValueError("unknown baseline method %r" % method)
    if device is None:
        device = features.device if isinstance(features, torch.Tensor) \
            else resolve_device("cuda")
    features = torch.as_tensor(features, dtype=_F32, device=device)
    spp = features.shape[0]
    half = max(spp // 2, 1)

    def planes(name, n=3):
        i = labels.index(name)
        return torch.clamp(features[:, i:i + n], min=0.0)

    def normals():
        i = labels.index("normal_first_x")
        return features[:, i:i + 3]

    color = planes("diffuse_r") + planes("specular_r")
    buf_a = color[:half].mean(0)
    buf_b = color[half:].mean(0) if spp > 1 else color[:half].mean(0)
    # Variance of each half-buffer mean.
    var = _var0(color) / max(half, 1)

    with torch.no_grad():
        if method == "nlm":
            out = nlm_denoise(buf_a, buf_b, var, **kw)
        elif method == "nfor":
            feats = torch.cat([planes("albedo_first_r"), normals(),
                               planes("depth_first", 1)], 1)
            feat_a = feats[:half].mean(0)
            feat_b = feats[half:].mean(0) if spp > 1 else feat_a
            feat_var = _var0(feats) / max(half, 1)
            out = nfor_denoise(buf_a, buf_b, var, feat_a, feat_b, feat_var,
                               **kw)
        elif method == "rpf":
            feats = torch.cat([planes("albedo_first_r"), normals(),
                               planes("depth_first", 1)], 1)
            rand_names = [n for n in ("dx", "dy", "lens_u", "lens_v", "t")
                          if n in labels]
            if rand_names:
                randoms = torch.stack([features[:, labels.index(n)]
                                       for n in rand_names], 1)
            else:
                # Coordinate features absent (load_coords=False): the
                # per-sample radiance deviation stands in for randomness.
                randoms = color - color.mean(0, keepdim=True)
            out = rpf_denoise(color, feats, randoms, **kw)
        else:
            albedo = planes("albedo_first_r").mean(0)
            normal = normals().mean(0)
            depth = planes("depth_first", 1).mean(0)
            # cbf filters the full-spp mean, whose variance is var(0)/spp.
            var_full = _var0(color) / max(spp, 1)
            out = cross_bilateral_denoise(color.mean(0), var_full, albedo,
                                          normal, depth, **kw)
    return out.cpu().numpy()
