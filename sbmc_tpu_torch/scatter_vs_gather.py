"""The paper's motivating toy experiment: scatter (splat) against gather
kernels on a synthetic anti-aliasing task with radiance outliers
(counterpart of ``scripts/figures/scatter_vs_gather.py``).

    python -m sbmc_tpu_torch.scatter_vs_gather OUT [--steps 200] \\
        [--width 32] [--lr 1e-3] [--device cuda]

A small conv net predicts 3x3 kernels from jittered samples of a
step-edge image contaminated with rare, very bright outliers. Gather
kernels must pull energy and cannot cheaply suppress an outlier at their
own pixel; splat kernels let each sample decide where its energy goes, so
outliers learn to spread themselves to nothing. Both variants train with
Adam on the MSE against the target; the script writes ``losses.csv``
(``step, splat, gather``), ``splat.png`` and ``gather.png`` (grey strips:
the input mean beside the output, on the first batch) and prints the mean
of each variant's last 10 losses.

The batches are the JAX script's: one ``RandomState(0)`` draws them for
both variants in the same order (splat first: its first batch, then one a
step; then the gather variant's), in float64, cast to float32 as
``jnp.array`` casts them. The weights start from ``torch.manual_seed(0)``
(the JAX script's come from ``jax.random.PRNGKey(0)``, which the port
cannot draw; :func:`run` takes a flax parameter tree to start from the
same weights). On the card a splat step runs ``scatter2gather`` forward
and backward (the transpose is self-adjoint) and kernel weighting and its
weight gradient once each, on one channel through ``ops.channel_groups``;
a gather step runs the two kernel-weighting kernels only. Runs on
``--device cuda`` unless told otherwise, and raises when that device is
missing.
"""

import argparse
import csv
import os

import numpy as np
import torch
import torch.nn as nn

from sbmc_tpu_torch.nn.kernel_apply import kernel_apply
from sbmc_tpu_torch.nn.layers import ConvChain
from sbmc_tpu_torch.params import load_jax_params
from sbmc_tpu_torch.utils.device import resolve_device
from sbmc_tpu_torch.utils.image import crop_like, write_png

__all__ = ["Toy", "make_batch", "run", "main", "parse_args"]


def make_batch(rng, bs=4, spp=4, h=64, w=64, outlier_p=0.005):
    """Jittered samples of a random step-edge/checker image with outliers:
    ``(target [bs, 1, h, w] float32, samples [bs, spp, 1, h, w] float64,
    coords [bs, spp, 2, h, w] float64)``, drawn from ``rng`` in the JAX
    script's order."""
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    imgs, samples, coords = [], [], []
    for _ in range(bs):
        freq = rng.uniform(0.05, 0.2, 2)
        phase = rng.uniform(0, 2 * np.pi, 2)
        target = (np.sin(freq[0] * xs * 2 * np.pi + phase[0])
                  * np.sin(freq[1] * ys * 2 * np.pi + phase[1]) > 0)
        target = target.astype(np.float32)
        sp, co = [], []
        for _s in range(spp):
            dx = rng.rand(h, w)
            dy = rng.rand(h, w)
            val = (np.sin(freq[0] * (xs + dx) * 2 * np.pi + phase[0])
                   * np.sin(freq[1] * (ys + dy) * 2 * np.pi + phase[1]) > 0
                   ).astype(np.float32)
            out_mask = rng.rand(h, w) < outlier_p
            val = np.where(out_mask, rng.uniform(50, 200, (h, w)), val)
            sp.append(val)
            co.append(np.stack([dx, dy], 0))
        imgs.append(target)
        samples.append(np.stack(sp, 0))
        coords.append(np.stack(co, 0))
    return (np.stack(imgs)[:, None],
            np.stack(samples)[:, :, None],
            np.stack(coords))


class Toy(nn.Module):
    """The experiment's model: ``log10(1 + samples)`` and the sample
    coordinates through a 3-layer 3x3 ``ConvChain`` to ``ksize**2`` kernel
    logits a sample, applied to the samples with a softmax as splat or
    gather kernels, averaged over the samples and cropped by ``ksize //
    2``. The chain is named ``ConvChain_0``, its flax name, so the JAX
    script's parameters load onto it."""

    def __init__(self, splat, width, ksize=3):
        super().__init__()
        self.splat = splat
        self.ksize = ksize
        self.ConvChain_0 = ConvChain(3, ksize ** 2, ksize=3, width=width,
                                     depth=3, pad=True)

    def forward(self, samples, coords):
        bs, spp, _, h, w = samples.shape
        feats = torch.cat([torch.log10(1.0 + samples), coords], dim=2)
        kernels = self.ConvChain_0(feats.reshape(bs * spp, -1, h, w))
        data = samples.reshape(bs * spp, 1, h, w)
        out, _ = kernel_apply(data, kernels, softmax=True, splat=self.splat)
        out = out.reshape(bs, spp, 1, h, w).mean(1)
        k = (self.ksize - 1) // 2
        return out[..., k:-k, k:-k]


def _tensor(a, device):
    return torch.from_numpy(np.asarray(a, np.float32)).to(device)


def _step(model, opt, smp, crd, tgt):
    """One Adam step on the MSE against the cropped target; returns the
    loss before the update."""
    opt.zero_grad(set_to_none=True)
    out = model(smp, crd)
    loss = torch.mean((out - crop_like(tgt, out)) ** 2)
    loss.backward()
    opt.step()
    return loss.detach()


def _strip(smp0, out):
    """The input mean beside the output, cropped alike, clipped to [0, 1],
    as 8-bit grey."""
    c = (out.shape[-1] != smp0.shape[-1]) and \
        (smp0.shape[-1] - out.shape[-1]) // 2 or 0
    low = smp0[0].mean(0)[0]
    if c:
        low = low[c:-c, c:-c]
    strip = np.concatenate([np.clip(low, 0, 1), np.clip(out[0, 0], 0, 1)], 1)
    return (strip * 255).astype(np.uint8)


def run(output, steps=200, width=32, lr=1e-3, device="cuda", params=None):
    """Train both variants and write the outputs into ``output``; returns
    ``{"splat": losses, "gather": losses}``. ``params``: a flax parameter
    tree of the JAX script's ``Toy`` to start both variants from (default:
    weights from ``torch.manual_seed(0)``)."""
    device = resolve_device(device)
    rng = np.random.RandomState(0)
    results = {}
    for splat in (True, False):
        name = "splat" if splat else "gather"
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = Toy(splat, width)
        if params is not None:
            load_jax_params(model, params)
        model.to(device)
        tgt0, smp0, crd0 = make_batch(rng)
        opt = torch.optim.Adam(model.parameters(), lr=lr)
        losses = []
        for it in range(steps):
            tgt, smp, crd = make_batch(rng)
            loss = _step(model, opt, _tensor(smp, device),
                         _tensor(crd, device), _tensor(tgt, device))
            losses.append(float(loss))
            if it % 20 == 0:
                print(f"{name} step {it}: loss {losses[-1]:.5f}")
        results[name] = losses

        with torch.no_grad():
            out = model(_tensor(smp0, device),
                        _tensor(crd0, device)).cpu().numpy()
        os.makedirs(output, exist_ok=True)
        write_png(os.path.join(output, f"{name}.png"), _strip(smp0, out))

    with open(os.path.join(output, "losses.csv"), "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["step", "splat", "gather"])
        for i, (a, b) in enumerate(zip(results["splat"], results["gather"])):
            writer.writerow([i, a, b])
    print("final: splat %.5f gather %.5f" %
          (np.mean(results["splat"][-10:]), np.mean(results["gather"][-10:])))
    return results


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("output", help="output folder")
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--width", type=int, default=32)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (default: cuda).")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    # Float32 stays float32: no TF32 in cuDNN's convolutions.
    torch.backends.cudnn.allow_tf32 = False
    return run(args.output, args.steps, args.width, args.lr, args.device)


if __name__ == "__main__":
    main()
