"""The reference train step: tonemapped relative MSE, the global-norm clip
and Adam, in float32.

- loss: ``0.5 * mean((t(x) - t(y))^2 / (t(y)^2 + 0.01))`` with ``t(x) =
  max(x, 0) / (1 + max(x, 0))``, the target centre-cropped to the output;
- clip: gradients are kept while their global norm is under the limit and
  scaled to the limit otherwise (optax's ``clip_by_global_norm``);
- Adam: ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``, ``p -= lr
  (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)``.
"""

import torch

from benchmark.reference.models import forward

__all__ = ["loss", "Adam", "step"]


def _tonemap(x):
    x = x.clamp(min=0)
    return x / (1 + x)


def loss(out, target):
    dy = (target.shape[-2] - out.shape[-2]) // 2
    dx = (target.shape[-1] - out.shape[-1]) // 2
    ref = _tonemap(target[..., dy:dy + out.shape[-2],
                          dx:dx + out.shape[-1]].float())
    return 0.5 * torch.mean((_tonemap(out) - ref) ** 2 / (ref ** 2 + 1e-2))


class Adam:
    """Adam over a dict of parameters."""

    def __init__(self, params, lr=1e-4, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def update(self, params, grads):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, g in grads.items():
            self.m[k] = self.b1 * self.m[k] + (1 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1 - self.b2) * g * g
            params[k] = params[k] - self.lr * (self.m[k] / c1) / (
                torch.sqrt(self.v[k] / c2) + self.eps)


def step(cfg, params, opt, batch, clip=1000.0, q=None, sign=1.0):
    """One train step on ``batch`` (in place on ``params`` and ``opt``).
    Returns ``(loss, grads, out)``: the loss before the update, the clipped
    gradients the optimizer got (times ``sign``, which only a planted
    fault sets) and the forward's output."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    out = forward(cfg, leaves, batch, q)
    value = loss(out, batch["target_image"])
    grads = dict(zip(leaves, torch.autograd.grad(value, list(
        leaves.values()))))
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
    if norm >= clip:
        grads = {k: g * (clip / norm).float() for k, g in grads.items()}
    if sign != 1.0:
        grads = {k: g * sign for k, g in grads.items()}
    with torch.no_grad():
        opt.update(params, grads)
    return float(value.detach()), grads, out.detach()
