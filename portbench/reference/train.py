"""Plain reference of the training step.

The reference SemanticTraining step (pointstowood/src/trainer.py:96-320
with loss.py:6-79) as the port and the JAX package define it: the
configuration's network (its architecture's plain ``Reference``: for the
PointsToWood ``Net``, random 50% centres) with masked batch statistics,
the Poly-1 focal loss (gamma 2, epsilon 0.1, label smoothing 0.1, alpha
None, the reference's clamps) averaged over the valid points, the update
applied only when the loss and every gradient are finite, clipping by
the global norm at 1.0 (scaled only when the norm reaches it), then
AdamW (betas 0.9 / 0.999, eps 1e-8, weight decay 0.01 on every
parameter, parameters without a gradient decayed all the same). The
running statistics follow ``(1 - 0.1) * running + 0.1 * batch`` with the
unbiased variance.
"""

from __future__ import annotations

import math

import torch

from portbench import arch
from portbench.reference.net import BN_MOMENTUM, Products

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
WEIGHT_DECAY = 1e-2
CLIP_NORM = 1.0
BUFFER_SUFFIXES = (".running_mean", ".running_var", ".num_batches_tracked")


def poly1_focal_loss(logits, labels, mask, epsilon=0.1, gamma=2.0,
                     smoothing=0.1, eps=1e-6):
    z = torch.clamp(logits, -10.0, 10.0)
    y = labels * (1.0 - smoothing) + 0.5 * smoothing
    p = torch.clamp(torch.sigmoid(z), eps, 1.0 - eps)
    ce = torch.clamp(torch.clamp(z, min=0.0) - z * y
                     + torch.log1p(torch.exp(-torch.abs(z))), max=100.0)
    pt = torch.clamp(y * p + (1.0 - y) * (1.0 - p), eps, 1.0 - eps)
    loss = torch.clamp(torch.pow(1.0 - pt, gamma), max=2.0) * ce
    loss = loss + torch.clamp(epsilon * torch.pow(1.0 - pt, gamma + 1.0),
                              max=100.0)
    loss = torch.clamp(loss, 0.0, 100.0)
    loss = torch.where(torch.isnan(loss), 0.0, loss)
    m = mask.float()
    return (loss * m).sum() / torch.clamp(m.sum(), min=1.0)


def confusion(logits, labels, mask):
    """(tp, fp, tn, fn) of the predictions sigmoid >= 0.5 over valid
    points."""
    pred = torch.sigmoid(logits) >= 0.5
    lab = labels > 0.5
    return torch.stack([(pred & lab & mask).sum(), (pred & ~lab & mask).sum(),
                        (~pred & ~lab & mask).sum(), (~pred & lab & mask).sum()
                        ]).double()


class Trainer:
    """The reference training state: float32 weights (a state_dict-keyed
    dict) on ``device`` and AdamW's moments; the network is the plain
    ``Reference`` of the configuration's architecture
    (``arch/<name>.py``)."""

    def __init__(self, weights: dict, model: dict, device,
                 products: Products | None = None):
        self.model = model
        self.network = arch.load(model).Reference
        self.products = products or Products()
        self.params = {k: v.detach().to(device, torch.float32).clone()
                       for k, v in weights.items()
                       if not k.endswith(BUFFER_SUFFIXES)}
        self.buffers = {k: v.detach().to(device).clone()
                        for k, v in weights.items()
                        if k.endswith(BUFFER_SUFFIXES)}
        self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.t = 0

    def step(self, batch: dict, lr: float, generator) -> dict:
        """One step on a padded batch of device tensors (pos, refl, mask,
        sf, labels). Returns the loss, the confusion counts, whether the
        update was applied and the gradients as the optimizer got them."""
        leaves = {k: v.clone().requires_grad_() for k, v in self.params.items()}
        net = self.network({**leaves, **self.buffers}, self.model,
                           self.products)
        logits = net.forward(batch["pos"], batch["refl"], batch["mask"],
                             batch["sf"], training=True, generator=generator)
        loss = poly1_focal_loss(logits, batch["labels"], batch["mask"])
        names = list(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names],
                                    allow_unused=True)
        grads = {k: (torch.zeros_like(leaves[k]) if g is None else g.detach())
                 for k, g in zip(names, grads)}
        counts = confusion(logits.detach(), batch["labels"], batch["mask"])
        finite = bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(g).all()) for g in grads.values())
        if finite:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            if float(norm) >= CLIP_NORM:
                grads = {k: g / norm * CLIP_NORM for k, g in grads.items()}
            self._adamw(grads, lr)
            with torch.no_grad():
                for name, (mean, var, n) in net.stats.items():
                    rm, rv = (self.buffers[name + ".running_mean"],
                              self.buffers[name + ".running_var"])
                    unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
                    rm.copy_((1 - BN_MOMENTUM) * rm + BN_MOMENTUM * mean)
                    rv.copy_((1 - BN_MOMENTUM) * rv + BN_MOMENTUM * unbiased)
        return {"loss": float(loss.detach()), "counts": counts.cpu(),
                "finite": finite, "grads": grads}

    def _adamw(self, grads, lr):
        self.t += 1
        b1, b2 = BETAS
        bc1 = 1 - b1 ** self.t
        bc2 = math.sqrt(1 - b2 ** self.t)
        with torch.no_grad():
            for k, p in self.params.items():
                g = grads[k]
                p.mul_(1 - lr * WEIGHT_DECAY)
                self.m[k].lerp_(g, 1 - b1)
                self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = self.v[k].sqrt() / bc2 + ADAM_EPS
                p.addcdiv_(self.m[k], denom, value=-lr / bc1)

    def state(self) -> dict:
        return {**self.params, **self.buffers}
