"""SGD update rule with the reference's GradientDescentBase knobs
(port of ``znicz_tpu/nn/optimizer.py``).

Update rule, per parameter::

    v <- moment * v - lr * (grad + decay_term(w))
    w <- w + v

with bias-specific ``learning_rate_bias``, ``weights_decay_bias`` and
``gradient_moment_bias``, and the L1/L2 mix ``l1_vs_l2``.  This is not
``torch.optim.SGD``, whose momentum recursion (``v = m v + g; w -= lr v``)
differs and which has no per-bias knobs.

The JAX package returns new arrays; here the parameters and the momentum
buffers are updated in place under ``torch.no_grad()``, which keeps one copy
of each on the card (and their pointers, which a captured step holds).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch


class HyperParams(NamedTuple):
    """Per-layer (or global) update-rule knobs."""

    learning_rate: Any = 0.01
    gradient_moment: Any = 0.0
    weights_decay: Any = 0.0
    l1_vs_l2: Any = 0.0
    learning_rate_bias: Any = None  # default: same as learning_rate
    weights_decay_bias: Any = None  # default: same as weights_decay
    gradient_moment_bias: Any = None  # default: same as gradient_moment

    def for_param(self, name: str):
        """Resolve (lr, moment, decay, l1_vs_l2) for a named parameter."""
        is_bias = name.endswith("bias")
        lr = self.learning_rate
        wd = self.weights_decay
        moment = self.gradient_moment
        if is_bias and self.learning_rate_bias is not None:
            lr = self.learning_rate_bias
        if is_bias and self.weights_decay_bias is not None:
            wd = self.weights_decay_bias
        if is_bias and self.gradient_moment_bias is not None:
            moment = self.gradient_moment_bias
        return lr, moment, wd, self.l1_vs_l2


def _decay_term(w, wd, l1_vs_l2):
    # wd * ((1 - a) * w + a * sign(w)): L2 pulls proportionally, L1 by sign.
    if wd == 0:
        return 0.0
    if l1_vs_l2 == 0:
        return wd * w
    return wd * ((1.0 - l1_vs_l2) * w + l1_vs_l2 * torch.sign(w))


@torch.no_grad()
def update_param(w: torch.Tensor, grad: torch.Tensor, v: torch.Tensor, name: str, hyper: HyperParams) -> None:
    """One parameter's momentum-SGD update, in place on ``w`` and ``v``.
    The learning rate may be a host scalar or a 0-d tensor on ``w``'s
    device (the workflows' steps pass the latter, so a captured step
    replays with each step's rate); ``-(lr g)`` is ``(-lr) g`` bit for
    bit."""
    lr, moment, wd, l1l2 = hyper.for_param(name)
    g = grad + _decay_term(w, wd, l1l2)
    if moment == 0:
        torch.mul(g, lr, out=v).neg_()
    else:
        v.copy_(moment * v - lr * g)
    w.add_(v)


def update(params, grads, velocity, hyper) -> None:
    """Update a whole model in place.

    ``params``/``grads``/``velocity`` are matching lists of per-layer dicts;
    ``hyper`` is one HyperParams for all layers or a list aligned with them.
    """
    if isinstance(hyper, HyperParams):
        hyper = [hyper] * len(params)
    if len(hyper) != len(params):
        raise ValueError(
            f"hyper has {len(hyper)} entries for {len(params)} layers"
        )
    for layer_p, layer_g, layer_v, h in zip(params, grads, velocity, hyper):
        for name in layer_p:
            update_param(layer_p[name], layer_g[name], layer_v[name], name, h)
