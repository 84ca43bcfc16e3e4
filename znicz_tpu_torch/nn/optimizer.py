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

from typing import Any, NamedTuple, Optional

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

    ``params``/``grads``/``velocity`` are matching trees whose top-level
    entries are the layers: a list of per-layer dicts, or the pipelined
    transformer's ``{"embed", "stages", "head"}``.  ``hyper`` is one
    HyperParams for all of them or a list aligned with them; each entry
    goes through :func:`update_pytree`.
    """
    keys = list(params) if isinstance(params, dict) else range(len(params))
    if isinstance(hyper, HyperParams):
        hyper = [hyper] * len(keys)
    if len(hyper) != len(keys):
        raise ValueError(
            f"hyper has {len(hyper)} entries for {len(keys)} layers"
        )
    for k, h in zip(keys, hyper):
        update_pytree(params[k], grads[k], velocity[k], h)


def _leaf_name(path) -> str:
    """The innermost dict key of a leaf's path (a tuple of dict keys and
    list indices), as the JAX package's ``_leaf_name`` reads a keypath;
    "" when the path holds no dict key."""
    for entry in reversed(path):
        if isinstance(entry, str):
            return entry
    return ""


def _walk(params, grads, velocity, path=()):
    if isinstance(params, dict):
        for k in params:
            yield from _walk(params[k], grads[k], velocity[k], path + (k,))
    elif isinstance(params, (list, tuple)):
        for i, p in enumerate(params):
            yield from _walk(p, grads[i], velocity[i], path + (i,))
    else:
        yield path, params, grads, velocity


def update_pytree(params, grads, velocity, hyper: HyperParams) -> None:
    """Name-aware update over a tree of dicts and lists, in place, with one
    ``hyper``: the bias rules key on each leaf's innermost dict key (a
    layer dict's own names, or a stacked stage group's)."""
    for path, w, g, v in _walk(params, grads, velocity):
        update_param(w, g, v, _leaf_name(path), hyper)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def clip_gradients(grads, max_norm: Optional[float]):
    """Global-norm gradient clipping over a tree of dicts and lists of
    tensors (a list of per-layer dicts): new tensors scaled by
    ``min(1, max_norm / (norm + 1e-12))``, ``grads`` itself when
    ``max_norm`` is falsy."""
    if not max_norm:
        return grads
    leaves = [g for _, g, _, _ in _walk(grads, grads, grads)]
    total = torch.sqrt(sum(torch.sum(torch.square(g)) for g in leaves))
    scale = torch.clamp(max_norm / (total + 1e-12), max=1.0)
    return _map(lambda g: g * scale, grads)
