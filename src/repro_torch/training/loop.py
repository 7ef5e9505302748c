"""Training loop: the train-step factory and the host-side driver
(``repro.training.loop``), with ``torch.autograd``.

A batch is a dict of numpy arrays or tensors (``tokens`` and ``labels``
(B, S), and a cross-attention model's ``frames`` / ``image_embeds``);
:func:`batch_to` moves it onto the parameters' device.  Parameters are
the model's parameter tree: the step makes every leaf require grad,
differentiates ``Model.loss`` with ``torch.autograd.grad`` and updates
the leaves in place through :func:`~.optimizer.adamw_update`.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..models.transformer import Model
from ..models.weights import tree_leaves, tree_map
from .optimizer import AdamWConfig, AdamWState, adamw_init, adamw_update


def _unflatten_like(tree: Any, leaves: list) -> Any:
    """``leaves`` (in :func:`tree_leaves` order) in the structure of
    ``tree``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def batch_to(batch: Dict[str, Any], device: Any) -> Dict[str, torch.Tensor]:
    """The batch as tensors on ``device``: integer arrays (tokens,
    labels) as int64, float arrays (the image / audio stubs) as they
    are."""
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.asarray(v))
        if not t.is_floating_point():
            t = t.long()
        out[k] = t.to(device)
    return out


def _device(params: Any) -> torch.device:
    return tree_leaves(params)[0].device


def make_train_step(model: Model, opt_cfg: AdamWConfig, *,
                    microbatches: int = 1) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``; the parameters and the optimizer state are
    updated in place and returned.

    ``microbatches > 1`` splits the batch along its first axis and
    accumulates float32 gradients divided by the count, cast to each
    parameter's dtype before the update, as the reference does: the
    activations then scale with the microbatch.  The loss is the mean of
    the microbatches', the other metrics the last one's."""

    def grads_of(leaves, params, batch):
        loss, metrics = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def train_step(params, opt_state: AdamWState, batch: Dict[str, Any]):
        batch = batch_to(batch, _device(params))
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        if microbatches == 1:
            loss, metrics, grads = grads_of(leaves, params, batch)
        else:
            n = next(iter(batch.values())).shape[0] // microbatches
            acc = [torch.zeros(p.shape, dtype=torch.float32,
                               device=p.device) for p in leaves]
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            for i in range(microbatches):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                l_i, metrics, g_i = grads_of(leaves, params, mb)
                for a, g in zip(acc, g_i):
                    a.add_(g.float() / microbatches)
                loss = loss + l_i / microbatches
                del g_i
            grads = [a.to(p.dtype) for a, p in zip(acc, leaves)]
            del acc
        for p in leaves:
            p.requires_grad_(False)
        params, opt_state, opt_metrics = adamw_update(
            opt_cfg, _unflatten_like(params, grads), opt_state, params)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_eval_step(model: Model) -> Callable:
    """Returns ``eval_step(params, batch) -> {"loss", "ce", "aux"}``,
    without autograd."""

    def eval_step(params, batch):
        with torch.no_grad():
            loss, metrics = model.loss(params,
                                       batch_to(batch, _device(params)))
        return {"loss": loss, **metrics}

    return eval_step


def train(model: Model, params, batches: Iterator[Dict[str, Any]],
          opt_cfg: AdamWConfig, *, steps: int,
          log_every: int = 10,
          callback: Optional[Callable[[int, Dict], None]] = None,
          ) -> Tuple[Any, AdamWState, list]:
    """Host driver: ``steps`` train steps on the parameters' device.
    Returns (params, optimizer state, history); the history holds the
    metrics as floats, with ``step`` and ``elapsed_s``, every
    ``log_every`` steps and at the last.  The parameters are trained in
    place and returned with ``requires_grad`` off, ready to serve (a leaf
    that still required grad would make every serving step build a
    graph)."""
    step_fn = make_train_step(model, opt_cfg)
    opt_state = adamw_init(params)
    history = []
    t0 = time.time()
    for step in range(steps):
        params, opt_state, metrics = step_fn(params, opt_state,
                                             next(batches))
        if step % log_every == 0 or step == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m["elapsed_s"] = time.time() - t0
            history.append(m)
            if callback:
                callback(step, m)
    for p in tree_leaves(params):
        p.requires_grad_(False)
    return params, opt_state, history
