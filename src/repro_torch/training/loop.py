"""Training loop: the train-step factory and the host-side driver
(``repro.training.loop``), with ``torch.autograd``.

A batch is a dict of numpy arrays or tensors (``tokens`` and ``labels``
(B, S), and a cross-attention model's ``frames`` / ``image_embeds``);
:func:`batch_to` moves it onto the parameters' device.  Parameters are
the model's parameter tree: the step makes every leaf require grad,
differentiates ``Model.loss`` with ``torch.autograd.grad`` and updates
the leaves in place through :func:`~.optimizer.adamw_update`.

Data parallelism (``make_train_step(mesh=)``, the train CLI's
``--devices N``): every rank of the mesh's ``"data"`` axis is handed the
same full batch, takes its 1/N of the rows, and differentiates its own
loss; the gradients, each weighted by its rank's share of the batch's
loss tokens, are summed by one all-reduce before AdamW.  The reduced
loss and gradient are then the full batch's (token-weighted cross
entropy is linear in the per-rank sums, whatever the masks; a MoE's
router aux term becomes the token-weighted mean of the ranks'), every
rank applies the same update, and the parameters stay equal on every
rank.  Microbatching is refused there: a mean of microbatch means is
not linear in the per-rank token sums.
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


def _data_shard(batch: Dict[str, torch.Tensor], mesh: Any,
                ) -> Dict[str, torch.Tensor]:
    """This rank's rows of ``batch`` on the mesh's ``"data"`` axis."""
    n = mesh.shape["data"]
    rows = next(iter(batch.values())).shape[0]
    if rows % n:
        raise ValueError(f"a batch of {rows} rows does not split over "
                         f"{n} data-parallel ranks")
    b = rows // n
    i = mesh.axis_index("data")
    return {k: v[i * b:(i + 1) * b] for k, v in batch.items()}


def _reduce_data(loss: torch.Tensor, grads: list, labels: torch.Tensor,
                 mesh: Any) -> Tuple[torch.Tensor, list]:
    """The full batch's loss and gradients from every rank's: each rank's
    weighted by its share of the loss tokens (labels != -100), summed in
    f32 by one all-reduce, cast back to each gradient's dtype."""
    from ..core.tp import all_reduce
    n_local = (labels != -100).sum().to(torch.float32)
    total = all_reduce(n_local.clone().reshape(1), mesh, "data")[0]
    w = n_local / total.clamp(min=1.0)
    flat = torch.cat([(loss.to(torch.float32) * w).reshape(1)]
                     + [(g.to(torch.float32) * w).reshape(-1)
                        for g in grads])
    all_reduce(flat, mesh, "data")
    out, at = [], 1
    for g in grads:
        out.append(flat[at:at + g.numel()].reshape(g.shape).to(g.dtype))
        at += g.numel()
    return flat[0], out


def make_train_step(model: Model, opt_cfg: AdamWConfig, *,
                    microbatches: int = 1,
                    mesh: Optional[Any] = None) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``; the parameters and the optimizer state are
    updated in place and returned.

    ``microbatches > 1`` splits the batch along its first axis and
    accumulates float32 gradients divided by the count, cast to each
    parameter's dtype before the update, as the reference does: the
    activations then scale with the microbatch.  The loss is the mean of
    the microbatches', the other metrics the last one's.

    ``mesh`` (a ``repro_torch.launch.mesh.Mesh`` with a ``"data"`` axis)
    makes the step data parallel (module docstring): every rank passes
    the same full batch, and the returned loss is the full batch's
    (``ce`` and ``aux`` stay the rank's own).  It takes
    ``microbatches=1`` only."""
    n_data = mesh.shape.get("data", 1) if mesh is not None else 1
    if n_data > 1 and microbatches != 1:
        raise ValueError("data-parallel steps take microbatches=1: a mean "
                         "of microbatch means is not the full batch's")

    def grads_of(leaves, params, batch):
        loss, metrics = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def train_step(params, opt_state: AdamWState, batch: Dict[str, Any]):
        batch = batch_to(batch, _device(params))
        if n_data > 1:
            batch = _data_shard(batch, mesh)
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
        if n_data > 1:
            loss, grads = _reduce_data(loss, list(grads), batch["labels"],
                                       mesh)
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
