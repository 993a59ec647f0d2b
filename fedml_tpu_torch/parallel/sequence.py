"""Sequence parallelism: the sharded long-context train step, the port of
``fedml_tpu/parallel/sequence.py``.

Pick a mesh with an ``sp`` axis over ranks (:func:`sequence_mesh`), shard
the token axis of the batch over it (:func:`shard_lm_batch`), keep the
parameters replicated, and let the model's only cross-token op, attention,
run as a ring over the axis (``parallel/ring_attention.py``,
``TransformerLM(attn_impl="ring")``). Loss and gradients are sums over
tokens, so they close over the axis with two sums (``collectives``'
all-reduce over the axis's group).
"""

from __future__ import annotations

import numpy as np
import torch

from fedml_tpu_torch.parallel import collectives
from fedml_tpu_torch.parallel import mesh as meshlib

SP_AXIS = "sp"


def sequence_mesh(num_sp: int | None = None, ranks=None) -> meshlib.RankMesh:
    """1-D mesh over the first ``num_sp`` ranks (default: every rank of the
    world, or rank 0 alone without one), its axis ``sp``."""
    ranks = list(ranks if ranks is not None else meshlib.world_ranks())
    if num_sp is None:
        num_sp = len(ranks)
    return meshlib._build(np.asarray(ranks[:num_sp]), (SP_AXIS,))


def make_sp_lm_train_step(model, optimizer, mesh: meshlib.RankMesh, sp_axis: str = SP_AXIS):
    """Returns ``step(params, opt_state, batch, dropout=None) -> (params,
    opt_state, loss)``.

    ``batch = {"x": [B, T/P], "y": [B, T/P], "mask": [B, T/P]}`` is this
    rank's block of the token axis (:func:`shard_lm_batch`); ``params`` (a
    state dict of the model's parameters) and ``opt_state`` (the port's
    functional optimizer's, ``optimizer.init(params)``) are replicated.
    ``dropout``: the model's keep masks over the whole sequence (``[B, T,
    C]`` each, ``core.trainer.draw_dropout_masks``), of which each rank
    takes its positions (the JAX step folds its key with the shard index).
    The model must be built with ``attn_impl="ring"``.

    As in the JAX step, no sum over the axis happens inside the
    differentiated function: the loss is this rank's tokens' masked sum over
    the *global* mask count (summed before the gradient), and the gradients
    are summed over the axis once, after it (a sum inside would add the
    other ranks' gradients in again through its backward)."""
    from fedml_tpu_torch.core.trainer import _cross_entropy

    group = mesh.group(sp_axis)
    n = collectives.group_size(group)
    idx = mesh.coord(sp_axis) if n > 1 else 0
    names = [k for k, _ in model.named_parameters()]

    def local_loss(params, batch, global_count, masks):
        x = batch["x"]
        t_loc = x.shape[1]
        kwargs = {"pos_offset": idx * t_loc}
        if masks is not None:
            kwargs.update(train=True, dropout={k: m[:, idx * t_loc:(idx + 1) * t_loc]
                                               for k, m in masks.items()})
        logits = torch.func.functional_call(model, params, (x,), kwargs)
        ce = _cross_entropy(logits, batch["y"])
        return torch.sum(ce * batch["mask"]) / global_count

    def step(params, opt_state, batch, dropout=None):
        global_count = torch.clamp(collectives.all_reduce(torch.sum(batch["mask"]), group),
                                   min=1.0)
        with collectives.bind(sp_axis, group):
            grads, loss = torch.func.grad_and_value(local_loss)(params, batch, global_count,
                                                                dropout)
        # each rank's gradient covers only its tokens' share: one sum of
        # every gradient and the loss, in one reduce of their concatenation
        flat = torch.cat([grads[k].reshape(-1) for k in names] + [loss.reshape(1)])
        flat = collectives.all_reduce(flat, group)
        summed, at = {}, 0
        for k in names:
            summed[k] = flat[at:at + grads[k].numel()].reshape(grads[k].shape)
            at += grads[k].numel()
        params, opt_state = optimizer.update(summed, opt_state, params)
        return params, opt_state, flat[at]

    return step


def shard_lm_batch(batch: dict, mesh: meshlib.RankMesh, sp_axis: str = SP_AXIS,
                   device=None) -> dict:
    """This rank's block of the token axis of a ``[B, T]`` batch (numpy
    arrays or tensors), on ``device``."""
    n = mesh.shape[sp_axis]
    idx = mesh.coord(sp_axis) if n > 1 else 0
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(v)
        t = v.shape[1]
        if t % n:
            raise ValueError(f"sequence length {t} does not split over the {n}-way "
                             f"'{sp_axis}' axis")
        out[k] = v[:, idx * (t // n):(idx + 1) * (t // n)].contiguous().to(device)
    return out
