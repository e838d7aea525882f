"""Loss functions: token cross-entropy with z-loss, the MoE auxiliary
weighting and the multi-token-prediction head (counterpart of
``repro.train.losses``).

``torch.gather`` takes int64 indices where ``jnp.take_along_axis`` takes
the pipeline's int32 targets, so targets are widened first.

Inside a batch-sharded train step (``repro_torch.dist.constraints
.batch_block``) each rank holds a block of the batch, and a mean over the
batch is this rank's SHARE of the global one (:func:`batch_mean`): its
own sum over the count of the whole batch, the count summed over the
batch axes in a fixed order (``Mesh.psum``).  The shares add up to the
global mean, and so do their grads; the step sums both over the batch
axes.  A mean of per-rank means would weigh a rank's rows by how few
``loss_mask`` kept.
"""

from __future__ import annotations

import torch

from repro_torch.dist import tensor_parallel as TP
from repro_torch.dist.constraints import current_block

MOE_LB_WEIGHT = 0.01
MOE_Z_WEIGHT = 1e-4
MTP_WEIGHT = 0.3
Z_LOSS_WEIGHT = 1e-4


def batch_mean(values, mask=None):
    """The mean of ``values`` over the positions ``mask`` keeps (all of
    them without one); inside a batch block, this rank's share of the
    mean over the whole batch (module docstring)."""
    blk = current_block()
    if blk is None:
        if mask is None:
            return values.mean()
        return (values * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    if mask is None:
        total, count = values.sum(), torch.full(
            (1,), values.numel(), dtype=torch.float32, device=values.device)
    else:
        total, count = (values * mask).sum(), mask.sum().float().reshape(1)
    count = blk.mesh.psum(count.detach(), blk.axes)[0]
    return total / torch.clamp(count, min=1.0)


def softmax_xent(logits, targets, mask=None):
    """Mean CE over the (optionally masked) positions, plus the z-loss;
    logits promoted to float32.  Where ``logits`` are this rank's columns
    of the vocabulary (the train step under ``tp``), the loss is the same
    on every ``model`` rank: the max over ``model``, the exp-sums summed
    over it, and the gold logit from the rank that owns it (zeros
    elsewhere, summed), in forward and backward."""
    logits = logits.float()
    lo = TP.vocab_first(logits.shape[-1])
    if lo is None:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    else:
        top = TP.pmax(logits.amax(-1))
        logz = torch.log(TP.leave(torch.exp(logits - top[..., None])
                                  .sum(-1))) + top
        local = targets.long() - lo
        inside = (local >= 0) & (local < logits.shape[-1])
        gold = torch.gather(logits, -1, torch.where(inside, local, 0)
                            [..., None])[..., 0]
        gold = TP.leave(torch.where(inside, gold, 0.0))
    return batch_mean(logz - gold + Z_LOSS_WEIGHT * logz ** 2, mask)


def train_loss(logits, aux, batch):
    """Total loss: CE + MoE aux + MTP (predicting t+2 where defined); the
    MoE and MTP terms are driven by the keys of ``aux``, which the dense
    family leaves empty.  Returns ``(loss, metrics)``."""
    loss = softmax_xent(logits, batch["targets"], batch.get("loss_mask"))
    metrics = {"ce": loss}
    if "moe_lb" in aux:
        loss = loss + MOE_LB_WEIGHT * aux["moe_lb"] \
            + MOE_Z_WEIGHT * aux["moe_z"]
        metrics["moe_lb"] = aux["moe_lb"]
    if "mtp_logits" in aux:
        # The MTP head at position t predicts token t+2 = targets shifted
        # by one; the last position has no such target.
        t2 = torch.roll(batch["targets"], -1, dims=1)
        mask = torch.ones(t2.shape, dtype=torch.float32, device=t2.device)
        mask[:, -1] = 0.0
        if "loss_mask" in batch:
            mask = mask * batch["loss_mask"]
        mtp = softmax_xent(aux["mtp_logits"], t2, mask)
        loss = loss + MTP_WEIGHT * mtp
        metrics["mtp_ce"] = mtp
    metrics["loss"] = loss
    return loss, metrics
