"""Training step: next-token cross-entropy + AdamW, the port's counterpart of
``repro.training.train``.

``make_train_step`` differentiates the loss with ``torch.autograd.grad``
with respect to detached copies of the parameter leaves (no copy of the
data), then updates the parameters and moments in place
(``adamw_update``).  The forward is the model's training path
(``Model.hidden``): plain attention and the plain chunkwise mLSTM, no
kernel, as the JAX package trains.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.models import Model
from repro_torch.models.shardlib import local_call
from repro_torch.models.ssm import divisor_chunk
from repro_torch.training.optimizer import AdamState, AdamWConfig, adamw_update
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def lm_loss(logits, tokens, loss_mask=None, moe_aux=0.0, aux_w: float = 0.01):
    """Shifted next-token CE.  logits: (B,S,V); tokens: (B,S)."""
    tgt = tokens[:, 1:].long()
    lg = logits[:, :-1].float()
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.take_along_dim(lg, tgt[..., None], dim=-1)[..., 0]
    nll = logz - gold
    if loss_mask is not None:
        msk = loss_mask[:, 1:].float()
        loss = (nll * msk).sum() / torch.clamp(msk.sum(), min=1.0)
    else:
        loss = nll.mean()
    return loss + aux_w * moe_aux


def _chunk_nll(x_c, head, t_c, m_c):
    """Summed masked NLL of one sequence chunk: the (B,c,V) float32 logits
    exist only inside this call.  On DTensors each batch shard sums its own
    rows against the whole head (gathered), and the sum over the shards is
    DTensor's reduction."""
    if isinstance(x_c, DTensor):
        rows = local_call(_rows_nll, "bsd,~,bs,bs->b", x_c, head, t_c, m_c,
                          keep="b")
        return rows.sum()
    # float32 products of the (bf16) inputs, as JAX's einsum with
    # preferred_element_type=float32: the logits are never rounded to bf16
    lg = x_c.float() @ head.float()
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.take_along_dim(lg, t_c[..., None], dim=-1)[..., 0]
    return torch.sum((logz - gold) * m_c)


def _rows_nll(x_c, head, t_c, m_c):
    """Per-row summed masked NLL (B,) of one chunk."""
    lg = x_c.float() @ head.float()
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.take_along_dim(lg, t_c[..., None], dim=-1)[..., 0]
    return torch.sum((logz - gold) * m_c, dim=-1)


def chunked_lm_loss(
    x, head, tokens, loss_mask=None, moe_aux=0.0, aux_w: float = 0.01,
    chunk: int = 512,
):
    """Shifted next-token CE with a CHUNKED vocab projection.

    ``x``: final-normed hidden (B,S,D); ``head``: (D,V).  The chunk is
    JAX's (``divisor_chunk``: near ``chunk``, dividing S).  Each chunk's
    projection is recomputed in the backward pass
    (``torch.utils.checkpoint``), so only one chunk's (B,chunk,V) logits
    are alive at a time.  Numerics as ``lm_loss``.
    """
    b, s, _ = x.shape
    # targets shifted left; the final position is masked out
    tgt = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1).long()
    if loss_mask is None:
        msk = torch.ones((b, s), dtype=torch.float32, device=x.device)
    else:
        msk = loss_mask.float()
    msk = torch.cat(
        [msk[:, 1:], torch.zeros((b, 1), dtype=torch.float32,
                                 device=x.device)], dim=1
    )
    c = divisor_chunk(s, chunk)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, c):
        sl = slice(c0, c0 + c)
        tot = tot + checkpoint(_chunk_nll, x[:, sl], head, tgt[:, sl],
                               msk[:, sl], use_reentrant=False)
    return tot / torch.clamp(msk.sum(), min=1.0) + aux_w * moe_aux


def make_train_step(model: Model, opt_cfg: AdamWConfig):
    """Returns train_step(params, opt, batch) -> (params, opt, metrics).

    ``batch``: {"tokens": (B,S) int, optional "embeds", optional
    "loss_mask": (B,S)}, tensors on the model's device.  The parameters and
    the optimizer's moments are updated in place; the returned trees are
    the ones passed in.  metrics: ``loss``, ``grad_norm``, ``lr`` (0-d
    tensors on the device; no host sync).
    """

    def loss_fn(params, batch):
        x, aux = model.hidden(params, batch)
        return chunked_lm_loss(
            x,
            model.head_matrix(params),
            batch["tokens"],
            batch.get("loss_mask"),
            moe_aux=aux,
        )

    def train_step(params, opt_state: AdamState, batch):
        # the leaves detached (the same storage), as autograd's inputs
        tree = tree_map(lambda p: p.detach().requires_grad_(True), params)
        leaves = tree_leaves(tree)
        with torch.enable_grad():
            loss = loss_fn(tree, batch)
        grads = torch.autograd.grad(loss, leaves)
        # a sharded plan's gradients take their parameters' layout (a
        # reduction over the shards that computed partial sums)
        grads = [g.redistribute(p.device_mesh, p.placements)
                 if isinstance(g, DTensor) else g
                 for g, p in zip(grads, leaves)]
        del tree, leaves
        grads = tree_unflatten(params, grads)
        params, opt_state, metrics = adamw_update(
            opt_cfg, grads, opt_state, params
        )
        loss = loss.detach()
        if isinstance(loss, DTensor):
            loss = loss.full_tensor()
        metrics = dict(metrics, loss=loss)
        return params, opt_state, metrics

    return train_step


def make_eval_step(model: Model):
    @torch.no_grad()
    def eval_step(params, batch):
        logits, aux = model.forward(params, batch)
        return lm_loss(logits, batch["tokens"], batch.get("loss_mask"),
                       moe_aux=aux)

    return eval_step
