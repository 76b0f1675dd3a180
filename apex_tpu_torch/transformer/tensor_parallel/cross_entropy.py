"""Vocab-parallel cross entropy at world size 1
(``apex_tpu/transformer/tensor_parallel/cross_entropy.py``).

The unfused twin of the fused LM-head loss (GPT's ``fused_lm_head=False``
route): per-token loss from materialized logits ``[..., V]`` and integer
targets, with optional label smoothing. The backward recomputes the
softmax from the saved row max and sum-exp and returns the logits'
gradient in the logits' dtype, as the JAX package's custom VJP does. Plain
PyTorch: the JAX function is plain ``jnp``, with no kernel of its own.
Vocab parallelism (world > 1) comes with the model-parallel slice.
"""

from __future__ import annotations

import torch


def _core(logits, target):
    part_v = logits.shape[-1]
    lmax = logits.amax(dim=-1).float()
    t = target.long()
    in_range = (t >= 0) & (t < part_v)
    local_t = torch.where(in_range, t, torch.zeros_like(t))
    pred = (logits.gather(-1, local_t[..., None])[..., 0].float() - lmax)
    pred = torch.where(in_range, pred, torch.zeros_like(pred))
    sum_exp = torch.exp(logits.float() - lmax[..., None]).sum(dim=-1)
    loss = torch.log(sum_exp) - pred
    return loss, lmax, sum_exp, in_range, local_t


class _VocabParallelCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, target, label_smoothing):
        loss, lmax, sum_exp, in_range, local_t = _core(logits, target)
        if label_smoothing > 0.0:
            vocab = logits.shape[-1]
            shifted_sum = (logits.float() - lmax[..., None]).sum(dim=-1)
            mean_logp = shifted_sum / vocab - torch.log(sum_exp)
            loss = (1.0 - label_smoothing) * loss - label_smoothing * mean_logp
        ctx.save_for_backward(logits, lmax, sum_exp, in_range, local_t)
        ctx.label_smoothing = label_smoothing
        return loss

    @staticmethod
    def backward(ctx, dloss):
        logits, lmax, sum_exp, in_range, local_t = ctx.saved_tensors
        part_v = logits.shape[-1]
        softmax = (torch.exp(logits.float() - lmax[..., None])
                   / sum_exp[..., None])
        one_hot = torch.nn.functional.one_hot(local_t, part_v).float()
        one_hot = one_hot * in_range[..., None]
        ls = ctx.label_smoothing
        target = ((1.0 - ls) * one_hot + ls / part_v) if ls > 0.0 \
            else one_hot
        grad = (softmax - target) * dloss[..., None].float()
        return grad.to(logits.dtype), None, None


def vocab_parallel_cross_entropy(vocab_parallel_logits, target,
                                 label_smoothing: float = 0.0,
                                 axis_name=None):
    """Per-token fp32 loss from logits ``[..., V]`` and targets ``[...]``
    (world size 1: ``axis_name`` is accepted and names nothing)."""
    del axis_name
    return _VocabParallelCE.apply(vocab_parallel_logits, target,
                                  float(label_smoothing))
