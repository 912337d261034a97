"""Linear-chain CRF ops for sequence tagging.

Port of `analytics_zoo_tpu/ops/crf.py`: `_score_sequence` (L26),
`_log_partition` (L38, the forward algorithm: a logsumexp over time under
a mask), `crf_log_likelihood` (L59), `crf_loss` (L74) and
`viterbi_decode` (L80, the max-product recursion and its backtrack). The
JAX functions are `lax.scan`s; here the scans are Python loops over the
time axis of PyTorch ops, on the device of the emissions (inputs that are
not tensors are taken there). Gradients flow to the emissions and the
transitions.

Shapes: emissions [B, T, K], tags [B, T] int, transitions [K, K]
(transitions[i, j] scores a move from tag i to tag j), an optional mask
[B, T] (1 = a real step), whose padded steps pass the state through.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _inputs(emissions, transitions, mask, steps_shape):
    emissions = torch.as_tensor(emissions)
    transitions = torch.as_tensor(transitions, dtype=emissions.dtype,
                                  device=emissions.device)
    if mask is None:
        mask = torch.ones(steps_shape, dtype=emissions.dtype,
                          device=emissions.device)
    else:
        mask = torch.as_tensor(mask, device=emissions.device).to(
            emissions.dtype)
    return emissions, transitions, mask


def _score_sequence(emissions, tags, transitions, mask):
    """The unnormalized score of the given tag path."""
    emit = emissions.gather(2, tags.unsqueeze(-1)).squeeze(-1)     # [B, T]
    trans = transitions[tags[:, :-1], tags[:, 1:]]                 # [B, T-1]
    return (emit * mask).sum(dim=1) + (trans * mask[:, 1:]).sum(dim=1)


def _log_partition(emissions, transitions, mask):
    """The forward algorithm over time; masked steps pass through."""
    alpha = emissions[:, 0]
    for t in range(1, emissions.shape[1]):
        # alpha[b, i] + transitions[i, j] + emit[b, j], logsumexp over i
        scores = alpha[:, :, None] + transitions[None] \
            + emissions[:, t, None, :]
        alpha = torch.where(mask[:, t, None] > 0,
                            torch.logsumexp(scores, dim=1), alpha)
    return torch.logsumexp(alpha, dim=1)                            # [B]


def crf_log_likelihood(emissions, tags, transitions,
                       mask=None) -> torch.Tensor:
    """Per-sequence log p(tags | emissions); negate it for the loss."""
    emissions = torch.as_tensor(emissions)
    tags = torch.as_tensor(tags, device=emissions.device).long()
    emissions, transitions, mask = _inputs(emissions, transitions, mask,
                                           tags.shape)
    score = _score_sequence(emissions, tags, transitions, mask)
    return score - _log_partition(emissions, transitions, mask)


def crf_loss(emissions, tags, transitions, mask=None) -> torch.Tensor:
    """The mean negative log-likelihood (the training objective)."""
    return -crf_log_likelihood(emissions, tags, transitions, mask).mean()


def viterbi_decode(emissions, transitions, mask: Optional = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The best path of each sequence → (tags [B, T] int64, score [B]).
    Masked (padded) steps repeat the last real tag."""
    emissions = torch.as_tensor(emissions)
    b, steps, k = emissions.shape
    emissions, transitions, mask = _inputs(emissions, transitions, mask,
                                           (b, steps))
    identity = torch.arange(k, device=emissions.device)[None, :]
    delta = emissions[:, 0]
    backptrs = []
    for t in range(1, steps):
        scores = delta[:, :, None] + transitions[None]              # [B,K,K]
        best, best_prev = scores.max(dim=1)
        real = mask[:, t, None] > 0
        delta = torch.where(real, best + emissions[:, t], delta)
        # a masked step's backpointer is the identity
        backptrs.append(torch.where(real, best_prev, identity))
    score, last = delta.max(dim=1)
    tags = [last]
    for bp in reversed(backptrs):
        tags.append(bp.gather(1, tags[-1][:, None]).squeeze(1))
    return torch.stack(tags[::-1], dim=1), score
