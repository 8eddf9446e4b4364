"""The Switch-Transformer mixture-of-experts FFN, plain PyTorch.

Counterpart of the JAX package's `models/moe.py` (`MoEMLP`, :50-121), the
third `DenoiserConfig.mlp_class` ("moe"): a float32 router with no bias,
top-1 routing (gate = the largest softmax probability), a per-expert
capacity C = max(1, ceil(S * capacity_factor / E)) from static shapes,
1-based positions in each expert from a cumulative sum over the tokens of
each batch element, tokens past capacity dropped (output 0, so they ride
the block's residual), and dense one-hot dispatch and combine products
around the per-expert Dense -> GELU -> Dense. As in JAX the expert GELU is
the tanh approximation (`nn.gelu`'s default), not the exact erf of the
dense FFNs. Capacity is per batch element, so an image's output depends on
the other tokens of its own image only.

The reference torch denoiser has no MoE, so the port defines the
parameter layout, with the JAX leaves' names and shapes: `router.weight`
(E, D) (an `nn.Linear`, the JAX kernel transposed), `wi` (E, D, H), `bi`
(E, H), `wo` (E, H, D), `bo` (E, D).

After each forward the module keeps the Switch load-balancing loss
E * sum_e f_e p_e as `aux_loss` (a tensor in the autograd graph) and the
per-expert routed fractions f_e as `load` (detached), where the JAX
module sows them into its "losses" and "moe_metrics" collections. Expert
parallelism is not ported (ROADMAP item 14).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def expert_capacity(tokens: int, n_experts: int, capacity_factor: float) -> int:
    """C = max(1, ceil(S * capacity_factor / E)), the JAX package's formula."""
    return max(1, int(math.ceil(tokens * capacity_factor / n_experts)))


class MoEMLP(nn.Module):
    """Top-1-routed MoE FFN: router -> dispatch -> per-expert
    Dense/GELU/Dense -> combine. (B, S, D) -> (B, S, D) in `dtype`."""

    def __init__(self, embed_dim: int, mlp_multiplier: int,
                 dtype=torch.float32, n_experts: int = 8,
                 capacity_factor: float = 1.25):
        super().__init__()
        hidden = mlp_multiplier * embed_dim
        self.dtype = dtype
        self.n_experts = n_experts
        self.capacity_factor = capacity_factor
        self.router = nn.Linear(embed_dim, n_experts, bias=False)
        self.wi = nn.Parameter(torch.empty(n_experts, embed_dim, hidden))
        self.bi = nn.Parameter(torch.zeros(n_experts, hidden))
        self.wo = nn.Parameter(torch.empty(n_experts, hidden, embed_dim))
        self.bo = nn.Parameter(torch.zeros(n_experts, embed_dim))
        self.aux_loss: Optional[torch.Tensor] = None
        self.load: Optional[torch.Tensor] = None

    def __getstate__(self):
        # the last forward's loss and load are not the module's state (and a
        # non-leaf tensor would stop copy.deepcopy)
        return {**self.__dict__, "aux_loss": None, "load": None}

    def route(self, x):
        """(gate (B, S), dispatch (B, S, E, C) float32 one-hot, probs
        (B, S, E), mask (B, S, E)) of the tokens x."""
        s, e = x.shape[1], self.n_experts
        c = expert_capacity(s, e, self.capacity_factor)
        logits = x.float() @ self.router.weight.float().T
        probs = torch.softmax(logits, dim=-1)
        gate, idx = probs.max(dim=-1)  # the first of equal maxima, as argmax
        mask = F.one_hot(idx, e).float()
        pos = torch.cumsum(mask, dim=1) * mask  # 1-based, 0 where unrouted
        keep = (pos > 0) & (pos <= c)
        slot = (pos - 1).clamp(0, c - 1).long()
        dispatch = F.one_hot(slot, c).float() * keep[..., None].float()
        return gate, dispatch, probs, mask

    def forward(self, x):
        e = self.n_experts
        gate, dispatch, probs, mask = self.route(x)
        f_e = mask.mean(dim=(0, 1))
        p_e = probs.mean(dim=(0, 1))
        self.aux_loss = e * torch.sum(f_e * p_e)
        self.load = f_e.detach()
        combine = gate[:, :, None, None] * dispatch
        dt = self.dtype
        xin = torch.einsum("bsec,bsd->ebcd", dispatch.to(dt), x.to(dt))
        hid = torch.einsum("ebcd,edh->ebch", xin, self.wi.to(dt))
        hid = F.gelu(hid + self.bi.to(dt)[:, None, None, :], approximate="tanh")
        out = torch.einsum("ebch,ehd->ebcd", hid, self.wo.to(dt))
        out = out + self.bo.to(dt)[:, None, None, :]
        y = torch.einsum("bsec,ebcd->bsd", combine.to(dt), out)
        return y.to(dt)
