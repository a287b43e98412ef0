"""Dropless MoE over grouped GEMMs (counterpart: ``paddle_tpu/incubate/nn/
functional/fused_moe.py`` ``fused_moe``).

The token rows are sorted by expert id (a stable sort, as ``jnp.argsort``),
each expert's rows multiply its own weights, and the outputs scatter back
weighted by the router's top-k probabilities. ``lax.ragged_dot``'s grouped
product is one ``matmul`` a group here, over row slices cut by the group
sizes: that reads the sizes to the host once a call (one device sync).
No capacity, no dropped token; differentiable end to end.
"""

from __future__ import annotations

import torch

__all__ = ["fused_moe"]


def _grouped_matmul(rows, w, sizes):
    """``lax.ragged_dot``: rows [N, K] in consecutive groups of ``sizes``
    (host ints), group e times w[e] [K, M] -> [N, M]."""
    outs = [part @ w[e] for e, part in enumerate(torch.split(rows, sizes))
            if sizes[e]]
    if not outs:
        return rows.new_zeros((rows.shape[0], w.shape[-1]))
    return torch.cat(outs)


def fused_moe(x, gate_weight, w1, b1, w2, b2, top_k: int = 2,
              activation=None, norm_topk_prob: bool = True):
    """x [T, D] (or [B, S, D]); gate_weight [D, E]; w1 [E, D, F]; b1 [E, F];
    w2 [E, F, D]; b2 [E, D]. Returns (out, router_probs [T, E] fp32). The
    default activation is the exact GELU, as the reference's."""
    if activation is None:
        from ....nn.functional.activation import gelu as activation
    orig_shape = x.shape
    d_model = x.shape[-1]
    xt = x.reshape(-1, d_model)
    t = xt.shape[0]
    num_experts = gate_weight.shape[1]

    probs = torch.softmax(xt.float() @ gate_weight.float(), dim=-1)
    top_w, top_i = torch.topk(probs, top_k, dim=-1)
    if norm_topk_prob:
        top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    flat_expert = top_i.reshape(-1)                          # [T * k]
    order = torch.argsort(flat_expert, stable=True)
    token_of = order // top_k
    xs = xt.index_select(0, token_of)                        # sorted rows
    expert_sorted = flat_expert.index_select(0, order)
    sizes = torch.bincount(flat_expert, minlength=num_experts).tolist()

    h = _grouped_matmul(xs, w1.to(xs.dtype), sizes)
    h = h + b1.to(xs.dtype).index_select(0, expert_sorted)
    h = activation(h)
    y = _grouped_matmul(h, w2.to(xs.dtype), sizes)
    y = y + b2.to(xs.dtype).index_select(0, expert_sorted)

    w_sorted = top_w.reshape(-1).index_select(0, order).to(y.dtype)
    out = y.new_zeros((t, d_model)).index_add(0, token_of,
                                              y * w_sorted[:, None])
    return out.reshape(orig_shape), probs
