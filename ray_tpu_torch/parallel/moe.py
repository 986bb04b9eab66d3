"""Expert parallelism: top-1 MoE dispatch/combine via all-to-all
(counterpart of ``ray_tpu/parallel/moe.py``).

Experts are sharded over a mesh axis; tokens are routed with a
capacity-bounded one-hot dispatch tensor and exchanged with one
``all_to_all`` each way. Static shapes throughout (dropped tokens pass
through on the residual path, standard Switch-Transformer behavior).

Call inside ``shard_map``; x: [T_local, D]; experts sharded so each rank
owns E_local = E / axis_size experts.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.parallel.collectives import all_to_all, axis_size


def _one_hot(idx, n):
    """float one-hot of ``idx`` over n classes; an index outside [0, n)
    gives a zero row, as ``jax.nn.one_hot``'s does."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def moe_dispatch_combine(x, gate_logits, expert_fn, expert_params, *,
                         axis: str = "tp", capacity_factor: float = 1.25):
    """Returns [T_local, D] combined expert outputs (0 for dropped).

    gate_logits: [T_local, E] (E = global expert count).
    expert_fn(params, xs): params for E_local experts with leading dim
    E_local; xs [E_local, cap_total, D] → [E_local, cap_total, D].
    """
    n = axis_size(axis)
    T, D = x.shape
    E = gate_logits.shape[-1]
    if E % n:
        raise ValueError(f"{E} experts not divisible by axis size {n}")
    cap = max(1, int(capacity_factor * T / E))

    gates = torch.softmax(gate_logits.float(), dim=-1)
    expert_idx = gates.argmax(dim=-1)                        # [T]
    gate_val = gates.amax(dim=-1)                            # [T]
    onehot = _one_hot(expert_idx, E)                         # [T,E]
    # position of each token within its expert's buffer
    pos = torch.cumsum(onehot, dim=0) * onehot - 1.0         # [T,E]
    keep = (pos < cap) & (onehot > 0)
    dispatch = _one_hot(pos.long(), cap) * keep[..., None]   # [T,E,cap]
    combine = dispatch * gate_val[:, None, None]             # [T,E,cap]

    xe = torch.einsum("tec,td->ecd", dispatch, x.float())
    # [E,cap,D] → exchange so each rank holds its E_local experts'
    # buffers from every rank: after the all-to-all the leading dim
    # indexes the SOURCE rank, so transpose to [E_local, n, cap, D]
    # before flattening the per-expert token dim.
    xe = xe.reshape(n, E // n, cap, D)
    xe = all_to_all(xe, axis, split_dim=0, concat_dim=0, tiled=False)
    xe = xe.transpose(0, 1).reshape(E // n, n * cap, D)
    ye = expert_fn(expert_params, xe.to(x.dtype))            # [E_l,n*cap,D]
    ye = ye.float().reshape(E // n, n, cap, D).transpose(0, 1)
    ye = all_to_all(ye, axis, split_dim=0, concat_dim=0, tiled=False)
    ye = ye.reshape(E, cap, D)
    out = torch.einsum("tec,ecd->td", combine, ye)
    return out.to(x.dtype)


def load_balance_loss(gate_logits, axis: str | None = None):
    """Switch-Transformer auxiliary loss: E * Σ_e f_e · p_e."""
    E = gate_logits.shape[-1]
    gates = torch.softmax(gate_logits.float(), dim=-1)
    dims = tuple(range(gates.dim() - 1))
    frac = _one_hot(gates.argmax(dim=-1), E).mean(dim=dims)
    prob = gates.mean(dim=dims)
    return E * torch.sum(frac * prob)
