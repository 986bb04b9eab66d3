"""Seeded weights on the device, in the port's parameter layout.

``param_shapes`` is a frozen copy of ``param_shapes`` in
``ray_tpu_torch/models/transformer.py``, taking a ``Shape``. ``draw``
makes every weight from the seed with one ``torch.Generator`` on the
device, one call per stacked leaf: normal(initializer_range) in fp32,
cast to the served dtype; norm weights are ones. The benchmark hands the same
tensors to the program, and draws them again for the reference once the
program's state is gone.
"""

from __future__ import annotations

import torch

from perfbench.accounting import Shape


def param_shapes(shape: Shape) -> dict:
    """Shape of every parameter, in the layout of ``init_params``."""
    D, Hd, F_, L, V = (shape.d_model, shape.attn_width, shape.d_ff,
                       shape.n_layers, shape.vocab)
    return {
        "embed": (V, D),
        "layers": {
            "attn_norm": (L, D), "wq": (L, D, Hd), "wk": (L, D, Hd),
            "wv": (L, D, Hd), "wo": (L, Hd, D), "mlp_norm": (L, D),
            "w_gate": (L, D, F_), "w_up": (L, D, F_), "w_down": (L, F_, D),
        },
        "final_norm": (D,),
    }


def draw(shape: Shape, seed: int, device, dtype=torch.bfloat16,
         std: float = 0.02) -> dict:
    """The parameter dict for ``seed``: the same seed gives the same
    tensors on the same device. ``std`` is the configuration's
    ``initializer_range``."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    shapes = param_shapes(shape)

    def w(dims):
        x = torch.empty(dims, dtype=torch.float32, device=device)
        return x.normal_(0.0, std, generator=gen).to(dtype)

    def ones(dims):
        return torch.ones(dims, dtype=dtype, device=device)

    layers = {name: (ones if name.endswith("norm") else w)(dims)
              for name, dims in shapes["layers"].items()}
    return {"embed": w(shapes["embed"]), "layers": layers,
            "final_norm": ones(shapes["final_norm"])}


def leaves(params: dict) -> list:
    """(name, tensor) of every leaf, in the dict's order: the order of
    the port's ``param_leaves``."""
    out = []
    for k, v in params.items():
        if isinstance(v, dict):
            out += [(f"{k}.{n}", t) for n, t in v.items()]
        else:
            out.append((k, v))
    return out
