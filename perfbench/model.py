"""A configuration file read as the port runs it and as the yardstick
counts it. Its ``port`` entries are the port's ``TransformerConfig``
fields (any the class does not have are the reference's, such as
``rms_norm_eps``); its ``reference`` names the plain reference,
``reference/<name>.py``, which also holds the parameter layout that
both sides take."""

from __future__ import annotations

import dataclasses
import importlib

import torch

from perfbench.accounting import Shape

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def shape_of(config: dict) -> Shape:
    p = config["port"]
    return Shape(vocab=int(p["vocab"]), d_model=int(p["d_model"]),
                 n_heads=int(p["n_heads"]),
                 head_dim=int(p["d_model"]) // int(p["n_heads"]),
                 n_layers=int(p["n_layers"]), d_ff=int(p["d_ff"]))


def port_config(config: dict):
    """The port's ``TransformerConfig`` for a configuration: every
    ``port`` entry that is one of its fields."""
    from ray_tpu_torch.models.transformer import TransformerConfig

    fields = {f.name for f in dataclasses.fields(TransformerConfig)}
    kw = {k: v for k, v in config["port"].items() if k in fields}
    kw["dtype"] = DTYPES[kw["dtype"]]
    return TransformerConfig(**kw)


def reference_of(config: dict):
    """The configuration's plain reference module."""
    return importlib.import_module(f"perfbench.reference.{config['reference']}")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def free_device_memory(device) -> None:
    import gc

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def draw_weights(config: dict, seed: int, device) -> dict:
    """The configuration's weights for a seed, in the layout of its
    reference (``draw_weights`` there)."""
    return reference_of(config).draw_weights(
        shape_of(config), seed, device, DTYPES[config["port"]["dtype"]],
        std=float(config["initializer_range"]))
