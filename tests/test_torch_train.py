"""Parity of the port's training path (loss, gradients, remat, optimizer,
train step) with the JAX package's.

The JAX package initialises the params and ``params_from_jax`` carries
them across; the same numpy tokens and gradients go through both. Both
run on the CPU, where attention takes the plain path under autograd
(the kernels' backward is in tests/test_torch_flash_bwd.py).

Tolerances, with their reasons:
* loss and every gradient leaf: fp32 1e-4, the whole-model tolerance of
  tests/test_torch_models.py, relative to the leaf's largest magnitude
  (the embedding gradient sums every token's contribution); bf16 loss
  6e-2;
* the remat policies change only what is saved, so they agree to 1e-6;
* the optimizer on the same gradients: fp32 atol 1e-6 (Adam's update
  divides by sqrt(nu), rounding in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from ray_tpu.models import transformer as jtfm
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import transformer as ttfm

MODEL_TOL = 1e-4
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
SHAPE = dict(vocab=97, d_model=64, n_heads=4, n_layers=2, d_ff=128,
             max_seq=64)
# (key, layer key) of every param leaf in the port's param_leaves order;
# a JAX tree that went through jax.tree has its keys sorted instead
KEYS = [(k, kk) for k, v in ttfm.param_shapes(
    ttfm.TransformerConfig(**SHAPE)).items()
    for kk in (v if isinstance(v, dict) else [None])]


def _models(dt):
    jdt, tdt = DTYPES[dt]
    jcfg = jtfm.TransformerConfig(dtype=jdt, **SHAPE)
    tcfg = ttfm.TransformerConfig(dtype=tdt, **SHAPE)
    jparams = jtfm.init_params(jax.random.key(0), jcfg)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                      tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _batch(seed=3, B=2, T=32):
    seq = np.random.default_rng(seed).integers(0, SHAPE["vocab"],
                                               (B, T + 1))
    return ({"tokens": jnp.asarray(seq[:, :-1]),
             "targets": jnp.asarray(seq[:, 1:])},
            {"tokens": torch.from_numpy(seq[:, :-1]),
             "targets": torch.from_numpy(seq[:, 1:])})


def _jax_leaves(tree):
    """A JAX param tree's leaves in the port's ``param_leaves`` order."""
    return [np.asarray(tree[k] if kk is None else tree[k][kk], np.float32)
            for k, kk in KEYS]


def _jax_tree(leaves):
    """Port-ordered leaves put back into a JAX param tree."""
    tree = {}
    for (k, kk), x in zip(KEYS, leaves):
        if kk is None:
            tree[k] = jnp.asarray(x)
        else:
            tree.setdefault(k, {})[kk] = jnp.asarray(x)
    return tree


def _close_leaf(got, want, tol):
    want = np.asarray(want, np.float32)
    err = np.abs(got.detach().float().numpy() - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-12), (err, tol)


def _loss_and_grads(params, batch, cfg, pcfg=ttfm.ParallelConfig()):
    def leaf(p):
        return p.detach().clone().requires_grad_()

    tree = {k: ({kk: leaf(p) for kk, p in v.items()}
                if isinstance(v, dict) else leaf(v))
            for k, v in params.items()}
    loss = ttfm.loss_fn(tree, batch, cfg, pcfg)
    return loss, torch.autograd.grad(loss, ttfm.param_leaves(tree))


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_loss_and_grads_match_jax(dt):
    jcfg, jparams, tcfg, tparams = _models(dt)
    jbatch, tbatch = _batch()
    loss, grads = _loss_and_grads(tparams, tbatch, tcfg)
    assert loss.dim() == 0 and loss.dtype == torch.float32
    assert [g.dtype for g in grads] == [tcfg.dtype] * 11
    loss = loss.item()
    if dt == "bf16":   # the loss only: bf16 gradients round per framework
        jloss = jax.jit(jtfm.loss_fn, static_argnums=2)(jparams, jbatch,
                                                         jcfg)
        assert abs(loss - float(jloss)) <= 6e-2
        return
    jloss, jgrads = jax.jit(jax.value_and_grad(jtfm.loss_fn),
                            static_argnums=2)(jparams, jbatch, jcfg)
    assert abs(loss - float(jloss)) <= MODEL_TOL * abs(float(jloss))
    want = _jax_leaves(jgrads)
    assert len(grads) == len(want) == 11
    for g, w in zip(grads, want):
        _close_leaf(g, w, MODEL_TOL)


def test_remat_policies_agree_and_differ_in_recompute():
    _, _, tcfg, tparams = _models("f32")
    _, tbatch = _batch(seed=4)
    flops, results = {}, {}
    for policy in (None, "full", "dots", "dots_no_batch"):
        pcfg = ttfm.ParallelConfig(remat=policy is not None,
                                   remat_policy=policy or "full")
        with FlopCounterMode(display=False) as counter:
            results[policy] = _loss_and_grads(tparams, tbatch, tcfg, pcfg)
        flops[policy] = counter.get_total_flops()
    loss0, grads0 = results[None]
    for loss, grads in results.values():
        assert abs(loss.item() - loss0.item()) <= 1e-6
        for g, g0 in zip(grads, grads0):
            torch.testing.assert_close(g, g0, atol=1e-6, rtol=1e-6)
    # "full" recomputes every matmul of the layers, "dots_no_batch" only
    # the attention einsums (bmm), "dots" none of them
    assert flops["full"] > flops["dots_no_batch"] > flops["dots"]
    assert flops["dots"] == flops[None]
    with pytest.raises(ValueError, match="remat_policy"):
        ttfm.ParallelConfig(remat=True, remat_policy="offload")
    # without an sp axis, attn "ring"/"ulysses" run local flash attention
    # (the reference's _attend), and num_microbatches is unused without pp
    local = _loss_and_grads(tparams, tbatch, tcfg,
                            ttfm.ParallelConfig(attn="local"))
    for pcfg in (ttfm.ParallelConfig(attn="ring"),
                 ttfm.ParallelConfig(attn="ulysses", num_microbatches=4)):
        loss, grads = _loss_and_grads(tparams, tbatch, tcfg, pcfg)
        assert loss.item() == local[0].item()
        assert all(torch.equal(g, g0) for g, g0 in zip(grads, local[1]))
    with pytest.raises(ValueError, match="attn"):
        ttfm.ParallelConfig(attn="sparse")
    assert ttfm.ParallelConfig(attn="local").remat is False


def test_optimizer_matches_optax_adamw_on_the_same_grads():
    _, jparams, tcfg, tparams = _models("f32")
    rng = np.random.default_rng(7)
    grads = [[rng.standard_normal(x.shape).astype(np.float32) * 10.0 ** -e
              for x in _jax_leaves(jparams)] for e in (2, 3, 1)]
    tx = optax.adamw(3e-4)
    jp = jparams
    state = tx.init(jp)
    opt = ttfm.AdamW().init(tparams)
    leaves = ttfm.param_leaves(tparams)
    for step_grads in grads:
        updates, state = tx.update(_jax_tree(step_grads), state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, g in zip(leaves, step_grads):
            p.grad = torch.from_numpy(g)
        opt.step()
        for p, w in zip(leaves, _jax_leaves(jp)):
            np.testing.assert_allclose(p.detach().numpy(), w, atol=1e-6,
                                       rtol=0)
    mu = _jax_leaves(state[0].mu)
    for p, w in zip(leaves, mu):
        np.testing.assert_allclose(opt.state[p]["exp_avg"].numpy(), w,
                                   atol=1e-6, rtol=0)
        assert opt.state[p]["exp_avg"].dtype == p.dtype


def test_train_step_losses_match_jax_train_step():
    jcfg, jparams, tcfg, tparams = _models("f32")
    jbatch, tbatch = _batch(seed=5)
    jstep, jopt = jtfm.make_train_step(jcfg, jtfm.ParallelConfig())
    jstate = jopt.init(jparams)
    step, opt = ttfm.make_train_step(tcfg, ttfm.ParallelConfig(remat=True))
    state = opt.init(tparams)
    for _ in range(3):
        jparams, jstate, jloss = jstep(jparams, jstate, jbatch)
        params, state, loss = step(tparams, state, tbatch)
        assert params is tparams and loss.dim() == 0
        assert not loss.requires_grad
        # Adam's first update is ~lr * sign(g), so the params after a step
        # are a poor check where g ~ 0; the loss is not
        assert abs(float(loss) - float(jloss)) <= MODEL_TOL * float(jloss)
    with pytest.raises(TypeError, match="DeviceMesh"):
        ttfm.make_train_step(tcfg, mesh=object())
