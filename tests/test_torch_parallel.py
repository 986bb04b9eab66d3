"""Parity of the port's parallel layer (ray_tpu_torch.parallel) and its
mesh train step with the JAX package's.

The multi-rank cases run once, in one module-scoped ``run_spmd`` over 8
gloo ranks on the CPU (``_rank_cases``), each on a 4-axis mesh of the 8
ranks whose other axes only replicate the work; every rank returns numpy
results and each case is then its own test. The JAX side runs in this
process as tests/test_parallel.py runs it, on conftest's 8 virtual CPU
devices: its single-device oracles, or ``shard_map`` for the
collectives' gradients. Inputs come from numpy seeds (the train step's
params from the JAX init, carried across by ``params_from_jax``).

Tolerances are tests/test_parallel.py's fp32 ones: ring and Ulysses
2e-4/2e-5; the pipeline and MoE 1e-5/1e-6 (pipeline grads 1e-4/1e-5);
the train step's loss rtol 1e-4 and its updated params 1e-3/1e-5. The
collectives' gradients are the same ops in another order: 1e-5/1e-6.

JAX is imported inside the tests only: the spawned ranks import this
module to find ``_rank_cases`` and must not load JAX.
"""

import functools
import math
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import transformer as ttfm
from ray_tpu_torch.parallel import collectives as tcol
from ray_tpu_torch.parallel import launch, mesh as tmesh, sharding
from ray_tpu_torch.parallel import (moe_dispatch_combine, pipeline_spmd,
                                    ring_attention, shard_map,
                                    ulysses_attention)
from ray_tpu_torch.parallel.sharding import P

N_RANKS = 8
MESHES = {   # the 8 ranks as (dp, pp, sp, tp)
    "sp4": tmesh.MeshConfig(dp=2, sp=4),
    "pp4": tmesh.MeshConfig(dp=2, pp=4),
    "all2": tmesh.MeshConfig(dp=1, pp=2, sp=2, tp=2),
    "dp2": tmesh.MeshConfig(dp=2, pp=2, sp=1, tp=2),
}
TRAIN_MESHES = ("all2", "dp2")   # tests/test_parallel.py:190-193
TRAIN_CFG = dict(vocab=32, d_model=32, n_heads=4, n_layers=4, d_ff=32,
                 max_seq=16)
TRAIN_B, TRAIN_T, TRAIN_LR = 4, 16, 0.1
# each collective on the 4-rank sp axis of "sp4", on a [2, 4, 6] block
COLLECTIVES = {
    "psum": lambda c, x: c.psum(x, "sp"),
    "pmean": lambda c, x: c.pmean(x, "sp"),
    "all_gather": lambda c, x: c.all_gather(x, "sp", gather_dim=2),
    "psum_scatter": lambda c, x: c.psum_scatter(x, "sp", scatter_dim=1),
    "all_to_all": lambda c, x: c.all_to_all(x, "sp", split_dim=1,
                                            concat_dim=2),
    # MoE's call (moe.py:56-58); JAX's transpose of an untiled
    # all_to_all fails its own shape check when split != concat
    "all_to_all_untiled": lambda c, x: c.all_to_all(
        x.reshape(4, 2, 6), "sp", split_dim=0, concat_dim=0, tiled=False),
    "ppermute_ring": lambda c, x: c.ppermute_ring(x, "sp"),
    "tp_copy": lambda c, x: c.tp_copy(x, "sp"),
    "tp_allreduce": lambda c, x: c.tp_allreduce(x, "sp"),
    "broadcast_from": lambda c, x: c.broadcast_from(x, "sp", root=2),
}


def _pcfg(mcfg, mod):
    """tests/test_parallel.py's ParallelConfig for a mesh, in ``mod``."""
    return mod.ParallelConfig(dp="dp" if mcfg.dp > 1 else None,
                              pp="pp" if mcfg.pp > 1 else None,
                              sp="sp" if mcfg.sp > 1 else None,
                              tp="tp" if mcfg.tp > 1 else None,
                              attn="ring" if mcfg.sp > 1 else "local",
                              num_microbatches=2)


def _rng_arrays(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in shapes]


def _stage(wl, h):
    # wl arrives [1, Din, Din] per rank (pp-sharded leading dim)
    return torch.tanh(h @ wl[0])


def _scaled_experts(params, xs):
    return xs * params[:, None, None]


def _identity_experts(params, xs):
    del params
    return xs


def _collective_grad(fn, x):
    x = x.clone().requires_grad_()
    y = fn(tcol, x)
    loss = (1.0 + tcol.axis_index("sp")) * (y * y).sum()
    return torch.autograd.grad(loss, x)[0]


def _pipeline_grad(w, x):
    w = w.clone().requires_grad_()
    out = pipeline_spmd(_stage, w, x, axis="pp", num_microbatches=2)
    # every pp rank computes this same loss; the psum's transpose sums
    # the redundant copies' cotangents, so divide by the pp size
    loss = (out * out).sum() / 2
    return torch.autograd.grad(loss, w)[0]


def _train(mesh, inp, name):
    cfg = ttfm.TransformerConfig(dtype=torch.float32, **TRAIN_CFG)
    pcfg = _pcfg(MESHES[name], ttfm)
    params = convert.shard_params(
        convert.params_from_jax(inp["params"], cfg, device="cpu"), pcfg,
        mesh)
    step, opt = ttfm.make_train_step(cfg, pcfg, mesh=mesh,
                                     optimizer=ttfm.SGD(TRAIN_LR))
    state = opt.init(params)
    batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
    _, _, l1 = step(params, state, batch)
    local = [p.detach().numpy().copy() for p in ttfm.param_leaves(params)]
    full = convert.gather_params(params, pcfg, mesh)
    _, _, l2 = step(params, state, batch)
    return {"losses": [l1.item(), l2.item()], "local": local,
            "coords": {a: mesh.get_local_rank(a) for a in tmesh.AXES},
            "full": {k: {kk: x.numpy() for kk, x in v.items()}
                     if isinstance(v, dict) else v.numpy()
                     for k, v in full.items()}}


def _rank_cases(rank, inp):
    """Every multi-rank case on this rank; numpy results by case."""
    del rank
    meshes = {k: tmesh.build_mesh(m, device_type="cpu")
              for k, m in MESHES.items()}
    t = {k: torch.from_numpy(v) for k, v in inp.items()
         if isinstance(v, np.ndarray)}
    out = {}
    seq = P(None, "sp")
    for causal in (True, False):
        fn = shard_map(functools.partial(ring_attention, axis="sp",
                                         causal=causal),
                       mesh=meshes["sp4"], in_specs=(seq,) * 3,
                       out_specs=seq, check_vma=False)
        out[f"ring_{causal}"] = fn(*t["ring"]).numpy()
    fn = shard_map(functools.partial(ulysses_attention, axis="sp",
                                     causal=True),
                   mesh=meshes["all2"], in_specs=(seq,) * 3, out_specs=seq)
    out["ulysses"] = fn(*t["ulysses"]).numpy()
    fn = shard_map(functools.partial(pipeline_spmd, _stage, axis="pp",
                                     num_microbatches=4),
                   mesh=meshes["pp4"], in_specs=(P("pp"), P(None)),
                   out_specs=P(None))
    out["pipeline"] = fn(t["pipe_w"], t["pipe_x"]).numpy()
    fn = shard_map(_pipeline_grad, mesh=meshes["all2"],
                   in_specs=(P("pp"), P(None)), out_specs=P("pp"))
    out["pipeline_grad"] = fn(t["pipe2_w"], t["pipe2_x"]).numpy()
    body = functools.partial(moe_dispatch_combine, axis="tp",
                             capacity_factor=8.0)
    fn = shard_map(lambda x, g, s: body(x, g, _scaled_experts, s),
                   mesh=meshes["all2"], in_specs=P("tp"), out_specs=P("tp"))
    out["moe_scaled"] = fn(t["moe_x"], t["moe_logits"],
                           t["moe_scales"]).numpy()
    fn = shard_map(lambda x, g: body(x, g, _identity_experts, None),
                   mesh=meshes["all2"], in_specs=P("tp"), out_specs=P("tp"))
    out["moe_identity"] = fn(t["moe_x"], t["moe_logits"]).numpy()
    for name, coll in COLLECTIVES.items():
        fn = shard_map(functools.partial(_collective_grad, coll),
                       mesh=meshes["sp4"], in_specs=P("sp"),
                       out_specs=P("sp"))
        out[f"grad_{name}"] = fn(t["coll_x"]).numpy()
    for name in TRAIN_MESHES:
        out[f"train_{name}"] = _train(meshes[name], inp["train"], name)
    return out


@pytest.fixture(scope="module")
def inputs():
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import transformer as jtfm

    jcfg = jtfm.TransformerConfig(dtype=jnp.float32, **TRAIN_CFG)
    params = jax.tree.map(np.asarray,
                          jtfm.init_params(jax.random.key(5), jcfg))
    seq = np.random.default_rng(6).integers(0, TRAIN_CFG["vocab"],
                                            (TRAIN_B, TRAIN_T + 1))
    return {
        "ring": np.stack(_rng_arrays(0, *[(2, 32, 2, 8)] * 3)),
        "ulysses": np.stack(_rng_arrays(1, *[(2, 16, 4, 8)] * 3)),
        "pipe_w": _rng_arrays(2, (4, 16, 16), scale=0.3)[0],
        "pipe_x": _rng_arrays(3, (8, 16))[0],
        "pipe2_w": _rng_arrays(4, (2, 8, 8), scale=0.3)[0],
        "pipe2_x": _rng_arrays(5, (4, 8))[0],
        "moe_x": _rng_arrays(7, (32, 8))[0],
        "moe_logits": _rng_arrays(8, (32, 4))[0],
        "moe_scales": np.arange(1.0, 5.0, dtype=np.float32),
        "coll_x": _rng_arrays(9, (8, 4, 6))[0],
        "train": {"params": params,
                  "batch": {"tokens": seq[:, :-1], "targets": seq[:, 1:]}},
    }


@pytest.fixture(scope="module")
def ranks(inputs):
    return launch.run_spmd(_rank_cases, N_RANKS, inputs, device="cpu",
                           timeout_s=180)


# ---------------------------------------------------------- pure Python

def test_mesh_config_matches_jax():
    from ray_tpu.parallel import mesh as jmesh

    for n in range(1, 65):
        assert (tmesh.default_mesh_shape(n).sizes()
                == jmesh.default_mesh_shape(n).sizes())
    assert tmesh.AXES == jmesh.AXES
    for sizes, n in (((2, -1, 1, 1), 8), ((3, -1, 1, 1), 8),
                     ((2, 2, 1, 1), 8), ((1, 1, 1, 1), 1)):
        want = got = None
        try:
            want = jmesh.MeshConfig(*sizes).resolve(n).sizes()
        except ValueError as e:
            want = str(e)
        try:
            got = tmesh.MeshConfig(*sizes).resolve(n).sizes()
        except ValueError as e:
            got = str(e)
        assert got == want


def test_logical_to_mesh_matches_jax():
    from ray_tpu.parallel import sharding as jsharding

    assert sharding.DEFAULT_RULES == jsharding.DEFAULT_RULES
    rules = sharding.transformer_rules(embed="tp", seq=None)
    for axes in (("batch", "seq", "embed"), ("layers", None, "mlp"),
                 ("expert", "vocab", "heads", "kv_seq")):
        for r in (None, rules):
            got = sharding.logical_to_mesh(axes, r)
            want = jsharding.logical_to_mesh(axes, r)
            assert isinstance(got, P) and tuple(got) == tuple(want)


def test_refusals(monkeypatch):
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.build_mesh(tmesh.MeshConfig(), device_type="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.MeshConfig(dp=-1, tp=3).resolve(8)
    with pytest.raises(ValueError, match="!= 8 devices"):
        tmesh.MeshConfig(dp=2, tp=2).resolve(8)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="needs 4 GPUs"):
        launch.run_spmd(_skip_allreduce, 4, device="cuda")
    with pytest.raises(RuntimeError, match="outside shard_map|only inside"):
        tcol.axis_size("tp")
    with pytest.raises(NotImplementedError, match="per-rank"):
        sharding.named_sharding(None, ("batch",))


# ------------------------------------------------------ multi-rank cases

def _attention(q, k, v, causal):
    from ray_tpu.ops.attention import attention

    return np.asarray(attention(q, k, v, causal=causal))


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_jax(ranks, inputs, causal):
    want = _attention(*inputs["ring"], causal)
    np.testing.assert_allclose(ranks[0][f"ring_{causal}"], want, rtol=2e-4,
                               atol=2e-5)


def test_ulysses_matches_jax(ranks, inputs):
    want = _attention(*inputs["ulysses"], True)
    np.testing.assert_allclose(ranks[0]["ulysses"], want, rtol=2e-4,
                               atol=2e-5)


def test_pipeline_matches_jax_sequential(ranks, inputs):
    import jax.numpy as jnp

    w, want = inputs["pipe_w"], inputs["pipe_x"]
    for i in range(4):
        want = jnp.tanh(want @ w[i])
    np.testing.assert_allclose(ranks[0]["pipeline"], want, rtol=1e-5,
                               atol=1e-6)


def test_pipeline_grads_match_jax_sequential(ranks, inputs):
    import jax
    import jax.numpy as jnp

    x = inputs["pipe2_x"]

    def seq_loss(w_):
        h = x
        for i in range(2):
            h = jnp.tanh(h @ w_[i])
        return jnp.sum(h * h)

    want = jax.grad(seq_loss)(inputs["pipe2_w"])
    np.testing.assert_allclose(ranks[0]["pipeline_grad"], want, rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("experts", ["scaled", "identity"])
def test_moe_matches_jax(ranks, inputs, experts):
    import jax
    import jax.numpy as jnp

    x, logits = inputs["moe_x"], inputs["moe_logits"]
    gates = jax.nn.softmax(logits, axis=-1)
    want = x * jnp.max(gates, -1, keepdims=True)
    if experts == "scaled":   # expert e multiplies by e + 1
        want = want * inputs["moe_scales"][jnp.argmax(gates, -1)][:, None]
    np.testing.assert_allclose(ranks[0][f"moe_{experts}"], want, rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("name", sorted(COLLECTIVES))
def test_collective_grad_matches_jax(ranks, inputs, name):
    import jax
    from jax.sharding import PartitionSpec as JP

    from ray_tpu.parallel import build_mesh, collectives as jcol
    from ray_tpu.parallel.mesh import MeshConfig

    class _Jax:   # the port's call shape over the JAX collectives
        psum, pmean, all_gather = jcol.psum, jcol.pmean, jcol.all_gather
        psum_scatter, all_to_all = jcol.psum_scatter, jcol.all_to_all
        ppermute_ring, broadcast_from = jcol.ppermute_ring, jcol.broadcast_from
        tp_copy, tp_allreduce = jcol.tp_copy, jcol.tp_allreduce

    def local_loss(x):
        y = COLLECTIVES[name](_Jax, x)
        return (1.0 + jax.lax.axis_index("sp")) * (y * y).sum()

    mcfg = MESHES["sp4"]
    mesh = build_mesh(MeshConfig(*mcfg.sizes()), jax.devices("cpu")[:8])
    fn = jcol.shard_map(jax.grad(local_loss), mesh=mesh, in_specs=JP("sp"),
                        out_specs=JP("sp"), check_vma=False)
    want = jax.jit(fn)(inputs["coll_x"])
    np.testing.assert_allclose(ranks[0][f"grad_{name}"], want, rtol=1e-5,
                               atol=1e-6)


@pytest.fixture(scope="module")
def jax_oracle_steps(inputs):
    """Two steps of the JAX oracle train step (SGD 0.1): losses and the
    params after the first."""
    import jax.numpy as jnp
    import optax

    from ray_tpu.models import transformer as jtfm

    jcfg = jtfm.TransformerConfig(dtype=jnp.float32, **TRAIN_CFG)
    step, opt = jtfm.make_train_step(jcfg, jtfm.ParallelConfig(),
                                     optimizer=optax.sgd(TRAIN_LR))
    params = inputs["train"]["params"]
    batch = {k: jnp.asarray(v, jnp.int32)
             for k, v in inputs["train"]["batch"].items()}
    p1, o1, l1 = step(params, opt.init(params), batch)
    _, _, l2 = step(p1, o1, batch)
    return [float(l1), float(l2)], p1


@pytest.mark.parametrize("name", TRAIN_MESHES)
def test_mesh_train_step_matches_oracles(ranks, inputs, jax_oracle_steps,
                                         name):
    got = ranks[0][f"train_{name}"]
    # against the JAX oracle: the loss over two steps (the second only
    # matches if the first step's grads did), the updated wq (pp + tp
    # sharded) and embed (replicated)
    want_losses, jp1 = jax_oracle_steps
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-4)
    for path in (("layers", "wq"), ("embed",)):
        g, w = got["full"], jp1
        for key in path:
            g, w = g[key], w[key]
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-3, atol=1e-5)
    # against the port's own oracle step, every leaf
    cfg = ttfm.TransformerConfig(dtype=torch.float32, **TRAIN_CFG)
    params = convert.params_from_jax(inputs["train"]["params"], cfg,
                                     device="cpu")
    step, opt = ttfm.make_train_step(cfg, optimizer=ttfm.SGD(TRAIN_LR))
    state = opt.init(params)
    batch = {k: torch.from_numpy(v)
             for k, v in inputs["train"]["batch"].items()}
    _, _, l1 = step(params, state, batch)
    full = ttfm.param_leaves(got["full"])
    for g, w in zip(full, ttfm.param_leaves(params)):
        np.testing.assert_allclose(g, w.detach().numpy(), rtol=1e-3,
                                   atol=1e-5)
    _, _, l2 = step(params, state, batch)
    np.testing.assert_allclose(got["losses"], [l1.item(), l2.item()],
                               rtol=1e-4)
    # every rank that holds the same block of a leaf holds the same bits
    specs = ttfm.param_leaves(ttfm.param_specs(_pcfg(MESHES[name], ttfm)))
    for i, spec in enumerate(specs):
        blocks = {}
        for r in ranks:
            res = r[f"train_{name}"]
            key = tuple(res["coords"][a] for a in spec if a)
            blocks.setdefault(key, []).append(res["local"][i])
        assert len(blocks) == math.prod(
            getattr(MESHES[name], a) for a in spec if a)
        for same in blocks.values():
            for b in same[1:]:
                np.testing.assert_array_equal(b, same[0])


# ------------------------------------------------- entry point and hangs

def test_dryrun_multichip_on_gloo_ranks():
    loss = ray_tpu_torch.dryrun_multichip(4, device="cpu")
    # 64-way vocab, random init: near ln(64)
    assert math.isfinite(loss) and 2.0 < loss < 6.0


def _skip_allreduce(rank):
    """Rank 1 skips the all-reduce that rank 0 waits in."""
    if rank == 0:
        torch.distributed.all_reduce(torch.ones(1))
    else:
        time.sleep(60)


def test_skipped_collective_fails_within_the_timeout():
    t0 = time.monotonic()
    with pytest.raises(launch.SpmdError, match="did not finish|raised"):
        launch.run_spmd(_skip_allreduce, 2, device="cpu", timeout_s=6)
    assert time.monotonic() - t0 < 30
