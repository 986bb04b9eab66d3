"""Parity of the port's model (ray_tpu_torch.models) with the JAX package's.

The JAX package initialises the params; ``params_from_jax`` carries them
across, so both packages compute on the same weights and the same numpy
tokens. Both run on the CPU, where attention takes the plain path.

Model tolerances are looser than the op tolerances of
tests/test_torch_ops.py (fp32 1e-4 against 2e-5, bf16 6e-2 against
3e-2): every layer's matmuls and reductions sum in a different order in
the two frameworks, and the residual stream carries each layer's
rounding into the next. Greedy tokens must match exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import decode as jdecode
from ray_tpu.models import transformer as jtfm
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import decode as tdecode
from ray_tpu_torch.models import transformer as ttfm

TOL = {"f32": 1e-4, "bf16": 6e-2}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _models(dt, n_layers=3):
    jdt, tdt = DTYPES[dt]
    shape = dict(vocab=97, d_model=64, n_heads=4, n_layers=n_layers,
                 d_ff=128, max_seq=64)
    jcfg = jtfm.TransformerConfig(dtype=jdt, **shape)
    tcfg = ttfm.TransformerConfig(dtype=tdt, **shape)
    jparams = jtfm.init_params(jax.random.key(0), jcfg)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                      tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _tokens(seed, B, T, vocab=97):
    return np.random.default_rng(seed).integers(0, vocab, (B, T))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_params_from_jax_round_trip():
    for dt in DTYPES:
        jcfg, jparams, tcfg, tparams = _models(dt, n_layers=2)
        flat_j = jax.tree_util.tree_leaves_with_path(jparams)
        assert len(flat_j) == 2 + len(ttfm.param_shapes(tcfg)["layers"])
        for path, leaf in flat_j:
            node = tparams
            for key in path:
                node = node[key.key]
            assert node.dtype == tcfg.dtype and node.device.type == "cpu"
            np.testing.assert_array_equal(node.float().numpy(),
                                          np.asarray(leaf, np.float32))
    bad = jax.tree.map(np.asarray, jparams)
    bad["layers"]["wq"] = bad["layers"]["wq"][:, :, :8]
    with pytest.raises(ValueError, match="wq"):
        convert.params_from_jax(bad, tcfg, device="cpu")


def test_init_params_layout_matches_jax():
    _, jparams, tcfg, _ = _models("bf16", n_layers=2)
    tparams = ttfm.init_params(tcfg, seed=0, device="cpu")
    shapes = jax.tree.map(lambda x: tuple(x.shape), jparams)
    assert jax.tree.map(lambda x: tuple(x.shape), tparams) == shapes
    w = tparams["layers"]["wq"].float()
    assert abs(float(w.std()) - 0.02) < 2e-3
    assert torch.equal(tparams["final_norm"],
                       torch.ones(64, dtype=torch.bfloat16))
    again = ttfm.init_params(tcfg, seed=0, device="cpu")
    assert torch.equal(again["embed"], tparams["embed"])


def test_parallel_axes_not_ported():
    # parallel/ is ported: ParallelConfig takes every axis, as JAX's does,
    # and shards the params as JAX's param_specs do
    assert ttfm.ParallelConfig(tp="tp").tp == "tp"
    for axes in ({"tp": "tp"}, {"dp": "dp", "pp": "pp", "sp": "sp",
                                "tp": "tp"}):
        pcfg = ttfm.ParallelConfig(num_microbatches=2, **axes)
        jpcfg = jtfm.ParallelConfig(num_microbatches=2, **axes)
        assert pcfg.data_axes() == jpcfg.data_axes()
        want = jax.tree_util.tree_leaves_with_path(
            jtfm.param_specs(jpcfg),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        got = ttfm.param_specs(pcfg)
        for path, spec in want:
            node = got
            for key in path:
                node = node[key.key]
            assert tuple(node) == tuple(spec)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_forward_matches_jax(dt):
    jcfg, jparams, tcfg, tparams = _models(dt)
    toks = _tokens(1, 2, 24)
    want = jtfm.forward(jparams, jnp.asarray(toks, jnp.int32), jcfg)
    got = ttfm.forward(tparams, torch.from_numpy(toks), tcfg)
    assert got.dtype == torch.float32 and got.shape == (2, 24, 97)
    _close(got, want, TOL[dt])


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_prefill_and_decode_step_match_jax(dt):
    jcfg, jparams, tcfg, tparams = _models(dt)
    toks = _tokens(2, 2, 9)
    jcache = jdecode.init_kv_cache(jcfg, 2, 16)
    tcache = tdecode.init_kv_cache(tcfg, 2, 16, device="cpu")
    jl, jcache = jdecode.prefill(jparams, jnp.asarray(toks, jnp.int32),
                                 jcache, jcfg)
    tl, tcache = tdecode.prefill(tparams, torch.from_numpy(toks), tcache,
                                 tcfg)
    _close(tl, jl, TOL[dt])
    _close(tcache["k"], jcache["k"], TOL[dt])
    for step in range(3):
        nxt = np.asarray(jnp.argmax(jl, axis=-1))
        jl, jcache = jdecode.decode_step(jparams, jcache,
                                         jnp.asarray(nxt, jnp.int32), jcfg)
        tl, tcache = tdecode.decode_step(tparams, tcache,
                                         torch.tensor(nxt), tcfg)
        _close(tl, jl, TOL[dt])
        assert tcache["pos"] == int(jcache["pos"]) == 10 + step
    _close(tcache["v"], jcache["v"], TOL[dt])


def test_greedy_generate_matches_jax_exactly():
    jcfg, jparams, tcfg, tparams = _models("f32")
    prompt = _tokens(3, 2, 5)
    want = jdecode.generate(jparams, jnp.asarray(prompt, jnp.int32), jcfg,
                            steps=8)
    got = tdecode.generate(tparams, torch.from_numpy(prompt), tcfg, steps=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # and per-step argmax of the port's own full forward on the prefix
    prefix = torch.from_numpy(prompt)
    for t in range(8):
        nxt = ttfm.forward(tparams, prefix, tcfg)[:, -1].argmax(-1)
        assert torch.equal(got[:, t], nxt), t
        prefix = torch.cat([prefix, nxt[:, None]], dim=1)


def test_full_cache_raises():
    _, _, tcfg, tparams = _models("f32", n_layers=1)
    cache = tdecode.init_kv_cache(tcfg, 1, 4, device="cpu")
    _, cache = tdecode.prefill(tparams, torch.tensor([[1, 2, 3]]), cache,
                               tcfg)
    _, cache = tdecode.decode_step(tparams, cache, torch.tensor([4]), tcfg)
    with pytest.raises(ValueError, match="KV cache full"):
        tdecode.decode_step(tparams, cache, torch.tensor([5]), tcfg)
    with pytest.raises(ValueError, match="exceeds max_len"):
        tdecode.generate(tparams, torch.tensor([[1, 2, 3]]), tcfg, steps=2,
                         max_len=4)


def test_sampling_needs_generator_and_is_deterministic():
    _, _, tcfg, tparams = _models("f32", n_layers=1)
    prompt = torch.from_numpy(_tokens(4, 2, 4))

    def sample(seed):
        return tdecode.generate(tparams, prompt, tcfg, steps=4,
                                temperature=0.8,
                                generator=torch.Generator().manual_seed(seed))

    s1 = sample(3)
    assert s1.shape == (2, 4)
    assert torch.equal(s1, sample(3))
    with pytest.raises(ValueError, match="explicit generator"):
        tdecode.generate(tparams, prompt, tcfg, steps=2, temperature=0.5)


def test_entry_runs_on_cpu():
    from ray_tpu_torch import entry

    fn, args = entry(device="cpu")
    logits = fn(*args)
    assert logits.shape == (4, 128, 512)
    assert bool(torch.isfinite(logits).all())


def test_entry_matches_jax_entry():
    # the port's entry against __graft_entry__.entry on the JAX params,
    # carried across: the same config (head_dim 32), tokens and logits
    # at the whole-model bf16 tolerance
    import __graft_entry__
    from ray_tpu_torch import entry

    jfn, (jparams, jtokens) = __graft_entry__.entry()
    fn, (params, tokens) = entry(device="cpu")
    cfg = fn.keywords["cfg"]
    assert cfg.head_dim == 32 and tokens.shape == jtokens.shape
    carried = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                      cfg, device="cpu")
    want = jfn(jparams, jtokens)
    got = fn(carried, torch.from_numpy(np.array(jtokens)))
    assert got.shape == (4, 128, 512)
    _close(got, want, TOL["bf16"])
