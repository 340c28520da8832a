"""The port's LLM serving slice against the reference on the CPU: the arch
configs, Zipf tokens, the layers, the attention (chunked prefill, the
ring-buffer decode), the transformer forward, prefill and decode of the
dense, VLM and audio smoke configs (the MoE, Mamba-2 and hybrid ones are
in tests/test_torch_moe.py and tests/test_torch_ssm.py), the port's own
decode against its own prefill, the init's structure and its refusals.

Inputs are made with numpy from a seed, and parameters are the
reference's own draws carried across with ``from_jax`` (threefry cannot be
reproduced in torch).  Everything computes in f32: bf16 rounds at other
places in XLA and PyTorch.  Tolerances: the attention 2e-5 as
``tests/test_attention.py``; the layers 1e-5 (one f32 op or one short
sum each); logits 1e-4 absolute, as ``tests/test_decode_consistency.py``
holds decode to prefill (two layers of f32 matmuls summed in other orders).
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers to a machine, and
# torch's thread pools contend there (a small op can take 100 ms)
torch.set_num_threads(1)

from repro.configs import base as rbase  # noqa: E402
from repro.data import synthetic as rsynth  # noqa: E402
from repro.models import attention as rattn  # noqa: E402
from repro.models import layers as rlayers  # noqa: E402
from repro.models import model as rmodel  # noqa: E402
from repro.models import transformer as rtransformer  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import attention, layers, model, transformer  # noqa: E402
from repro_torch.utils.convert import from_jax  # noqa: E402
from repro_torch.utils.pytree import tree_leaves  # noqa: E402

ARCH_MODULES = {"granite-8b": "granite_8b", "granite-20b": "granite_20b",
                "phi4-mini-3.8b": "phi4_mini", "qwen3-32b": "qwen3_32b",
                "hubert-xlarge": "hubert_xlarge",
                "chameleon-34b": "chameleon_34b"}
LOGIT_TOL = 1e-4
ATTN_TOL = 2e-5
LAYER_TOL = 1e-5


def _smoke(arch):
    mod = ARCH_MODULES[arch]
    return (importlib.import_module(f"repro_torch.configs.{mod}").smoke_config(),
            importlib.import_module(f"repro.configs.{mod}").smoke_config())


def _ref_params(rcfg, seed=0):
    return jax.jit(lambda key: rmodel.init(rcfg, key)[0])(jax.random.PRNGKey(seed))


def _port_params(rparams):
    return from_jax(jax.tree.map(np.asarray, rparams))


def _inputs(cfg, B, S, seed=1):
    """(reference batch, port batch) from one numpy draw."""
    if cfg.frontend == "audio_embed":
        x = np.random.default_rng(seed).normal(size=(B, S, cfg.d_model)
                                               ).astype(np.float32)
        return {"features": jnp.asarray(x)}, {"features": torch.from_numpy(x)}
    toks = synthetic.zipf_tokens(B, S, cfg.vocab_size, seed=seed)
    return {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", sorted(ARCH_MODULES))
def test_configs_carry_the_reference_numbers(arch):
    ours = base.get(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(rbase.get(arch))
    smoke, rsmoke = _smoke(arch)
    assert dataclasses.asdict(smoke) == dataclasses.asdict(rsmoke)
    assert ours.param_count() == rbase.get(arch).param_count()
    assert str(ours.activation_dtype) == f"torch.{rbase.get(arch).dtype}"


def test_registry_names_and_refusals():
    """All ten of the reference's assigned architectures are ported, and
    the port's own ASSIGNED lists them in the reference's order."""
    assert base.ASSIGNED == rbase.ASSIGNED
    assert set(base.names()) == set(base.ASSIGNED)
    for name in base.ASSIGNED:
        assert base.get(name).name == name
    with pytest.raises(KeyError):
        base.get("no-such-arch")
    assert base.INPUT_SHAPES == {
        k: base.ShapeConfig(*dataclasses.astuple(v))
        for k, v in rbase.INPUT_SHAPES.items()}


def test_zipf_tokens_bit_identical():
    for n, s, v, seed in ((2, 64, 512, 0), (3, 33, 49152, 7)):
        np.testing.assert_array_equal(synthetic.zipf_tokens(n, s, v, seed),
                                      rsynth.zipf_tokens(n, s, v, seed))


# ------------------------------------------------------------------- layers
def test_rms_norm_rope_and_mlp_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 16, 4, 32)).astype(np.float32) * 3.0
    scale = rng.normal(size=(32,)).astype(np.float32)
    _close(layers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)),
           rlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale)), LAYER_TOL)
    pos = np.arange(16)
    for theta in (10_000.0, 1_000_000.0):
        _close(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
               rlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
               LAYER_TOL)
    rp, _ = rlayers.mlp_init(jax.random.PRNGKey(0), 32, 64, jnp.float32)
    h = rng.normal(size=(2, 16, 32)).astype(np.float32)
    _close(layers.mlp_apply(_port_params(rp), torch.from_numpy(h)),
           rlayers.mlp_apply(rp, jnp.asarray(h)), LAYER_TOL)


def test_initializers_draw_on_the_generators_device_in_the_dtype():
    gen = torch.Generator().manual_seed(0)
    w = layers.dense_init(gen, (64, 32), torch.bfloat16)
    e = layers.embed_init(gen, (100, 32), torch.float32)
    assert w.dtype == torch.bfloat16 and w.shape == (64, 32)
    assert 0.05 < float(w.float().std()) < 0.2          # ~ 1/sqrt(64)
    assert 0.015 < float(e.std()) < 0.025                # ~ 0.02


# ---------------------------------------------------------------- attention
@pytest.mark.parametrize("variant,window", [("full", 0), ("sliding_window", 24)])
@pytest.mark.parametrize("q_chunk", [16, 64, 999])
def test_chunked_attention_matches_reference(variant, window, q_chunk):
    cfg, rcfg = _smoke("phi4-mini-3.8b")
    kw = dict(attn_variant=variant, window=window or 4096,
              attn_q_chunk=q_chunk, qk_norm=False)
    cfg, rcfg = cfg.replace(**kw), rcfg.replace(**kw)
    B, S = 2, 64
    hd, H, KV = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    rng = np.random.default_rng(q_chunk)
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    for causal in (True, False):
        got = attention._chunked_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), cfg,
            torch.arange(S), causal=causal)
        want = rattn._chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), rcfg, jnp.arange(S),
                                        causal=causal)
        _close(got, want, ATTN_TOL)


def test_ring_buffer_decode_past_the_window_matches_reference():
    """Decode far past a window of 4: the port's in-place ring buffer
    against the reference's step by step, and against the port's own
    windowed prefill."""
    cfg, rcfg = _smoke("phi4-mini-3.8b")
    kw = dict(attn_variant="sliding_window", window=4, qk_norm=False)
    cfg, rcfg = cfg.replace(**kw), rcfg.replace(**kw)
    rp, _ = rattn.attn_init(jax.random.PRNGKey(0), rcfg)
    p = _port_params(rp)
    x = np.random.default_rng(1).normal(size=(1, 12, cfg.d_model)).astype(np.float32)
    rcache = rattn.cache_init(rcfg, 1, 4, jnp.float32)
    cache = attention.cache_init(cfg, 1, 4, torch.float32, "cpu")
    outs = []
    for t in range(12):
        want, rcache = rattn.attn_decode(rp, rcfg, jnp.asarray(x[:, t:t + 1]), rcache)
        got, cache = attention.attn_decode(p, cfg, torch.from_numpy(x[:, t:t + 1]),
                                           cache)
        _close(got, want, 1e-4)
        _close(cache.k, rcache.k, LAYER_TOL)
        assert int(cache.pos) == int(rcache.pos) == t + 1
        outs.append(got)
    _close(torch.cat(outs, dim=1),
           rattn.attn_apply(rp, rcfg, jnp.asarray(x)), 1e-4)
    _close(torch.cat(outs, dim=1),
           attention.attn_apply(p, cfg, torch.from_numpy(x)).numpy(), 1e-4)


def test_decode_writes_the_cache_in_place():
    cfg, _ = _smoke("granite-8b")
    p = attention.attn_init(torch.Generator().manual_seed(0), cfg)
    cache = attention.cache_init(cfg, 2, 8, torch.float32, "cpu")
    k_ptr = cache.k.data_ptr()
    _, new = attention.attn_decode(p, cfg, torch.ones(2, 1, cfg.d_model), cache)
    assert new.k.data_ptr() == k_ptr and new.k is cache.k
    assert bool(cache.k[:, 0].abs().sum() > 0) and not bool(cache.k[:, 1:].any())


# -------------------------------------------------------------- transformer
@pytest.mark.parametrize("arch", sorted(ARCH_MODULES))
def test_forward_and_prefill_match_reference(arch):
    cfg, rcfg = _smoke(arch)
    rp = _ref_params(rcfg)
    p = _port_params(rp)
    rbatch, batch = _inputs(cfg, 2, 64)
    inputs = batch.get("tokens", batch.get("features"))
    hidden, aux = transformer.forward(p, cfg, inputs)
    rhidden, raux = rtransformer.forward(rp, rcfg, rbatch.get("tokens",
                                                              rbatch.get("features")))
    _close(hidden, rhidden, LOGIT_TOL)
    assert float(aux) == float(raux) == 0.0
    _close(transformer.logits_fn(p, cfg, hidden),
           rtransformer.logits_fn(rp, rcfg, rhidden), LOGIT_TOL)
    got = train.make_prefill_step(cfg)(p, batch)
    want = jax.jit(lambda prm, b: rmodel.prefill_fn(prm, rcfg, b))(rp, rbatch)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got, want, LOGIT_TOL)


@pytest.mark.parametrize("arch,T", [("phi4-mini-3.8b", 24), ("qwen3-32b", 16),
                                    ("granite-20b", 12)])
def test_decode_sequence_matches_reference(arch, T):
    """T greedy-free decode steps over fixed tokens: the port's serve step
    against the reference's, logits and cache at every step."""
    cfg, rcfg = _smoke(arch)
    rp = _ref_params(rcfg)
    p = _port_params(rp)
    toks = synthetic.zipf_tokens(2, T, cfg.vocab_size, seed=3)
    rcache, _ = rmodel.init_cache(rcfg, batch=2, context=T)
    cache = model.init_cache(cfg, 2, T, device="cpu")
    rstep = jax.jit(lambda prm, c, t: rmodel.decode_fn(prm, rcfg, c, t))
    step = train.make_serve_step(cfg)
    for t in range(T):
        want, rcache = rstep(rp, rcache, jnp.asarray(toks[:, t:t + 1]))
        got, cache = step(p, cache, torch.from_numpy(toks[:, t:t + 1]))
        _close(got, want, LOGIT_TOL)
    _close(cache.layer_cache.k, rcache.layer_cache.k, LOGIT_TOL)
    assert int(cache.pos) == int(rcache.pos) == T
    assert not cache.layer_cache.pos.any()


def _roundtrip(cfg, T, batch=1, seed=0):
    """The port's decode over T tokens beside its prefill over them."""
    params = model.init(cfg, torch.Generator().manual_seed(seed), device="cpu")
    toks = torch.from_numpy(synthetic.zipf_tokens(batch, T, cfg.vocab_size,
                                                  seed=seed + 1))
    hidden, _ = transformer.forward(params, cfg, toks)
    ref = transformer.logits_fn(params, cfg, hidden)
    cache = model.init_cache(cfg, batch, T, device="cpu")
    outs = []
    for t in range(T):
        lg, cache = model.decode_fn(params, cfg, cache, toks[:, t:t + 1])
        outs.append(lg[:, 0])
    return torch.stack(outs, dim=1), ref, cache


@pytest.mark.parametrize("arch,T", [("phi4-mini-3.8b", 24), ("qwen3-32b", 16),
                                    ("granite-20b", 16), ("chameleon-34b", 16)])
def test_port_decode_matches_port_prefill(arch, T):
    dec, ref, _ = _roundtrip(_smoke(arch)[0], T)
    assert float((dec - ref).abs().max()) < LOGIT_TOL


def test_port_sliding_window_decode_matches_windowed_prefill():
    cfg = _smoke("granite-8b")[0].replace(attn_variant="sliding_window", window=8)
    dec, ref, cache = _roundtrip(cfg, 24)
    assert cache.layer_cache.k.shape[2] == 8   # ring sized by the window
    assert float((dec - ref).abs().max()) < LOGIT_TOL


# --------------------------------------------------------------------- init
@pytest.mark.parametrize("arch", sorted(ARCH_MODULES))
def test_init_structure_matches_reference(arch):
    cfg, rcfg = _smoke(arch)
    rp = _ref_params(rcfg)
    p = model.init(cfg, device="cpu")
    shapes = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)), rp)
    ours = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), p)
    assert ours == shapes
    assert len(tree_leaves(p)) == len(jax.tree.leaves(rp))
    big = base.get(arch)
    assert big.activation_dtype == torch.bfloat16


def test_init_draws_from_the_generator():
    cfg, _ = _smoke("granite-8b")
    a = model.init(cfg, torch.Generator().manual_seed(4), device="cpu")
    b = model.init(cfg, torch.Generator().manual_seed(4), device="cpu")
    c = model.init(cfg, torch.Generator().manual_seed(5), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b),
                                                 strict=True))
    assert not torch.equal(a["head"], c["head"])


def test_entry_points_default_to_the_card_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, _ = _smoke("granite-8b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init_cache(cfg, 1, 8)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        train.make_prefill_step(cfg, kernels="on")(
            model.init(cfg, device="cpu"),
            {"tokens": torch.zeros((1, 8), dtype=torch.int32)})


def test_jamba_stack_needs_whole_periods():
    """The refusal that remains: a Jamba stack of 12 layers is no whole
    number of 8-layer periods (the reference asserts it)."""
    jamba = importlib.import_module("repro_torch.configs.jamba_52b")
    cfg = jamba.smoke_config().replace(num_layers=12)
    with pytest.raises(ValueError, match="multiple of 8"):
        model.init(cfg, device="cpu")
    with pytest.raises(ValueError, match="multiple of 8"):
        model.init_cache(cfg, 1, 8, device="cpu")


def test_supports_shape_and_shape_variant_match_reference():
    for arch in sorted(ARCH_MODULES):
        cfg, rcfg = base.get(arch), rbase.get(arch)
        for name, shape in base.INPUT_SHAPES.items():
            rshape = rbase.INPUT_SHAPES[name]
            assert model.supports_shape(cfg, shape) == rmodel.supports_shape(rcfg, rshape)
            assert (dataclasses.asdict(model.shape_variant(cfg, shape))
                    == dataclasses.asdict(rmodel.shape_variant(rcfg, rshape)))
