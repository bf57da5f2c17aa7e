"""The port's transformer LM (``repro_torch.models.transformer``) against
the JAX package's, on the CPU route.

Every model is the anchor's shrunk config (``tests/test_models_smoke.py::
_shrink_lm``: 2 layers a MoE period, width 64, 4 heads, dh 16, vocab 256,
4 experts) of each of the five LM architectures, and ``micro-lm``.  The
JAX side draws the weights (``init_params(jax.random.key(0))``) and
:func:`params_from_numpy` carries them across, so both packages compute
the same model; the tokens come from the anchor's ``default_rng(3)``.

Tolerances (``torch_parity.assert_logits_close``: an error norm within
``tol`` of the output's norm, no element past ``2 tol`` of its largest
magnitude):

  * f32: 1e-4 (the packages differ in the last bits of sums and of exp);
  * bf16: 2e-2.  The port's attention is K9's plain version, which
    multiplies the probabilities by V in f32 where the reference's einsum
    casts them to bf16 first (K9's rule, not bit for bit), and every bf16
    rounding after a sum in another order moves a logit by a step.  The
    reference's own einsum and blockwise paths differ by as much (~1% of
    the scale).  A MoE router's near-tie in bf16 can send a token to
    another expert in either package (and between the reference's own two
    paths); the anchor's seeds have none.

MoE routing and the capacity dispatch are held bit for bit at f32,
overflow and tied router columns included.  Anchors:
``tests/test_models_smoke.py:44,70``.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_logits_close, port_lm_config, to_torch

from repro import configs as jconfigs
from repro.launch import train as jtrain
from repro.models import transformer as jtfm
from repro_torch import configs
from repro_torch.launch import train
from repro_torch.models import transformer as tfm
from repro_torch.serve.engine import DecodeEngine, EngineConfig

CPU = "cpu"
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LM_ARCHS = [a for a in jconfigs.ASSIGNED if jconfigs.get(a).family == "lm"]
MOE_ARCHS = [a for a in LM_ARCHS if jconfigs.get(a).make_model(None).moe]
MODELS = LM_ARCHS + ["micro-lm"]


def _shrink_lm(cfg):
    """``tests/test_models_smoke.py:23-36``."""
    moe = cfg.moe and dataclasses.replace(
        cfg.moe, num_experts=4, d_ff=64, period=cfg.moe.period)
    return dataclasses.replace(
        cfg,
        n_layers=2 * (cfg.moe.period if cfg.moe else 1),
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, 4 * cfg.n_kv_heads // cfg.n_heads),
        head_dim=16,
        d_ff=128,
        vocab=256,
        moe=moe,
        param_dtype=jnp.float32,
    )


_MODELS = {}


def _model(name):
    """(JAX config, JAX params, numpy params, tokens (2, 16)) of a model."""
    if name not in _MODELS:
        jcfg = (jtrain.micro_lm_config() if name == "micro-lm"
                else _shrink_lm(jconfigs.get(name).make_model(None)))
        jp = jtfm.init_params(jax.random.key(0), jcfg)
        toks = np.random.default_rng(3).integers(0, jcfg.vocab, (2, 16)).astype(np.int32)
        _MODELS[name] = (jcfg, jp, jax.tree.map(np.asarray, jp), toks)
    return _MODELS[name]


def _pair(name, dtype, **knobs):
    """(JAX config, JAX params, the port's config, the port's params, tokens)."""
    jcfg, jp, npp, toks = _model(name)
    jcfg = dataclasses.replace(jcfg, dtype=getattr(jnp, dtype), **knobs)
    cfg = port_lm_config(jcfg)
    return jcfg, jp, cfg, tfm.params_from_numpy(npp, cfg, device=CPU), toks


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", MODELS)
def test_forward_matches_both_reference_paths(name, dtype):
    """``forward`` logits against the reference's einsum attention and its
    blockwise online softmax (4-query x 8-key blocks over S = 16): both at
    f32, and at bf16 for micro-lm and phi3-mini (the other bf16 models
    against the einsum path alone, to keep the JAX time down)."""
    jcfg, jp, cfg, params, toks = _pair(name, dtype)
    got = tfm.forward(params, torch.from_numpy(toks), cfg)
    assert got.shape == (2, 16, cfg.vocab) and got.dtype == torch.float32
    both = dtype == "float32" or name in ("micro-lm", "phi3-mini-3.8b")
    for impl in ("einsum", "blockwise") if both else ("einsum",):
        jc = dataclasses.replace(jcfg, attn_impl=impl, blockwise_q=4, blockwise_kv=8)
        assert_logits_close(got, jtfm.forward(jp, jnp.asarray(toks), jc), TOL[dtype],
                            f"{name} {dtype} forward vs {impl}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", MODELS)
def test_prefill_and_decode_step_match(name, dtype):
    """``prefill``'s cache (the reference's (L, B, S, Hkv, dh) layout) and
    last-position logits; then ``decode_step`` from that cache copied into
    a 32-position one (the anchor's way): its logits, the token's K / V
    written at position 16, and ``length`` 17; and ``_decode_attention``
    over that cache."""
    jcfg, jp, cfg, params, toks = _pair(name, dtype)
    jcache, jlogits = jtfm.prefill(jp, jnp.asarray(toks), jcfg)
    cache, logits = tfm.prefill(params, torch.from_numpy(toks), cfg)
    assert cache["length"] == 16 and cache["k"].dtype == cfg.dtype
    for key in ("k", "v"):
        assert tuple(cache[key].shape) == jcache[key].shape == (cfg.n_layers, 2, 16,
                                                                cfg.n_kv_heads, cfg.dh)
        assert_logits_close(cache[key], to_torch(jcache[key]), TOL[dtype], f"prefill {key}")
    assert_logits_close(logits, jlogits, TOL[dtype], "prefill logits")
    # decode one token from the reference's own cache in both packages
    full = jtfm.make_cache(jcfg, 2, 32)
    full = {"k": full["k"].at[:, :, :16].set(jcache["k"]),
            "v": full["v"].at[:, :, :16].set(jcache["v"]), "length": jnp.int32(16)}
    mine = tfm.make_cache(cfg, 2, 32, device=CPU)
    mine["k"][:, :, :16] = to_torch(jcache["k"])
    mine["v"][:, :, :16] = to_torch(jcache["v"])
    mine["length"] = 16
    nxt = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)
    jc2, jlg2 = jtfm.decode_step(jp, full, jnp.asarray(nxt), jcfg)
    c2, lg2 = tfm.decode_step(params, mine, torch.from_numpy(nxt), cfg)
    assert c2["length"] == 17 == int(jc2["length"])
    assert_logits_close(lg2, jlg2, TOL[dtype], "decode_step logits")
    for key in ("k", "v"):
        assert_logits_close(c2[key][:, :, 16], to_torch(jc2[key][:, :, 16]), TOL[dtype],
                            f"decode_step {key} at 16")
        assert not c2[key][:, :, 17:].any()
    # the plain decode attention over the filled cache (positions >= 16 masked)
    q = np.random.default_rng(8).normal(size=(2, 1, cfg.n_heads, cfg.dh)).astype(np.float32)
    jq = jnp.asarray(q).astype(jcfg.dtype)
    want = jtfm._decode_attention(jq, full["k"][0], full["v"][0], 16)
    got = tfm._decode_attention(to_torch(jq), mine["k"][0], mine["v"][0], 16)
    assert_logits_close(got, to_torch(want), TOL[dtype], "_decode_attention")


@pytest.mark.parametrize("name", MODELS)
def test_loss_fn_value(name):
    jcfg, jp, cfg, params, toks = _pair(name, "float32")
    labels = np.roll(toks, -1, axis=1)
    want = float(jtfm.loss_fn(jp, jnp.asarray(toks), jnp.asarray(labels), jcfg))
    got = float(tfm.loss_fn(params, torch.from_numpy(toks), torch.from_numpy(labels), cfg))
    assert math.isfinite(got) and abs(got - want) <= 1e-5 * abs(want)


def _moe_layer(name, tied: bool):
    """(JAX config, the first MoE layer's JAX leaves, the port's, x (2, 16,
    d) f32).  ``tied``: router columns 0 and 1 made equal and large, so
    every token's top choice ties between experts 0 and 1 (the tie goes to
    0; over positive rows) and expert 0 overflows its capacity."""
    jcfg, _, npp, _ = _model(name)
    layer = {k: np.array(v[0]) for k, v in npp["moe_layers"].items()}
    if tied:
        layer["router"][:, 1] = layer["router"][:, 0] = 4.0
    x = np.random.default_rng(5).normal(size=(2, 16, jcfg.d_model)).astype(np.float32)
    if tied:
        x = np.abs(x)  # positive rows: the two constant columns score highest
    return jcfg, {k: jnp.asarray(v) for k, v in layer.items()}, \
        {k: torch.from_numpy(v) for k, v in layer.items()}, x


@pytest.mark.parametrize("tied", [False, True], ids=["random", "tied-overflow"])
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_routing_and_dispatch_equal(name, tied):
    """At f32: the routed experts (``lax.top_k``'s order: ties to the
    lowest expert), the capacity dispatch's ``keep`` / ``slot`` / token
    order and buffer bit for bit, and ``moe_ffn`` within 1e-5."""
    jcfg, jl, pl_, x = _moe_layer(name, tied)
    cfg = port_lm_config(dataclasses.replace(jcfg, dtype=jnp.float32))
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    jx = jnp.asarray(x)
    probs = jax.nn.softmax((jx @ jl["router"]).astype(jnp.float32), axis=-1)
    jp_, je = jax.lax.top_k(probs, k)
    jp_ = jp_ / jnp.sum(jp_, axis=-1, keepdims=True)
    _, top_p, top_e = tfm._route(torch.from_numpy(x), pl_, k)
    assert np.array_equal(top_e.numpy(), np.asarray(je))
    np.testing.assert_allclose(top_p.numpy(), np.asarray(jp_), rtol=1e-5, atol=1e-6)
    top_p = to_torch(jp_)  # the dispatch on the same weights: bit for bit
    cap = max(1, min(int(cfg.moe.capacity_factor * 16 * k / e), 16))
    overflowed = False
    for i in range(2):
        want = jtfm._moe_dispatch_group(jx[i], je[i], jp_[i], e, k, cap)
        got = tfm._moe_dispatch_group(torch.from_numpy(x[i]), top_e[i], top_p[i], e, k, cap)
        for name_, g, w in zip(("expert_in", "st", "slot", "keep", "sp"), got, want):
            assert np.array_equal(g.numpy(), np.asarray(w)), name_
        overflowed |= not bool(got[3].all())
    assert overflowed or not tied  # the tied router overflows expert 0
    jcf = dataclasses.replace(jcfg, dtype=jnp.float32)
    np.testing.assert_allclose(tfm.moe_ffn(torch.from_numpy(x), pl_, cfg).numpy(),
                               np.asarray(jtfm.moe_ffn(jx, jl, jcf)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tfm.moe_ffn(torch.from_numpy(x), pl_, cfg, dropless=True).numpy(),
        np.asarray(jtfm.moe_ffn(jx, jl, jcf, dropless=True)), rtol=1e-5, atol=1e-5)
    logits = np.asarray(jx @ jl["router"]).reshape(-1, e)
    np.testing.assert_allclose(
        float(tfm.moe_aux_loss(torch.from_numpy(np.array(logits)), top_e.reshape(-1, k), e)),
        float(jtfm.moe_aux_loss(jnp.asarray(logits), je.reshape(-1, k), e)), rtol=1e-6)


def test_param_shapes_and_counts_of_the_full_configs():
    """``test_models_smoke.py:70``: the five full configs' trees and (total,
    active) counts equal the reference's and land near their nameplates."""
    expect = {
        "phi3-medium-14b": (14e9, None),
        "phi3-mini-3.8b": (3.8e9, None),
        "deepseek-coder-33b": (33e9, None),
        "phi3.5-moe-42b-a6.6b": (42e9, 6.6e9),
        "llama4-maverick-400b-a17b": (400e9, 17e9),
    }
    assert sorted(expect) == sorted(configs.ASSIGNED)
    for arch_id, (want_total, want_active) in expect.items():
        cfg = configs.get(arch_id).make_model(None)
        jcfg = jconfigs.get(arch_id).make_model(None)
        assert cfg == port_lm_config(jcfg)  # the published widths, field for field
        assert tfm.param_shapes(cfg) == jtfm.param_shapes(jcfg)
        total, active = cfg.param_count()
        assert (total, active) == jcfg.param_count()
        assert abs(total - want_total) / want_total < 0.15, (arch_id, total)
        if want_active:
            assert abs(active - want_active) / want_active < 0.25, (arch_id, active)
    mini = configs.get("phi3-mini-3.8b").make_model(None)
    leaves = jax.tree_util.tree_leaves(tfm.param_shapes(mini),
                                       is_leaf=lambda s: isinstance(s, tuple))
    assert sum(math.prod(s) for s in leaves) == 3_821_079_552 == mini.param_count()[0]
    assert train.get_model("tiny-lm") == port_lm_config(jtrain.get_model("tiny-lm"))
    assert train.get_model("micro-lm") == port_lm_config(jtrain.get_model("micro-lm"))


@pytest.mark.parametrize("name", ["micro-lm", "llama4-maverick-400b-a17b"])
def test_init_params_shapes_and_std(name):
    """Every leaf has :func:`param_shapes`' shape and ``param_dtype``; a
    rank >= 2 leaf's std is 1 / sqrt(its second-to-last dimension) (embed
    0.02), as the JAX init's is, within the sampling error of its size;
    ``final_ln`` is ones; the same generator seed draws the same tree."""
    jcfg, jp, _, _ = _model(name)
    cfg = port_lm_config(jcfg)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(1), device=CPU)
    again = tfm.init_params(cfg, torch.Generator().manual_seed(1), device=CPU)
    shapes = tfm.param_shapes(cfg)
    jflat = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    for path, want in jax.tree_util.tree_flatten_with_path(
            shapes, is_leaf=lambda s: isinstance(s, tuple))[0]:
        x = params
        for p in path:
            x = x[p.key]
        y = again
        for p in path:
            y = y[p.key]
        assert tuple(x.shape) == want and x.dtype == cfg.param_dtype and torch.equal(x, y)
        if len(want) < 2:
            assert bool((x == 1).all()), path
            continue
        rule = 0.02 if path[0].key == "embed" else 1.0 / math.sqrt(want[-2])
        slack = 6.0 / math.sqrt(x.numel())  # six standard errors of a std estimate
        for std in (float(x.float().std()), float(np.asarray(jflat[path]).std())):
            assert abs(std / rule - 1.0) < slack, (path, std, rule)


def test_lm_entry_points_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    jcfg, _, npp, _ = _model("micro-lm")
    cfg = port_lm_config(jcfg)
    for call in (lambda: tfm.init_params(cfg), lambda: tfm.params_from_numpy(npp, cfg),
                 lambda: tfm.make_cache(cfg, 2, 8),
                 lambda: DecodeEngine(tfm.params_from_numpy(npp, cfg, device=CPU), cfg,
                                      EngineConfig())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_params_round_trip_and_refusals():
    jcfg, _, npp, _ = _model("phi3.5-moe-42b-a6.6b")
    cfg = port_lm_config(jcfg)
    params = tfm.params_from_numpy(npp, cfg, device=CPU)
    back = tfm.params_to_numpy(params)
    for path, leaf in jax.tree_util.tree_flatten_with_path(npp)[0]:
        got = back
        for p in path:
            got = got[p.key]
        np.testing.assert_array_equal(got, leaf)
    bad = dict(npp, moe_layers=dict(npp["moe_layers"]))
    bad["moe_layers"]["router"] = bad["moe_layers"]["router"][:, :, :2]
    with pytest.raises(ValueError, match="router"):
        tfm.params_from_numpy(bad, cfg, device=CPU)
    with pytest.raises(ValueError, match="keys"):
        tfm.params_from_numpy({k: v for k, v in npp.items() if k != "lm_head"}, cfg, device=CPU)
