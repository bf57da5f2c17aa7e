"""Gradients of the port's LM against the JAX package's, on the CPU route.

  * Attention: K9's plain backward (``ref.attention_bwd_ref``, explicit
    formulas) and ``CausalAttention``'s backward (``causal_attention`` under
    autograd, which runs the plain forward with lse, then the plain
    backward) against ``jax.vjp`` of the reference's
    ``kernels/flash_attention/ref.py::attention_ref`` and of its LM's
    ``_einsum_attention``, at MHA, GQA and GQA group 7, with S off the
    kernels' 64-key and 32- / 64-row tiles
    (``torch_parity.assert_attention_grads_close``): f32 by rows at 1e-4
    (sums in another order); bf16 at 2e-2, dk and dv by rows and dq at
    its tensor's scale.  The reference's own two paths (its ``attention_ref``
    and the einsum, which casts P to bf16) differ by up to 0.65% of a dk or
    dv row's norm, past the half of K9's 1e-2 rule that the row norm gets.
    The port's Delta reads the output rounded to bf16, as K9's backward
    does, where the reference's VJP uses its f32 probabilities, and in the
    first rows, where dq is a small difference of near-equal terms, that
    moves a row by up to 13% of its own norm (0.2% of the tensor's).
  * The LM: ``torch.autograd.grad`` of the port's ``loss_fn`` against
    ``jax.grad`` of the reference's, leaf by leaf
    (``torch_parity.assert_logits_close``: the error's norm within ``tol``
    of the leaf's norm, no element past ``2 tol`` of its largest), on the
    anchor's shrunk configs (``tests/test_models_smoke.py::_shrink_lm``) of
    deepseek-coder-33b (GQA 4 / 1 heads), micro-lm with tied embeddings,
    and phi3.5-moe with an MoE layer every 2 (so ``dense_layers`` and
    ``moe_layers`` both train): f32 1e-5 (measured gaps up to 1.5e-6);
    bf16 4e-2, twice the spread of the reference's own einsum and
    blockwise gradients on the dense configs (up to 1.4% of a leaf's norm
    and 2% of its largest element, measured by
    ``test_reference_einsum_and_blockwise_gradients_spread``); the port's
    measured gaps are up to 1.6% (dense) and 2.6% (MoE, whose blockwise
    path flips a router route and differs from einsum by 8.9%).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (assert_attention_grads_close, assert_logits_close, port_lm_config,
                          to_torch)

from repro import configs as jconfigs
from repro.kernels.flash_attention.ref import attention_ref as jattention_ref
from repro.launch import train as jtrain
from repro.models import transformer as jtfm
from repro_torch.kernels.flash_attention import causal_attention, ref
from repro_torch.models import transformer as tfm

ATTN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LM_TOL = {"float32": 1e-5, "bfloat16": 4e-2}


def _qkvo(b, hq, hkv, s, d, dtype, seed):
    rng = np.random.default_rng(seed)
    shapes = ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d), (b, hq, s, d))
    return [jnp.asarray(rng.standard_normal(sh).astype(np.float32)).astype(dtype)
            for sh in shapes]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,s,d", [(1, 4, 4, 65, 32), (2, 4, 2, 70, 16),
                                          (1, 7, 1, 33, 64)])
def test_attention_gradients_match_jax(b, hq, hkv, s, d, dtype):
    jq, jk, jv, jdo = _qkvo(b, hq, hkv, s, d, getattr(jnp, dtype), seed=s + d)
    bshd = lambda x: jnp.swapaxes(x, 1, 2)  # noqa: E731  (B, H, S, D) <-> (B, S, H, D)
    einsum = lambda q, k, v: bshd(jtfm._einsum_attention(bshd(q), bshd(k), bshd(v)))  # noqa: E731
    want_ref, want_einsum = (
        jax.jit(lambda q, k, v, g, f=f: jax.vjp(f, q, k, v)[1](g))(jq, jk, jv, jdo)
        for f in (jattention_ref, einsum))
    q, k, v, do = (to_torch(x) for x in (jq, jk, jv, jdo))
    out, lse = ref.attention_fwd_ref(q, k, v)
    plain = ref.attention_bwd_ref(q, k, v, out, lse, do)
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    through = torch.autograd.grad(causal_attention(qg, kg, vg), (qg, kg, vg), do)
    for got in (plain, through):
        assert [x.dtype for x in got] == [q.dtype] * 3
        assert [tuple(x.shape) for x in got] == [tuple(x.shape) for x in (q, k, v)]
        for want in (want_ref, want_einsum):
            assert_attention_grads_close(got, want, ATTN_TOL[dtype], dq_rows=dtype == "float32")
    for a, c in zip(plain, through):
        assert torch.equal(a, c)


def test_causal_attention_without_grad_is_the_forward_entry(monkeypatch):
    """Without gradients asked for, ``causal_attention`` calls the plain
    forward entry (prefill's and decode's); with them, the forward that
    keeps lse."""
    from repro_torch.kernels.flash_attention import kernel

    calls = []
    monkeypatch.setattr(kernel, "flash_attention_fwd",
                        lambda *a: calls.append("fwd") or ref.attention_fwd_ref(*a))
    from repro_torch.kernels.flash_attention import ops
    monkeypatch.setattr(ops, "flash_attention_fwd", kernel.flash_attention_fwd)
    q = torch.randn(1, 2, 5, 8)
    causal_attention(q, q, q)
    with torch.no_grad():
        causal_attention(q.requires_grad_(), q, q)
    assert calls == []
    causal_attention(q, q, q).sum().backward()
    assert calls == ["fwd"] and q.grad is not None


def test_lse_is_the_logsumexp_of_the_masked_scaled_logits():
    q, k, v = (torch.randn(2, 4, 37, 16) for _ in range(3))
    _, lse = ref.attention_fwd_ref(q, k, v)
    logits = q @ k.transpose(-1, -2) / 4.0
    logits = logits.masked_fill(~torch.ones(37, 37, dtype=torch.bool).tril(), -float("inf"))
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1), rtol=1e-6, atol=1e-6)
    assert ref.attention_fwd_ref(q, k, v)[0].equal(ref.attention_ref(q, k, v))


def _shrink_lm(cfg):
    """``tests/test_models_smoke.py:23-36``."""
    moe = cfg.moe and dataclasses.replace(cfg.moe, num_experts=4, d_ff=64, period=cfg.moe.period)
    return dataclasses.replace(
        cfg, n_layers=2 * (cfg.moe.period if cfg.moe else 1), d_model=64, n_heads=4,
        n_kv_heads=max(1, 4 * cfg.n_kv_heads // cfg.n_heads), head_dim=16, d_ff=128, vocab=256,
        moe=moe, param_dtype=jnp.float32)


def _config(name):
    if name == "tied":
        return dataclasses.replace(jtrain.micro_lm_config(), tie_embeddings=True)
    if name == "moe-period-2":
        c = _shrink_lm(jconfigs.get("phi3.5-moe-42b-a6.6b").make_model(None))
        return dataclasses.replace(c, n_layers=4, moe=dataclasses.replace(c.moe, period=2))
    return _shrink_lm(jconfigs.get(name).make_model(None))


_JAX = {}


def _jax_grads(name, dtype, impl="einsum"):
    """(JAX config, numpy params, tokens, labels, loss, gradient tree)."""
    key = (name, dtype, impl)
    if key not in _JAX:
        jcfg = dataclasses.replace(_config(name), dtype=getattr(jnp, dtype), attn_impl=impl,
                                   blockwise_q=4, blockwise_kv=8)
        jp = jtfm.init_params(jax.random.key(0), jcfg)
        toks = np.random.default_rng(3).integers(0, jcfg.vocab, (2, 17)).astype(np.int32)
        tk, lb = jnp.asarray(toks[:, :-1]), jnp.asarray(toks[:, 1:])
        loss, grads = jax.jit(jax.value_and_grad(jtfm.loss_fn), static_argnums=3)(jp, tk, lb,
                                                                                  jcfg)
        _JAX[key] = (jcfg, jax.tree.map(np.asarray, jp), toks, float(loss), grads)
    return _JAX[key]


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], f"{prefix}{k}."))
        else:
            out[prefix + k] = tree[k]
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["deepseek-coder-33b", "tied", "moe-period-2"])
def test_loss_gradients_match_jax(name, dtype):
    jcfg, npp, toks, jloss, jgrads = _jax_grads(name, dtype)
    cfg = port_lm_config(jcfg)
    params = tfm.params_from_numpy(npp, cfg, device="cpu")
    leaves = []
    tfm.tree_map(lambda n, v: leaves.append((n, v.requires_grad_())), params)
    loss = tfm.loss_fn(params, torch.from_numpy(toks[:, :-1]), torch.from_numpy(toks[:, 1:]), cfg)
    grads = torch.autograd.grad(loss, [v for _, v in leaves])
    assert abs(float(loss) - jloss) <= LM_TOL[dtype] * abs(jloss)
    want = _flat(jgrads)
    assert sorted(want) == [n for n, _ in leaves]
    for (n, p), g in zip(leaves, grads):
        assert g.shape == p.shape and g.dtype == p.dtype
        assert_logits_close(g, want[n], LM_TOL[dtype], f"{name} {dtype} grad {n}")


def test_reference_einsum_and_blockwise_gradients_spread():
    """The reference's own two attention paths give bf16 gradients that
    differ by up to ~1.4% of a leaf's norm on the dense configs: half of
    LM_TOL's bf16 tolerance, which the port (and chip_smoke.py's full-width
    step, card against the CPU route) is held to."""
    for name in ("deepseek-coder-33b", "tied"):
        einsum = _flat(_jax_grads(name, "bfloat16")[4])
        block = _flat(_jax_grads(name, "bfloat16", "blockwise")[4])
        spread = max(float(np.linalg.norm(np.asarray(block[n], np.float32)
                                          - np.asarray(einsum[n], np.float32))
                           / np.linalg.norm(np.asarray(einsum[n], np.float32))) for n in einsum)
        assert 1e-3 < spread <= LM_TOL["bfloat16"] / 2, (name, spread)


def test_serving_paths_unchanged_by_the_split_leaves():
    """``iter_layers`` gives views of the stacked leaves (one ``unbind`` a
    leaf): prefill under no_grad builds no graph, and a layer's leaf is the
    stack's row bit for bit."""
    jcfg, npp, toks, _, _ = _jax_grads("moe-period-2", "float32")
    cfg = port_lm_config(jcfg)
    params = tfm.params_from_numpy(npp, cfg, device="cpu")
    layers = list(tfm.iter_layers(params, cfg))
    assert [m for m, _ in layers] == [False, True, False, True]
    assert layers[2][1]["wq"].equal(params["dense_layers"]["wq"][1, 0])
    assert layers[3][1]["moe_gate"].equal(params["moe_layers"]["moe_gate"][1])
    for v in params["moe_layers"].values():
        v.requires_grad_()
    cache, logits = tfm.prefill(params, torch.from_numpy(toks), cfg)
    assert not logits.requires_grad and not cache["k"].requires_grad
