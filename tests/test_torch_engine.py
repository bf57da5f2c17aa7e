"""The port's continuous-batching engine (``repro_torch.serve.engine``) on
the CPU route: the four engine anchors of ``tests/test_serve.py:21,40,52,71``
on the anchors' ``_tiny`` model (bf16), and the port's ``DecodeEngine``
against the JAX package's on the same weights (carried across by
``params_from_numpy``) and prompts.

At f32 the two engines' tokens are identical.  At bf16 they may part only
where the reference's greedy logits have a near-tie (top two within 2e-2
of the logits' largest magnitude, ``test_torch_transformer``'s bf16
tolerance): the port's attention multiplies probabilities by V in f32
(K9's plain version) where the reference's einsum casts them to bf16.  The
test reports each such parting.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import port_lm_config

from repro import configs as jconfigs
from repro.launch import train as jtrain
from repro.models import transformer as jtfm
from repro.serve import engine as jengine
from repro_torch.models import transformer as tfm
from repro_torch.serve.engine import DecodeEngine, EngineConfig, Request

CPU = "cpu"
NEAR_TIE = 2e-2  # of the logits' largest magnitude (the bf16 tolerance)


def _tiny(dtype="bfloat16"):
    """The anchors' model (``tests/test_serve.py:15-18``): JAX config and
    params, the port's config and params."""
    jcfg = jtfm.TransformerConfig(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
                                  vocab=64, dtype=getattr(jnp, dtype))
    return _carried(jcfg, 1)


def _carried(jcfg, seed):
    jp = jtfm.init_params(jax.random.key(seed), jcfg)
    cfg = port_lm_config(jcfg)
    return jcfg, jp, cfg, tfm.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device=CPU)


def _engine(params, cfg, **ecfg):
    return DecodeEngine(params, cfg, EngineConfig(**ecfg), device=CPU)


def _greedy(params, cfg, prompt, n, eos):
    """The anchor's greedy recompute: ``prefill`` of the growing sequence."""
    cur, out = list(prompt), []
    for _ in range(n):
        _, lg = tfm.prefill(params, torch.tensor([cur]), cfg)
        nxt = int(torch.argmax(lg[0]))
        out.append(nxt)
        if nxt == eos:
            break
        cur.append(nxt)
    return out


def test_engine_matches_greedy_reference():
    _, _, cfg, params = _tiny()
    rng = np.random.default_rng(11)
    eng = _engine(params, cfg, batch_slots=2, max_len=32, eos_id=1)
    prompt = rng.integers(2, 64, 6).astype(np.int32)
    req = Request(uid=0, prompt=prompt, max_new_tokens=5)
    eng.submit(req)
    eng.run(max_steps=30)
    ref = _greedy(params, cfg, prompt, 5, 1)
    assert req.out_tokens[: len(ref)] == ref


def test_engine_continuous_batching_slot_reuse():
    _, _, cfg, params = _tiny()
    rng = np.random.default_rng(12)
    eng = _engine(params, cfg, batch_slots=2, max_len=64, eos_id=0)
    reqs = [Request(uid=i, prompt=rng.integers(2, 64, 4).astype(np.int32), max_new_tokens=3)
            for i in range(5)]
    for r in reqs:
        eng.submit(r)
    eng.run(max_steps=60)
    assert all(r.done for r in reqs)  # all 5 served through 2 slots
    assert all(len(r.out_tokens) <= 3 for r in reqs)


def test_engine_isolation_between_concurrent_requests():
    """A request's tokens do not depend on what shares the batch: bit for
    bit on the CPU route, and its cache rows too."""
    _, _, cfg, params = _tiny()
    rng = np.random.default_rng(13)
    prompt = rng.integers(2, 64, 6).astype(np.int32)
    e1 = _engine(params, cfg, batch_slots=2, max_len=32, eos_id=1)
    r_alone = Request(uid=0, prompt=prompt, max_new_tokens=4)
    e1.submit(r_alone)
    e1.run(max_steps=30)
    e2 = _engine(params, cfg, batch_slots=2, max_len=32, eos_id=1)
    r_shared = Request(uid=0, prompt=prompt, max_new_tokens=4)
    other = Request(uid=1, prompt=rng.integers(2, 64, 9).astype(np.int32), max_new_tokens=4)
    e2.submit(r_shared)
    e2.submit(other)
    e2.run(max_steps=30)
    assert r_alone.out_tokens == r_shared.out_tokens
    assert torch.equal(e1.cache["k"][:, 0], e2.cache["k"][:, 0])
    assert torch.equal(e1.cache["v"][:, 0], e2.cache["v"][:, 0])


def test_engine_second_run_and_direct_step_drain():
    """run() bounds the steps taken within the call (not the cumulative
    counter), and hands back requests retired by direct step() calls
    exactly once."""
    _, _, cfg, params = _tiny()
    rng = np.random.default_rng(14)
    eng = _engine(params, cfg, batch_slots=2, max_len=64, eos_id=0)
    r1 = Request(uid=0, prompt=rng.integers(2, 64, 4).astype(np.int32), max_new_tokens=3)
    eng.submit(r1)
    done1 = eng.run(max_steps=10)
    assert r1 in done1 and r1.done
    r2 = Request(uid=1, prompt=rng.integers(2, 64, 4).astype(np.int32), max_new_tokens=2)
    eng.submit(r2)
    while not r2.done:
        eng.step()
    assert eng.run(max_steps=10) == [r2]
    eng.steps = 10_000  # a long-lived engine
    r3 = Request(uid=2, prompt=rng.integers(2, 64, 4).astype(np.int32), max_new_tokens=3)
    eng.submit(r3)
    done3 = eng.run(max_steps=10)
    assert r3 in done3 and r3.done
    assert eng.run(max_steps=10) == []


def _serve(engine, request, prompts, new=6):
    reqs = [request(uid=i, prompt=p, max_new_tokens=new) for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.run(max_steps=200)
    assert all(r.done for r in reqs)
    return reqs


def _both_engines(jcfg, jp, cfg, params, prompts):
    """The same prompts served by the JAX engine and by the port's (2
    slots, max_len 40, eos 1); both lists of requests, in submit order."""
    ecfg = dict(batch_slots=2, max_len=40, eos_id=1)
    return (_serve(jengine.DecodeEngine(jp, jcfg, jengine.EngineConfig(**ecfg)),
                   jengine.Request, prompts),
            _serve(DecodeEngine(params, cfg, EngineConfig(**ecfg), device=CPU), Request, prompts))


def _prompts(seed, vocab, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, n).astype(np.int32) for n in lengths]


def _shrunk_llama4():
    """llama4-maverick shrunk as the model anchors shrink it (dense + MoE
    layers with a shared expert, top-1 routing over 4 experts), in f32."""
    cfg = jconfigs.get("llama4-maverick-400b-a17b").make_model(None)
    return dataclasses.replace(
        cfg, n_layers=4, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16, d_ff=128, vocab=256,
        moe=dataclasses.replace(cfg.moe, num_experts=4, d_ff=64), param_dtype=jnp.float32,
        dtype=jnp.float32)


@pytest.mark.parametrize("model", ["tiny", "micro-lm", "llama4-shrunk"])
def test_engine_equals_jax_engine_f32(model):
    """Five requests through 2 slots (slots reused, per-slot lengths apart)
    at f32: the port's tokens equal the JAX engine's, token for token.  On
    the shrunk llama4 both engines' batched decode leaves the shared
    expert out (the reference's engine does)."""
    if model == "tiny":
        jcfg = jtfm.TransformerConfig(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
                                      vocab=64, dtype=jnp.float32)
    elif model == "micro-lm":
        jcfg = dataclasses.replace(jtrain.micro_lm_config(), dtype=jnp.float32)
    else:
        jcfg = _shrunk_llama4()
    jcfg, jp, cfg, params = _carried(jcfg, 2)
    prompts = _prompts(21, jcfg.vocab, (6, 9, 6, 9, 6))
    jreqs, reqs = _both_engines(jcfg, jp, cfg, params, prompts)
    for jr, r in zip(jreqs, reqs):
        assert r.out_tokens == jr.out_tokens, (r.uid, r.out_tokens, jr.out_tokens)


def test_engine_equals_jax_engine_bf16_up_to_near_ties():
    """The anchors' bf16 ``_tiny``: each request's tokens equal the JAX
    engine's, or part at a step where the reference's greedy logits
    (``prefill`` of the shared prefix) hold a near-tie; each parting is
    reported."""
    jcfg, jp, cfg, params = _tiny()
    prompts = _prompts(22, 64, (6, 9, 6, 9, 6))
    jreqs, reqs = _both_engines(jcfg, jp, cfg, params, prompts)
    for jr, r in zip(jreqs, reqs):
        if r.out_tokens == jr.out_tokens:
            continue
        j = next(i for i, (a, b) in enumerate(zip(r.out_tokens, jr.out_tokens)) if a != b)
        seq = list(r.prompt) + r.out_tokens[:j]
        _, lg = jtfm.prefill(jp, jnp.asarray([seq], jnp.int32), jcfg)
        top2 = np.sort(np.asarray(lg[0]))[-2:]
        gap = float(top2[1] - top2[0]) / float(np.abs(np.asarray(lg[0])).max())
        print(f"request {r.uid}: the engines part at token {j} ({r.out_tokens[j]} against "
              f"{jr.out_tokens[j]}), the reference's top-two gap {gap:.3g} of the scale")
        assert gap <= NEAR_TIE, (r.uid, j, gap)
