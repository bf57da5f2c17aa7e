"""``examples/knn_lm_torch.py`` against the reference example
(``examples/knn_lm.py``), on the CPU.

The JAX side draws the micro LM's parameters and ``params_from_numpy``
carries them across; both examples' own functions run on the same numpy
inputs.  Tolerances:

  * hidden states: the LM parity tests' (``assert_logits_close``, f32 1e-4,
    bf16 2e-2);
  * the datastore search (one datastore of JAX's hidden states): the
    near-tie rule (``assert_topk_match``, 1e-5);
  * p_kNN and the NLLs on the same scores, ids and logits: 1e-6 (the
    scatter-add of two neighbours that store one token sums in another
    order).
"""
import dataclasses
import importlib.util
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_logits_close, assert_topk_match, port_lm_config, to_torch

from repro.core import bruteforce as jbf
from repro.core import fakewords as jfw
from repro.core.types import FakeWordsConfig as JFakeWordsConfig
from repro.launch.train import micro_lm_config as jmicro
from repro.models import transformer as jtfm
from repro_torch.core import bruteforce, fakewords
from repro_torch.core.types import FakeWordsConfig
from repro_torch.models import transformer as tfm

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
LM_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jknn = _load("knn_lm")
knn = _load("knn_lm_torch")


def _micro(dtype):
    jcfg = dataclasses.replace(jmicro(), dtype=jnp.dtype(dtype))
    return jcfg, port_lm_config(jcfg), jtfm.init_params(jax.random.key(0), jcfg)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hidden_states_match_reference(dtype):
    jcfg, cfg, jparams = _micro(dtype)
    toks = _tokens(0, (8, 64), cfg.vocab)
    want = jknn.hidden_states(jparams, jnp.asarray(toks), jcfg)
    params = tfm.params_from_numpy(jparams, cfg, device="cpu")
    with torch.no_grad():
        got = knn.hidden_states(params, torch.from_numpy(toks), cfg)
    assert got.dtype == cfg.dtype and got.shape == (8, 64, cfg.d_model)
    assert_logits_close(got, np.asarray(want, np.float32), LM_TOL[dtype], f"hidden {dtype}")


def _reference_eval(s, ids, vals, logits, labels, vocab):
    """The reference example's p_kNN and NLL lines (``knn_lm.py:78-92``),
    on given scores, ids, stored tokens, logits and labels."""
    w = jax.nn.softmax(s * 10.0, axis=-1)
    knn_tokens = jnp.asarray(vals)[ids]
    p_knn = jnp.zeros((s.shape[0], vocab))
    p_knn = p_knn.at[jnp.arange(s.shape[0])[:, None], knn_tokens].add(w)
    p_lm = jax.nn.softmax(logits.reshape(-1, vocab), axis=-1)

    def nll(p):
        pt = p[jnp.arange(labels.shape[0]), labels]
        return float(-jnp.mean(jnp.log(jnp.maximum(pt, 1e-9))))

    return p_knn, [nll((1 - lam) * p_lm + lam * p_knn) for lam in knn.LAMBDAS]


def test_datastore_search_knn_probs_and_nlls_match_reference():
    """A datastore of the reference LM's hidden states (2 batches): both
    packages' fake-words search (Q = 50, k 16, depth 64, rerank) on the
    same keys and f32 queries under the near-tie rule, then p_kNN and the
    three NLLs of both examples on the reference's search results."""
    jcfg, cfg, jparams = _micro("bfloat16")
    keys = np.concatenate([np.asarray(jknn.hidden_states(
        jparams, jnp.asarray(_tokens(seed, (8, 64), cfg.vocab)), jcfg), np.float32).reshape(
        -1, cfg.d_model) for seed in (1, 2)])
    vals = _tokens(3, (keys.shape[0],), 40)  # few distinct tokens: neighbours share them
    qtoks = _tokens(4, (2, 64), cfg.vocab)
    h = jknn.hidden_states(jparams, jnp.asarray(qtoks), jcfg)
    logits = jtfm.forward(jparams, jnp.asarray(qtoks), jcfg)
    labels = _tokens(5, (2 * 64,), cfg.vocab)
    # f32 queries: in bf16 the packages' l2_normalize rounds a row's norm
    # apart by up to a bf16 step, which scales a row's reranked scores by
    # ~0.5% (the examples pass the bf16 states, ``test_main_runs_on_cpu``)
    q = h.reshape(-1, cfg.d_model).astype(jnp.float32)

    jcf = JFakeWordsConfig(quantization=50)
    jidx = jfw.build(jnp.asarray(keys), jcf)
    want = jfw.search(jidx, jfw.encode_queries(q, jcf), jbf.l2_normalize(q), k=17, depth=64,
                      rerank=True, use_kernel=False)
    fw = FakeWordsConfig(quantization=50)
    tq = to_torch(q)
    got = fakewords.search(fakewords.build(torch.from_numpy(keys), fw),
                           fakewords.encode_queries(tq, fw), bruteforce.l2_normalize(tq),
                           k=16, depth=64, rerank=True)
    assert_topk_match(got, want, exact=False)

    s, ids = (np.array(x)[:, :16] for x in want)
    p_want, nll_want = _reference_eval(jnp.asarray(s), jnp.asarray(ids), vals,
                                       logits, jnp.asarray(labels), cfg.vocab)
    p_knn = knn.knn_probs(torch.from_numpy(s), torch.from_numpy(ids), torch.from_numpy(vals),
                          cfg.vocab)
    np.testing.assert_allclose(p_knn.numpy(), np.asarray(p_want), atol=1e-6)
    assert int((np.asarray(p_want) > 0).sum(1).min()) < 16  # a row where two neighbours share
    p_lm = torch.softmax(torch.from_numpy(np.array(logits)).reshape(-1, cfg.vocab), dim=-1)
    for lam, w in zip(knn.LAMBDAS, nll_want):
        np.testing.assert_allclose(
            knn.nll((1 - lam) * p_lm + lam * p_knn, torch.from_numpy(labels)), w, rtol=1e-6)


def test_main_runs_on_cpu(capsys):
    out = knn.main(["--device", "cpu", "--steps", "20"])
    text = capsys.readouterr().out
    assert "== training micro-LM (20 steps)" in text
    assert "datastore: 8192 entries x 128d" in text
    assert sorted(out["nll"]) == list(knn.LAMBDAS)
    assert all(math.isfinite(v) for v in out["nll"].values())
    for lam, v in out["nll"].items():
        assert f"lambda={lam:.2f}: NLL {v:.4f}" in text
    # lambda 0 is the LM alone: its softmax's NLL is the LM's cross-entropy
    assert abs(out["nll"][0.0] - out["lm_nll"]) <= 1e-5 * out["lm_nll"]
