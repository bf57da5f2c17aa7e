"""The port's recsys towers and CTR batches (``repro_torch.models.recsys``,
``repro_torch.data.recsys``, the four recsys configs) against the JAX
package's, on the CPU.

The JAX side draws the parameters (``init_params(jax.random.key(0))``) and
``params_from_numpy`` carries them across; the same numpy ids go through
both.  Tolerances (f32 throughout): outputs within 1e-5 of their scale,
gradients within 1e-4 (``torch_parity.assert_logits_close``: the error's
norm within tol of the norm, no element past 2 tol of the largest; the two
packages sum the same products in another order, and a bias gradient is a
mean of terms that cancel).  Row counts, table offsets, parameter counts,
retrieval ids and Zipf ids are held bit for bit.  Ports of the anchors
``tests/test_models_smoke.py:119`` and ``tests/test_hlo_and_data.py:98``.
"""
import dataclasses
import itertools
import os
import runpy
import unittest.mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_adam_close, assert_logits_close, assert_topk_match, flat_tree

from repro import configs as jconfigs
from repro.data import recsys as jrec_data
from repro.models import recsys as jrec
from repro.train import optimizer as jopt
from repro.train.train_loop import build_train_step as jbuild_train_step
from repro.train.train_loop import make_train_state as jmake_train_state
from repro_torch import configs
from repro_torch.data import recsys as rec_data
from repro_torch.models import recsys as rec
from repro_torch.models.params import tree_map
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.train_loop import build_train_step, make_train_state

REC_ARCHS = ["fm", "deepfm", "dlrm-rm2", "xdeepfm"]


def _small(arch: str, total_rows: int = 4096):
    """The JAX and port configs of ``arch`` at a small table (the published
    widths otherwise)."""
    jfull = jconfigs.get(arch).make_model(None)
    table = jrec.TableSpec(jrec.criteo_row_counts(jfull.n_fields, total_rows), jfull.dim)
    jcfg = dataclasses.replace(jfull, table=table)
    cfg = dataclasses.replace(configs.get(arch).make_model(None),
                              table=rec.TableSpec(table.row_counts, table.dim))
    return jcfg, cfg


def _batch(cfg, b: int, seed: int):
    rng = np.random.default_rng(seed)
    rows = np.asarray(cfg.table.row_counts)
    idx = rng.integers(0, rows[None, :, None], (b, cfg.n_fields, cfg.nnz)).astype(np.int32)
    dense = rng.normal(size=(b, cfg.n_dense)).astype(np.float32) if cfg.n_dense else None
    labels = (rng.random(b) < 0.5).astype(np.float32)
    return idx, dense, labels


def _jax_grads(jcfg, jp, idx, labels, dense):
    return jax.value_and_grad(jrec.bce_loss)(
        jp, jcfg, jnp.asarray(idx), jnp.asarray(labels),
        None if dense is None else jnp.asarray(dense))


def _port_grads(cfg, p, idx, labels, dense):
    leaves = []
    tree_map(lambda n, v: leaves.append((n, v.requires_grad_())), p)
    loss = rec.bce_loss(p, cfg, torch.from_numpy(idx), torch.from_numpy(labels),
                        None if dense is None else torch.from_numpy(dense))
    grads = torch.autograd.grad(loss, [v for _, v in leaves], allow_unused=True)
    return loss.detach(), {n: torch.zeros_like(v) if g is None else g
                           for (n, v), g in zip(leaves, grads)}


@pytest.mark.parametrize("arch", REC_ARCHS)
def test_published_tables_and_param_counts_equal(arch):
    jcfg, cfg = jconfigs.get(arch).make_model(None), configs.get(arch).make_model(None)
    assert cfg.table.row_counts == jcfg.table.row_counts
    assert cfg.table.offsets == jcfg.table.offsets
    assert cfg.table.total_rows == jcfg.table.total_rows and cfg.dim == jcfg.dim
    assert cfg.param_count() == jcfg.param_count()
    assert flat_tree(rec.param_shapes(cfg)).keys() == flat_tree(jrec.param_shapes(jcfg)).keys()
    for f in ("name", "model", "nnz", "n_dense", "bot_mlp", "top_mlp", "mlp", "cin_layers"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    idx = np.random.default_rng(0).integers(0, 4, (3, cfg.n_fields, 2)).astype(np.int32)
    np.testing.assert_array_equal(cfg.table.globalize(torch.from_numpy(idx)).numpy(),
                                  np.asarray(jcfg.table.globalize(jnp.asarray(idx))))


@pytest.mark.parametrize("combine,weighted", list(itertools.product(["sum", "mean"],
                                                                      [False, True])))
def test_embedding_bags_dense_ragged_and_jax_agree(combine, weighted):
    """The dense bag (with -1 padding) equals the ragged one over the same
    non-padding ids, and each equals the JAX package's."""
    rng = np.random.default_rng(1)
    table = rng.normal(size=(50, 6)).astype(np.float32)
    idx = rng.integers(-1, 50, (7, 3, 4)).astype(np.int32)
    idx[0, 0] = -1  # an empty bag
    w = rng.random(idx.shape).astype(np.float32) if weighted else None
    got = rec.embedding_bag_dense(torch.from_numpy(table), torch.from_numpy(idx),
                                  None if w is None else torch.from_numpy(w), combine)
    want = jrec.embedding_bag_dense(jnp.asarray(table), jnp.asarray(idx),
                                    None if w is None else jnp.asarray(w), combine)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    flat = idx.reshape(-1, idx.shape[-1])
    keep = flat >= 0
    values = flat[keep]
    bag_ids = np.nonzero(keep)[0].astype(np.int32)
    wv = None if w is None else w.reshape(flat.shape)[keep]
    ragged = rec.embedding_bag_ragged(torch.from_numpy(table), torch.from_numpy(values),
                                      torch.from_numpy(bag_ids), flat.shape[0],
                                      None if wv is None else torch.from_numpy(wv), combine)
    jragged = jrec.embedding_bag_ragged(jnp.asarray(table), jnp.asarray(values),
                                        jnp.asarray(bag_ids), flat.shape[0],
                                        None if wv is None else jnp.asarray(wv), combine)
    np.testing.assert_allclose(ragged.numpy(), np.asarray(jragged), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ragged.numpy().reshape(got.shape), got.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert not ragged[0].any()


def test_fm_sum_square_trick_equals_pairwise():
    emb = torch.from_numpy(np.random.default_rng(2).normal(size=(5, 9, 4)).astype(np.float64))
    pairwise = sum((emb[:, i] * emb[:, j]).sum(-1) for i in range(9) for j in range(i + 1, 9))
    torch.testing.assert_close(rec.fm_interaction(emb), pairwise, rtol=1e-12, atol=1e-12)
    e32 = emb.float()
    np.testing.assert_allclose(rec.fm_interaction(e32).numpy(),
                               np.asarray(jrec.fm_interaction(jnp.asarray(e32.numpy()))),
                               rtol=1e-5, atol=1e-5)


def test_dot_interaction_and_cin_equal_jax():
    rng = np.random.default_rng(3)
    vecs = rng.normal(size=(4, 6, 5)).astype(np.float32)
    np.testing.assert_allclose(rec.dot_interaction(torch.from_numpy(vecs)).numpy(),
                               np.asarray(jrec.dot_interaction(jnp.asarray(vecs))),
                               rtol=1e-5, atol=1e-6)
    params = {f"cin{i}": {"w": rng.normal(size=(h_prev * 6, h)).astype(np.float32)}
              for i, (h_prev, h) in enumerate([(6, 3), (3, 2)])}
    got = rec.cin(torch.from_numpy(vecs), {k: {"w": torch.from_numpy(v["w"])}
                                            for k, v in params.items()}, (3, 2))
    want = jrec.cin(jnp.asarray(vecs), jax.tree.map(jnp.asarray, params), (3, 2))
    assert_logits_close(got, want, 1e-5, "cin")


@pytest.mark.parametrize("arch", REC_ARCHS)
def test_forward_loss_and_grads_match_jax(arch):
    """Anchor ``tests/test_models_smoke.py:119`` at its table (4,096 rows,
    the published widths): logits, loss and every leaf's gradient against
    ``jax.value_and_grad``; the user tower and the retrieval path too."""
    jcfg, cfg = _small(arch)
    jp = jrec.init_params(jax.random.key(0), jcfg)
    p = rec.params_from_numpy(jp, cfg, device="cpu")
    idx, dense, labels = _batch(cfg, 8, 4)
    jdense = None if dense is None else jnp.asarray(dense)
    tdense = None if dense is None else torch.from_numpy(dense)
    logit = rec.forward(p, cfg, torch.from_numpy(idx), tdense)
    jlogit = jrec.forward(jp, jcfg, jnp.asarray(idx), jdense)
    assert logit.shape == (8,) and bool(torch.isfinite(logit).all())
    assert_logits_close(logit, jlogit, 1e-5)
    jloss, jgrads = _jax_grads(jcfg, jp, idx, labels, dense)
    loss, grads = _port_grads(cfg, p, idx, labels, dense)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    jflat = flat_tree(jgrads)
    assert grads.keys() == jflat.keys()
    for name, g in grads.items():
        if np.abs(jflat[name]).max() == 0:  # a leaf the loss does not use (DLRM's bias)
            assert not g.any(), name
            continue
        assert_logits_close(g, jflat[name], 1e-4, f"gradient of {name}")
    u = rec.user_tower(p, cfg, torch.from_numpy(idx), tdense)
    ju = jrec.user_tower(jp, jcfg, jnp.asarray(idx), jdense)
    assert_logits_close(u, ju, 1e-5, "user tower")
    cand = np.random.default_rng(5).normal(size=(1000, cfg.dim)).astype(np.float32)
    s, ids = rec.retrieval_topk(u.detach(), torch.from_numpy(cand), k=10)
    js, jids = jrec.retrieval_topk(ju, jnp.asarray(cand), k=11)
    assert s.shape == (8, 10) and ids.dtype == torch.int32
    assert_topk_match((s.numpy(), ids.numpy()), (np.asarray(js), np.asarray(jids)), exact=False)


def test_xdeepfm_cin_in_row_slices_equals_whole(monkeypatch):
    """xDeepFM's CIN runs ``_CIN_ROWS`` rows at a time (its outer product is
    312 KB a row at the published widths): ``forward`` over slices of 5 rows
    gives the whole batch's logits, and JAX's."""
    jcfg, cfg = _small("xdeepfm")
    jp = jrec.init_params(jax.random.key(0), jcfg)
    p = rec.params_from_numpy(jp, cfg, device="cpu")
    idx, _, _ = _batch(cfg, 12, 6)
    sp = torch.from_numpy(idx)
    whole = rec.forward(p, cfg, sp)
    monkeypatch.setattr(rec, "_CIN_ROWS", 5)
    sliced = rec.forward(p, cfg, sp)
    torch.testing.assert_close(sliced, whole, rtol=1e-6, atol=1e-6)
    assert_logits_close(sliced, jrec.forward(jp, jcfg, jnp.asarray(idx)), 1e-5)


@pytest.mark.parametrize("k", [5, 37])
def test_retrieval_topk_keeps_lax_top_k_ties(k):
    """Integer-valued user and candidate vectors (every score exact in f32)
    with duplicated candidate rows: the ids equal ``lax.top_k``'s, ties to
    the lowest id."""
    rng = np.random.default_rng(7)
    cand = rng.integers(-3, 4, (200, 8)).astype(np.float32)
    cand[100:150] = cand[:50]  # planted ties across the table
    cand[150:] = cand[10]
    users = rng.integers(-2, 3, (6, 8)).astype(np.float32)
    users[0] = 0.0  # every score ties
    s, ids = rec.retrieval_topk(torch.from_numpy(users), torch.from_numpy(cand), k)
    js, jids = jrec.retrieval_topk(jnp.asarray(users), jnp.asarray(cand), k)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(ids[0].numpy(), np.arange(k))


def test_params_from_numpy_checks_keys_and_shapes():
    jcfg, cfg = _small("fm", 1024)
    tree = jax.tree.map(np.asarray, jrec.init_params(jax.random.key(0), jcfg))
    p = rec.params_from_numpy(tree, cfg, device="cpu")
    assert all(x.dtype == np.float32 for x in flat_tree(p).values())
    with pytest.raises(ValueError, match="keys"):
        rec.params_from_numpy({**tree, "extra": tree["bias"]}, cfg, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        rec.params_from_numpy({**tree, "bias": np.zeros(2, np.float32)}, cfg, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            rec.init_params(cfg)  # the card by default


def test_batches_in_range_with_zipf_skew():
    """Anchor ``tests/test_hlo_and_data.py:98`` on the port's stream; and at
    DLRM's published tables (field 0: 26,157,319 rows, past 2**24) no id
    is negative or past its field, though ~1.4% of the uniforms give ranks
    past int32."""
    table = rec.TableSpec(rec.criteo_row_counts(10, 8192), 8)
    cfg = rec_data.RecsysDataConfig(table=table, batch=64, n_dense=4, seed=1)
    b = rec_data.batch_at(cfg, 7, device="cpu")
    rows = np.asarray(table.row_counts)
    sp = b["sparse"].numpy()
    assert sp.dtype == np.int32 and sp.shape == (64, 10, 1)
    assert (sp < rows[None, :, None]).all() and (sp >= 0).all()
    assert set(np.unique(b["label"].numpy())) <= {0.0, 1.0}
    assert b["dense"].shape == (64, 4) and b["dense"].dtype == torch.float32
    frac_small = (sp[:, 0] < 10).mean()
    assert frac_small > 20 * (10.0 / table.row_counts[0])
    again = rec_data.batch_at(cfg, 7, device="cpu")
    assert all(torch.equal(b[k], again[k]) for k in b)  # stateless: f(seed, step)
    dlrm = configs.get("dlrm-rm2").make_model(None)
    big = rec_data.batch_at(rec_data.RecsysDataConfig(table=dlrm.table, batch=512, n_dense=13),
                            0, device="cpu")["sparse"].numpy()
    big_rows = np.asarray(dlrm.table.row_counts)[None, :, None]
    assert (big >= 0).all() and (big < big_rows).all()
    assert (big == big_rows - 1).mean() > 0.005  # the saturating draws hit each field's cap


def test_zipf_ids_equal_the_reference_on_the_same_uniforms():
    """The reference's ``_zipf_in_range`` fed the port's uniforms (its
    ``jax.random.uniform`` patched to return them): the same ids bit for
    bit, at a field past 2**24 rows and at small ones, the saturating draws
    (u < 2**-6.2: ranks past int32) included."""
    u = rec_data._uniforms(3, 0, (400_000,))
    u[:6] = [1e-6, 2.0**-7, 2.0**-6.2, 0.034, 0.5, 0.99999]
    for n_rows in (26_157_319, 70_000, 3000, 4):
        with unittest.mock.patch.object(jax.random, "uniform",
                                        lambda *a, **kw: jnp.asarray(u)):
            want = np.asarray(jrec_data._zipf_in_range(jax.random.key(0), u.shape,
                                                       jnp.int32(n_rows), 1.2))
        got = rec_data._zipf_in_range(u, n_rows, 1.2)
        np.testing.assert_array_equal(got, want)
        assert got.min() >= 0 and got.max() == n_rows - 1


def test_fm_adamw_steps_match_jax():
    """A few ``build_train_step`` AdamW steps of FM (1 and 2 microbatches)
    against the JAX step on the same batches: losses and gradient norms
    within 1e-5, every parameter after the steps by
    ``torch_parity.assert_adam_close``."""
    jcfg, cfg = _small("fm", 2048)
    jp = jrec.init_params(jax.random.key(1), jcfg)
    for micro in (1, 2):
        opt, jo = opt_mod.adamw(lr=1e-2), jopt.adamw(lr=1e-2)
        state = make_train_state(rec.params_from_numpy(jp, cfg, device="cpu"), opt)
        jstate = jmake_train_state(jp, jo)
        step = build_train_step(lambda p, b: rec.bce_loss(p, cfg, b["sparse"], b["label"]), opt,
                                micro)
        jstep = jax.jit(jbuild_train_step(
            lambda p, b: jrec.bce_loss(p, jcfg, b["sparse"], b["label"]), jo, micro))
        for i in range(4):
            idx, _, labels = _batch(cfg, 16, 10 + i)
            state, m = step(state, {"sparse": torch.from_numpy(idx),
                                    "label": torch.from_numpy(labels)})
            jstate, jm = jstep(jstate, {"sparse": jnp.asarray(idx), "label": jnp.asarray(labels)})
            for key in ("loss", "grad_norm"):
                np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5)
        assert_adam_close(flat_tree(state.params), flat_tree(jstate.params), flat_tree(jp), 1e-2, 4)


def test_adamw_in_slices_equals_whole_leaves(monkeypatch):
    """AdamW updates a leaf past ``_CHUNK`` elements in slices: the same
    parameters and moments bit for bit as one slice a leaf."""
    _, cfg = _small("deepfm", 1024)
    grads = rec.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    results = []
    for chunk in (opt_mod._CHUNK, 1000):
        monkeypatch.setattr(opt_mod, "_CHUNK", chunk)
        opt = opt_mod.adamw(lr=1e-2, max_grad_norm=0.5)
        params = rec.init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
        state = opt.init(params)
        for _ in range(3):
            params, state, _ = opt.update(grads, state, params)
        results.append((params, state["mu"], state["nu"]))
    for a, b in zip(*results):
        fa, fb = flat_tree(a), flat_tree(b)
        assert all(np.array_equal(fa[k], fb[k]) for k in fa)


def test_recsys_retrieval_example_on_the_cpu():
    """``examples/recsys_retrieval_torch.py --device cpu`` keeps its
    reference's assertion (R@(10,100) + rerank > 0.6 against brute force)."""
    path = os.path.join(os.path.dirname(__file__), "..", "examples", "recsys_retrieval_torch.py")
    runpy.run_path(path)["main"](["--device", "cpu"])
