"""The port's GraphSAGE and graph data (``repro_torch.models.gnn``,
``repro_torch.data.graph``, ``configs/graphsage_reddit.py``) and the
registry against the JAX package's, on the CPU.

``make_graph`` and ``edge_list`` are held bit for bit (the generator is the
reference's numpy, line for line).  Forwards, losses and gradients run on
the JAX package's own parameters (``params_from_numpy``), graphs and
sampled blocks, at the four cells shrunk (anchor
``tests/test_models_smoke.py:87``): logits and losses within 1e-5 of their
scale, gradients within 1e-4 (``torch_parity.assert_logits_close``; the
two packages scatter-add the same messages in another order).  The
sampler draws on the port's own generator (threefry is not reproduced):
its invariants are the anchor ``tests/test_hlo_and_data.py:113``'s.
"""
import dataclasses
import os
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_adam_close, assert_logits_close, flat_tree

from repro import configs as jconfigs
from repro.data import graph as jgraph
from repro.models import gnn as jgnn
from repro.train import optimizer as jopt
from repro.train.train_loop import build_train_step as jbuild_train_step
from repro.train.train_loop import make_train_state as jmake_train_state
from repro_torch import configs
from repro_torch.data import graph as gdata
from repro_torch.models import gnn
from repro_torch.models.params import tree_map
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.train_loop import build_train_step, make_train_state

CELLS = ["full_graph_sm", "minibatch_lg", "ogb_products", "molecule"]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _graphs(n: int, e: int, d: int = 12, c: int = 5):
    cfg = dict(n_nodes=n, n_edges=e, d_feat=d, n_classes=c)
    return jgraph.make_graph(jgraph.GraphConfig(**cfg)), gdata.make_graph(
        gdata.GraphConfig(**cfg), device="cpu")


def _configs(cell_name: str):
    """The cell's JAX and port configs with the widths cut (d_in 12, d_hidden
    16, 5 classes; the cell's fanouts kept)."""
    jspec, spec = jconfigs.get("graphsage-reddit"), configs.get("graphsage-reddit")
    jcfg = dataclasses.replace(jspec.make_model(jspec.cell(cell_name)), d_in=12, d_hidden=16,
                               n_classes=5)
    cfg = dataclasses.replace(spec.make_model(spec.cell(cell_name)), d_in=12, d_hidden=16,
                              n_classes=5)
    return jcfg, cfg


@pytest.mark.parametrize("n,e", [(60, 240), (3000, 15000), (20000, 800_000)])
def test_make_graph_and_edge_list_bit_for_bit(n, e):
    """At 800,000 edges some of the 1.6M uniforms lie below 2**-19, where
    the reference's float64 -> int64 cast overflows: the copy keeps that."""
    jg, g = _graphs(n, e)
    for k in ("indptr", "indices", "feats", "labels"):
        want = np.asarray(getattr(jg, k))
        got = getattr(g, k).numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), k
    assert (g.n_nodes, g.n_edges) == (jg.n_nodes, jg.n_edges)
    for got, want in zip(g.edge_list(), jg.edge_list()):
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), np.asarray(want))


def test_sampler_invariants_and_padding():
    """Anchor ``tests/test_hlo_and_data.py:113`` on the port's sampler, and
    -1 padding for isolated nodes and under padded hop-1 slots."""
    _, g = _graphs(300, 1200, 4, 3)
    gen = torch.Generator().manual_seed(0)
    ip, ind = g.indptr.numpy(), g.indices.numpy()
    seeds = gdata.batch_seeds(gen, 300, 32)
    assert seeds.dtype == torch.int32 and int(seeds.min()) >= 0 and int(seeds.max()) < 300
    nbr = gdata.sample_neighbors(gen, g.indptr, g.indices, seeds, 7)
    assert nbr.shape == (32, 7) and nbr.dtype == torch.int32
    for i, s in enumerate(seeds.numpy()):
        neigh = set(ind[ip[s]: ip[s + 1]])
        for x in nbr[i].numpy():
            if x >= 0:
                assert x in neigh
            else:
                assert len(neigh) == 0  # -1 only for isolated nodes
    deg = ip[1:] - ip[:-1]
    assert deg.max() > 10 * max(1, int(np.median(deg)))
    isolated = np.nonzero(deg == 0)[0]
    assert len(isolated) > 0
    iso = torch.from_numpy(isolated[:4].astype(np.int32))
    assert (gdata.sample_neighbors(gen, g.indptr, g.indices, iso, 5) == -1).all()
    n1, n2 = gdata.sample_two_hop(gen, g.indptr, g.indices, torch.cat([iso, seeds]), (6, 4))
    assert n1.shape == (36, 6) and n2.shape == (36, 6, 4)
    assert (n2[n1 < 0] == -1).all() and (n1[:4] == -1).all()
    for i, row in enumerate(n1.numpy()):
        for j, x in enumerate(row):
            if x >= 0:
                got = n2[i, j].numpy()
                neigh = set(ind[ip[x]: ip[x + 1]])
                assert all(v in neigh for v in got) if neigh else (got == -1).all()
    mb = gdata.make_molecule_batch(gen, 4, 10, 20, 12, 5)
    assert mb["feats"].shape == (4, 10, 12) and mb["src"].dtype == torch.int32
    assert int(mb["src"].max()) < 10 and int(mb["labels"].max()) < 5


def test_mean_aggregate_gives_isolated_nodes_zero():
    h = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    src = torch.tensor([0, 1, 2], dtype=torch.int32)
    dst = torch.tensor([1, 1, 3], dtype=torch.int32)
    out = gnn.mean_aggregate(h, src, dst, 4)
    want = np.asarray(jgnn.mean_aggregate(jnp.asarray(h.numpy()), jnp.asarray(src.numpy()),
                                          jnp.asarray(dst.numpy()), 4))
    np.testing.assert_array_equal(out.numpy(), want)
    assert not out[0].any() and not out[2].any()
    torch.testing.assert_close(out[1], h[:2].mean(0))


def _cell_inputs(cell_name: str, jcfg):
    """The cell's path on JAX's inputs: (the JAX forward and loss, their
    inputs, the port's forward and loss, theirs); a loss takes the
    forward's inputs and then its labels (and the full graph's mask)."""
    if cell_name in ("full_graph_sm", "ogb_products"):
        jg, g = _graphs(60, 240)
        mask = (np.arange(60) % 3 != 0).astype(np.float32)
        jx, x = (jg.feats, *jg.edge_list()), (g.feats, *g.edge_list())
        return (jgnn.forward_full, jgnn.loss_full, jx, (jg.labels, jnp.asarray(mask)),
                gnn.forward_full, gnn.loss_full, x, (g.labels, _t(mask)))
    if cell_name == "minibatch_lg":
        jg, g = _graphs(100, 500)
        seeds = jgraph.batch_seeds(jax.random.key(1), 100, 8)
        n1, n2 = jgraph.sample_two_hop(jax.random.key(2), jg.indptr, jg.indices, seeds,
                                       jcfg.fanouts)
        assert bool((n2 < 0).any())  # padded slots are exercised
        jx = (jg.feats, seeds, n1, n2)
        return (jgnn.forward_sampled, jgnn.loss_sampled, jx, (jg.labels[seeds],),
                gnn.forward_sampled, gnn.loss_sampled, (g.feats, *(_t(a) for a in jx[1:])),
                (_t(jg.labels[seeds]),))
    mb = jgraph.make_molecule_batch(jax.random.key(3), 4, 10, 20, 12, 5)
    jx = (mb["feats"], mb["src"], mb["dst"])
    return (jgnn.forward_batched, jgnn.loss_batched, jx, (mb["labels"],),
            gnn.forward_batched, gnn.loss_batched, tuple(_t(a) for a in jx), (_t(mb["labels"]),))


@pytest.mark.parametrize("cell", CELLS)
def test_forward_loss_and_grads_match_jax(cell):
    """Anchor ``tests/test_models_smoke.py:87``: each cell's path (full
    graph, sampled, batched graphs) on the JAX package's parameters and
    inputs; logits, loss, every leaf's gradient, and the node embeddings
    of the full-graph cells."""
    jcfg, cfg = _configs(cell)
    jp = jgnn.init_params(jax.random.key(0), jcfg)
    p = gnn.params_from_numpy(jp, cfg, device="cpu")
    jfwd, jloss_fn, jx, jy, fwd, loss_fn, x, y = _cell_inputs(cell, jcfg)
    logits, jlogits = fwd(p, *x, cfg), jfwd(jp, *jx, jcfg)
    assert logits.shape == jlogits.shape
    assert_logits_close(logits, jlogits, 1e-5)
    jloss, jgrads = jax.value_and_grad(jloss_fn)(jp, *jx, *jy, jcfg)
    leaves = []
    tree_map(lambda n, v: leaves.append((n, v.requires_grad_())), p)
    loss = loss_fn(p, *x, *y, cfg)
    grads = torch.autograd.grad(loss, [v for _, v in leaves])
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    jflat = flat_tree(jgrads)
    for (name, _), g in zip(leaves, grads):
        assert_logits_close(g, jflat[name], 1e-4, f"gradient of {name}")
    if fwd is gnn.forward_full:
        emb = gnn.embeddings_full(p, *x, cfg)
        assert_logits_close(emb, jgnn.embeddings_full(jp, *jx, jcfg), 1e-5, "embeddings")
        np.testing.assert_allclose(np.linalg.norm(emb.detach().numpy(), axis=-1), 1.0, rtol=1e-5)


def test_params_from_numpy_and_init_follow_the_reference():
    jcfg, cfg = _configs("minibatch_lg")
    tree = jax.tree.map(np.asarray, jgnn.init_params(jax.random.key(0), jcfg))
    p = gnn.params_from_numpy(tree, cfg, device="cpu")
    mine = gnn.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert flat_tree(p).keys() == flat_tree(mine).keys()
    for name, x in flat_tree(mine).items():
        assert x.shape == flat_tree(p)[name].shape and x.dtype == np.float32
        if x.ndim == 1:
            assert not x.any()
        else:  # N(0, 1 / fan_in)
            assert abs(x.std() * np.sqrt(x.shape[0]) - 1) < 0.2
    with pytest.raises(ValueError, match="shape"):
        gnn.params_from_numpy({**tree, "classifier": {"w": tree["classifier"]["w"][:1],
                                                      "b": tree["classifier"]["b"]}},
                              cfg, device="cpu")


def test_sage_adamw_steps_match_jax():
    """A few ``build_train_step`` AdamW steps of full-graph GraphSAGE
    against the JAX step: losses and gradient norms within 1e-5, the
    parameters by ``torch_parity.assert_adam_close``."""
    jcfg, cfg = _configs("full_graph_sm")
    jp = jgnn.init_params(jax.random.key(4), jcfg)
    _, jloss_fn, jx, jy, _, loss_fn, x, y = _cell_inputs("full_graph_sm", jcfg)
    opt, jo = opt_mod.adamw(lr=1e-2), jopt.adamw(lr=1e-2)
    state = make_train_state(gnn.params_from_numpy(jp, cfg, device="cpu"), opt)
    jstate = jmake_train_state(jp, jo)
    step = build_train_step(lambda q, _: loss_fn(q, *x, *y, cfg), opt)
    jstep = jax.jit(jbuild_train_step(lambda q, _: jloss_fn(q, *jx, *jy, jcfg), jo))
    for _ in range(4):
        state, m = step(state, {})
        jstate, jm = jstep(jstate, {})
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5)
    assert_adam_close(flat_tree(state.params), flat_tree(jstate.params), flat_tree(jp), 1e-2, 4)


def test_published_cells_and_registry():
    """The four GraphSAGE cells field for field, and the registry: ten
    assigned architectures, 40 cells (anchor ``tests/test_models_smoke.py:146``)."""
    jspec, spec = jconfigs.get("graphsage-reddit"), configs.get("graphsage-reddit")
    assert [c.name for c in spec.cells] == CELLS == [c.name for c in jspec.cells]
    for c, jc in zip(spec.cells, jspec.cells):
        assert (c.kind, c.batch, c.seq, c.extra) == (jc.kind, jc.batch, jc.seq, jc.extra)
        mine, ref = spec.make_model(c), jspec.make_model(jc)
        fields = [f.name for f in dataclasses.fields(ref) if f.name != "dtype"]
        assert [getattr(mine, f) for f in fields] == [getattr(ref, f) for f in fields]
    assert configs.ASSIGNED == jconfigs.ASSIGNED and len(configs.ASSIGNED) == 10
    n_cells = sum(len(configs.get(a).cells) for a in configs.ASSIGNED)
    assert n_cells == 40
    for a in configs.ASSIGNED:
        s = configs.get(a)
        assert s.family in ("lm", "gnn", "recsys") and s.family == jconfigs.get(a).family
        assert s.make_model(s.cells[0]) is not None
        assert [c.name for c in s.cells] == [c.name for c in jconfigs.get(a).cells]


def test_graph_embeddings_example_on_the_cpu():
    """``examples/graph_embeddings_torch.py --device cpu`` keeps its
    reference's assertion (fake-words recall > 0.8 against brute force)."""
    path = os.path.join(os.path.dirname(__file__), "..", "examples", "graph_embeddings_torch.py")
    runpy.run_path(path)["main"](["--device", "cpu"])


def test_aggregate_over_edge_slices_equals_one_slice(monkeypatch):
    """The gather-scatter over edge slices (forward and its transposed
    backward) equals one slice of all the edges, and JAX's gradient."""
    jg, g = _graphs(300, 3000)
    src, dst = g.edge_list()
    h = g.feats.clone()
    wgt = torch.from_numpy(np.random.default_rng(8).normal(size=(300, 12)).astype(np.float32))
    outs = []
    for edges in (gnn._EDGE_SLICE, 700):
        monkeypatch.setattr(gnn, "_EDGE_SLICE", edges)
        x = h.clone().requires_grad_()
        out = gnn.mean_aggregate(x, src, dst, 300)
        (grad,) = torch.autograd.grad((out * wgt).sum(), [x])
        outs.append((out.detach(), grad))
    js, jd = jg.edge_list()
    jgrad = jax.grad(lambda x: jnp.sum(jgnn.mean_aggregate(x, js, jd, 300) * wgt.numpy()))(
        jnp.asarray(h.numpy()))
    for out, grad in outs:
        torch.testing.assert_close(out, outs[0][0], rtol=1e-6, atol=1e-6)
        assert_logits_close(grad, jgrad, 1e-5, "gradient of h")
