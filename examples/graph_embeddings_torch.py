"""GraphSAGE node embeddings -> fake-words ANN, on the PyTorch port.

    PYTHONPATH=src python examples/graph_embeddings_torch.py [--device cuda|cpu]

The port's counterpart of ``examples/graph_embeddings.py``: trains 2-layer
mean-SAGE on a synthetic power-law graph (full-batch, AdamW through
``build_train_step``), then indexes the trained node embeddings with the
paper's fake-words encoding and checks neighbor retrieval against brute
force (the match on K1 classic, the ground truth on K1 f32 on the card;
``--device cpu`` runs their plain versions).
"""
import argparse

import torch

from repro_torch.core import bruteforce, fakewords
from repro_torch.core import eval as ev
from repro_torch.core.types import FakeWordsConfig
from repro_torch.data import graph as gd
from repro_torch.models import gnn
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.train_loop import build_train_step, make_train_state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args(argv).device
    g = gd.make_graph(gd.GraphConfig(n_nodes=3000, n_edges=15000, d_feat=64, n_classes=10),
                      device=dev)
    src, dst = g.edge_list()
    cfg = gnn.SageConfig(n_layers=2, d_in=64, d_hidden=64, n_classes=10, fanouts=(25, 10))
    params = gnn.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    opt = opt_mod.adamw(lr=1e-2)
    state = make_train_state(params, opt)
    mask = torch.ones((g.n_nodes,), dtype=torch.float32, device=dev)

    def loss_of(p, batch):
        return gnn.loss_full(p, g.feats, src, dst, g.labels, mask, cfg)

    step = build_train_step(loss_of, opt)
    print(f"== training GraphSAGE (100 full-batch steps) on {dev}")
    for i in range(100):
        state, m = step(state, {})
        if i % 25 == 0:
            print(f"  step {i}: xent {float(m['loss']):.4f}")

    with torch.no_grad():
        emb = gnn.embeddings_full(state.params, g.feats, src, dst, cfg)
    print(f"== node embeddings: {tuple(emb.shape)}")
    queries = emb[:64]
    _, gt = bruteforce.exact_topk(emb, queries, 10)
    fw = FakeWordsConfig(quantization=50)
    idx = fakewords.build(emb, fw)
    q_tf = fakewords.encode_queries(queries, fw)
    _, ids = fakewords.search(
        idx, q_tf, bruteforce.l2_normalize(queries), k=10, depth=100, rerank=True)
    r = float(ev.recall_at(gt, ids))
    print(f"== fake-words neighbor recall vs brute force: {r:.3f}")
    assert r > 0.8


if __name__ == "__main__":
    main()
