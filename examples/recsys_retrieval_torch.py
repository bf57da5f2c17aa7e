"""RecSys retrieval through the paper's index — the retrieval_cand cell, on
the PyTorch port.

    PYTHONPATH=src python examples/recsys_retrieval_torch.py [--device cuda|cpu]

The port's counterpart of ``examples/recsys_retrieval.py``: trains a small
FM on synthetic CTR data (AdamW through ``build_train_step``), takes one
field's item-embedding table as the candidate corpus (the "arbitrary dense
vectors"), and compares brute-force scoring (the serving baseline, K1 f32
on the card) with fake-words index scoring + exact rerank (the paper's
technique, K1 classic on the card); ``--device cpu`` runs the kernels'
plain versions.
"""
import argparse

import torch

from repro_torch.core import bruteforce, fakewords
from repro_torch.core import eval as ev
from repro_torch.core.types import FakeWordsConfig
from repro_torch.data import recsys as rec_data
from repro_torch.models import recsys as rec
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.train_loop import build_train_step, make_train_state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args(argv).device
    table = rec.TableSpec(rec.criteo_row_counts(8, 65536), 16)
    cfg = rec.RecsysConfig(name="fm-small", model="fm", table=table)
    data = rec_data.RecsysDataConfig(table=table, batch=256, seed=0)
    params = rec.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    opt = opt_mod.adamw(lr=1e-2)
    state = make_train_state(params, opt)
    step = build_train_step(lambda p, b: rec.bce_loss(p, cfg, b["sparse"], b["label"]), opt)
    print(f"== training FM (200 steps, synthetic CTR) on {dev}")
    for i in range(200):
        state, m = step(state, rec_data.batch_at(data, i, device=dev))
        if i % 50 == 0:
            print(f"  step {i}: bce {float(m['loss']):.4f}")
    params = state.params

    # Candidate corpus: the largest field's item embeddings.
    f0_rows = table.row_counts[0]
    items = params["table"][:f0_rows].detach()  # field 0 occupies rows [0, c0)
    print(f"== candidate corpus: {f0_rows} item embeddings (dim {cfg.dim})")

    # Query side: user context vectors from held-out batches.
    b = rec_data.batch_at(data, 10_000, device=dev)
    with torch.no_grad():
        users = rec.user_tower(params, cfg, b["sparse"])[:64]

    # Baseline: brute-force top-10 by inner product.
    _, gt_i = bruteforce.exact_topk(items, users, 10)

    # Paper technique: fake-words index + depth-100 match + exact rerank.
    fw = FakeWordsConfig(quantization=50)
    idx = fakewords.build(items, fw)
    q_tf = fakewords.encode_queries(users, fw)
    _, ids = fakewords.search(
        idx, q_tf, bruteforce.l2_normalize(users), k=10, depth=100, rerank=True)
    r = float(ev.recall_at(gt_i, ids))
    print(f"== fake-words retrieval R@(10,100)+rerank vs brute force: {r:.3f}")
    print(f"   index {idx.nbytes() / 1e6:.1f} MB vs raw vectors "
          f"{items.numel() * 4 / 1e6:.1f} MB")
    # NOTE: cosine vs inner-product — fake words requires unit vectors, so
    # recall is w.r.t. cosine neighbors; FM scores are inner products.  For
    # norm-skewed tables add the classic norm-augmentation dimension.
    assert r > 0.6


if __name__ == "__main__":
    main()
