"""kNN-LM: the paper's ANN layer serving a language model's embeddings
(port of ``examples/knn_lm.py``, on the PyTorch package).

    PYTHONPATH=src python examples/knn_lm_torch.py [--device cuda|cpu] [--steps 200]

Trains a micro LM for a few hundred steps, then uses the FAKE-WORDS index
over the model's (datastore) hidden states to interpolate next-token
probabilities (Khandelwal et al. 2020 style):

    p(y|x) = (1-lam) p_LM(y|x) + lam p_kNN(y|x)

The datastore maps hidden state h_t -> next token y_{t+1}; retrieval is the
paper's technique end to end (encode, match at depth d, exact rerank).  On
the card every part runs there: the LM's attention through K9 (forward
with lse and backward while training), the match through K1 classic.
"""
import argparse

import torch

from repro_torch.core import bruteforce, fakewords
from repro_torch.core.index import _check_device
from repro_torch.core.types import FakeWordsConfig
from repro_torch.data import lm as lm_data
from repro_torch.launch.train import micro_lm_config
from repro_torch.models import transformer as tfm
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.train_loop import build_train_step, make_train_state

LAMBDAS = (0.0, 0.25, 0.5)


def hidden_states(params, tokens, cfg):
    """Last-layer hidden states (B, S, d) (pre-head)."""
    b, s = tokens.shape
    x = tfm._embed(params, tokens, cfg)
    positions = torch.arange(s, device=x.device).expand(b, s)
    for _, layer in tfm.iter_layers(params, cfg):
        x = tfm._dense_layer(x, layer, cfg, positions)
    return tfm.rms_norm(x, params["final_ln"], cfg.norm_eps)


def knn_probs(scores, ids, vals, vocab: int):
    """p_kNN (T, vocab): a softmax over the retrieved scores (times 10),
    scattered onto their stored next tokens ``vals[ids]`` (summed where
    two neighbours store one token)."""
    w = torch.softmax(scores * 10.0, dim=-1)  # (T, k)
    knn_tokens = vals[ids.long()].long()  # (T, k)
    rows = torch.arange(scores.shape[0], device=scores.device)[:, None].expand_as(knn_tokens)
    p = torch.zeros((scores.shape[0], vocab), dtype=w.dtype, device=w.device)
    return p.index_put_((rows, knn_tokens), w, accumulate=True)


def nll(p, labels) -> float:
    """Mean negative log-probability of ``labels`` under the rows of ``p``
    (probabilities floored at 1e-9)."""
    pt = p[torch.arange(labels.shape[0], device=p.device), labels.long()]
    return float(-torch.mean(torch.log(torch.clamp_min(pt, 1e-9))))


def main(argv=None) -> dict:
    """Runs the example; returns {"nll": {lambda: NLL}, "lm_nll": the LM's
    own cross-entropy on the eval batch (``tfm.loss_fn``), "index": the
    fake-words index over the datastore, "q_tf": the eval batch's encoded
    queries}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args(argv)
    dev = _check_device(args.device)

    cfg = micro_lm_config()
    data = lm_data.LmDataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8, seed=0)
    opt = opt_mod.adamw(lr=1e-3)
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    state = make_train_state(params, opt)
    step = build_train_step(lambda p, b: tfm.loss_fn(p, b["tokens"], b["labels"], cfg), opt)

    def batch(i):
        return {k: x.to(dev) for k, x in lm_data.batch_at(data, i).items()}

    print(f"== training micro-LM ({args.steps} steps)")
    for i in range(args.steps):
        state, m = step(state, batch(i))
        if i % 50 == 0:
            print(f"  step {i}: loss {float(m['loss']):.3f}")
    params = state.params

    with torch.no_grad():
        print("== building kNN datastore (hidden state -> next token)")
        keys_list, vals_list = [], []
        for i in range(300, 316):  # held-out batches
            b = batch(i)
            keys_list.append(hidden_states(params, b["tokens"], cfg).reshape(-1, cfg.d_model)
                             .float())
            vals_list.append(b["labels"].reshape(-1))
        keys = torch.cat(keys_list)
        vals = torch.cat(vals_list)
        print(f"  datastore: {keys.shape[0]} entries x {keys.shape[1]}d")

        fw_cfg = FakeWordsConfig(quantization=50)
        index = fakewords.build(keys, fw_cfg)

        print("== kNN-LM eval on a fresh batch")
        b = batch(999)
        h = hidden_states(params, b["tokens"], cfg)
        logits = tfm.forward(params, b["tokens"], cfg)
        q = h.reshape(-1, cfg.d_model)
        q_tf = fakewords.encode_queries(q, fw_cfg)
        # the unit queries in the compute dtype, widened for the rerank as the
        # reference's einsum widens them
        s, ids = fakewords.search(index, q_tf, bruteforce.l2_normalize(q).float(), k=16,
                                  depth=64, rerank=True)
        p_knn = knn_probs(s, ids, vals, cfg.vocab)
        p_lm = torch.softmax(logits.reshape(-1, cfg.vocab), dim=-1)
        labels = b["labels"].reshape(-1)
        out = {}
        for lam in LAMBDAS:
            out[lam] = nll((1 - lam) * p_lm + lam * p_knn, labels)
            print(f"  lambda={lam:.2f}: NLL {out[lam]:.4f}")
        lm_nll = float(tfm.loss_fn(params, b["tokens"], b["labels"], cfg))
    print("(kNN interpolation over the fake-words index; Zipf-synthetic "
          "data so gains are modest — the plumbing is the point)")
    return {"nll": out, "lm_nll": lm_nll, "index": index, "q_tf": q_tf}


if __name__ == "__main__":
    main()
