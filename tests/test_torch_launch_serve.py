"""The port's serving launcher (``python -m repro_torch.launch.serve``) on the
CPU route, against the JAX package's ``repro.launch.serve`` at a small size
(``--n-docs 2048 --dim 64 --queries 64 --batch 16``).

Both launchers draw the same corpus and queries (held bit-equal first), build
every encoding and serve the query stream through their ``AnnService``.
Recall@k is equal, or within 0.01 where the exact rerank's f32 near-ties can
swap ids.  The online modes (``--segments``, ``--qps``), the filtered and
hybrid smokes and ``--save-index`` run once each.
"""
import numpy as np
import pytest

from repro.data import embeddings as jembeddings
from repro.launch import serve as jserve
from repro_torch.data import embeddings
from repro_torch.launch import serve

SMALL = ["--n-docs", "2048", "--dim", "64", "--queries", "64", "--batch", "16"]
CPU = ["--device", "cpu"]
RECALL_SLACK = 0.01


def test_corpora_are_bit_equal():
    cfg = embeddings.CorpusConfig(n_vectors=2048, dim=64)
    jcfg = jembeddings.CorpusConfig(n_vectors=2048, dim=64)
    x, jx = embeddings.make_corpus(cfg), jembeddings.make_corpus(jcfg)
    np.testing.assert_array_equal(x, jx)
    for a, b in zip(embeddings.make_queries(x, 64), jembeddings.make_queries(jx, 64)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("method", ["fakewords", "lsh", "kdtree", "bruteforce", "hnsw"])
def test_recall_matches_the_reference(method):
    out = serve.main(SMALL + CPU + ["--method", method])
    want = jserve.main(SMALL + ["--method", method])
    assert out["method"] == want["method"] and out["queries"] == want["queries"] == 80
    assert abs(out["recall@k"] - want["recall@k"]) <= RECALL_SLACK
    assert out["p50_ms_per_batch"] > 0 and out["index_mb"] == want["index_mb"]


def test_segments_nrt():
    out = serve.main(SMALL + CPU + ["--segments", "4"])
    want = jserve.main(SMALL + ["--segments", "4"])
    assert out["segments_before_merge"] == want["segments_before_merge"] == 4
    assert out["live_docs"] == want["live_docs"] == 2048 - 2048 // 10
    assert abs(out["recall@k"] - want["recall@k"]) <= RECALL_SLACK
    assert out["cache"] == want["cache"]


def test_filtered_smoke():
    out = serve.main(SMALL + CPU + ["--filter-ratio"])
    want = jserve.main(SMALL + ["--filter-ratio"])
    assert [r["selectivity"] for r in out["filtered"]] == [0.01, 0.1, 0.5]
    for got, ref in zip(out["filtered"], want["filtered"]):
        assert abs(got["recall@k"] - ref["recall@k"]) <= RECALL_SLACK


def test_hybrid_smoke():
    out = serve.main(SMALL + CPU + ["--hybrid"])["hybrid"]
    want = jserve.main(SMALL + ["--hybrid"])["hybrid"]
    for name in ("classic", "dense", "hybrid_rrf"):
        assert abs(out[name] - want[name]) <= RECALL_SLACK


def test_save_index_round_trip(tmp_path):
    """Serving the loaded copy gives the built index's recall."""
    path = str(tmp_path / "idx.ann")
    out = serve.main(SMALL + CPU + ["--method", "lsh", "--save-index", path])
    want = serve.main(SMALL + CPU + ["--method", "lsh"])
    for key in ("method", "recall@k", "index_mb", "queries"):
        assert out[key] == want[key]


def test_openloop_resolves_every_request():
    """2 s at 200 QPS with an NRT mutation every 100 requests: every
    admitted request resolves, and sent + shed is the schedule's count
    (late arrivals are submitted late, never dropped)."""
    qps, duration = 200, 2.0
    out = serve.main(SMALL + CPU + ["--qps", str(qps), "--duration", str(duration),
                                    "--mutate-every", "100"])
    assert out["sent"] + out["shed"] == qps * duration
    assert out["max_lag_ms"] >= 0
    assert out["sustained_qps"] > 0 and out["async_launches"] >= 1
    assert out["req_p99_ms"] >= out["req_p50_ms"] > 0
    cycles = out["sent"] // 100  # each adds 32 rows and deletes at most 4
    assert int(2048 * 0.9) - 4 * cycles <= out["live_docs"] <= 2048


def test_device_defaults_to_the_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(SMALL)
