"""The port's serving launcher (``python -m repro_torch.launch.serve``) on the
CPU route, against the JAX package's ``repro.launch.serve`` at a small size
(``--n-docs 2048 --dim 64 --queries 64 --batch 16``).

Both launchers draw the same corpus and queries (held bit-equal first), build
every encoding and serve the query stream through their ``AnnService``.
Recall@k is equal, or within 0.01 where the exact rerank's f32 near-ties can
swap ids.  The online modes (``--segments``, ``--qps``), the filtered and
hybrid smokes and ``--save-index`` run once each.  ``--shards 4`` runs
against the JAX launcher in a subprocess with 8 fake host devices, as the
reference's sharded tests run.
"""
import json
import os
import subprocess
import sys

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


def _jax_main(args):
    """``repro.launch.serve.main(args)`` in a subprocess under 8 fake host
    devices (its ``--shards`` needs that many); its result dict."""
    code = ("import os, json, sys\n"
            "os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=8'\n"
            "os.environ['JAX_PLATFORMS'] = 'cpu'\n"
            "from repro.launch import serve\n"
            "print('RESULT ' + json.dumps(serve.main(json.loads(sys.argv[1]))))\n")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    r = subprocess.run([sys.executable, "-c", code, json.dumps(args)], capture_output=True,
                       text=True, timeout=600, env=dict(os.environ, PYTHONPATH=src))
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr[-3000:]}"
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


@pytest.mark.parametrize("method", ["fakewords", "lsh"])
def test_shards_match_the_reference(method, capsys):
    """``--shards 4``: the sharded build and fan-out serving give the JAX
    launcher's recall (within 0.01 where f32 near-ties swap) and the
    monolithic index's bytes; the placement is printed."""
    args = SMALL + ["--shards", "4", "--method", method]
    out = serve.main(args + CPU)
    assert "[serve] mesh: 4 shards over 1 device(s) (cpu x4)" in capsys.readouterr().out
    want = _jax_main(args)
    assert out["method"] == want["method"] and out["queries"] == want["queries"] == 80
    assert abs(out["recall@k"] - want["recall@k"]) <= RECALL_SLACK
    assert out["index_mb"] == want["index_mb"] == serve.main(
        SMALL + CPU + ["--method", method])["index_mb"]


def test_shards_refuses_hnsw_and_segments():
    with pytest.raises(SystemExit, match="adjacency edges cross shard"):
        serve.main(SMALL + CPU + ["--shards", "4", "--method", "hnsw"])
    with pytest.raises(SystemExit, match="mutually exclusive"):
        serve.main(SMALL + CPU + ["--shards", "4", "--segments", "2"])
