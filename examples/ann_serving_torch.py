"""ANN serving end to end on the PyTorch port: index build -> batched
query service -> metrics.

    PYTHONPATH=src python examples/ann_serving_torch.py [--device cuda|cpu]

The port's counterpart of ``examples/ann_serving.py``: a thin wrapper over
``repro_torch.launch.serve`` (the serving driver) with a smaller default
corpus.  The service runs the same staged search pipeline as offline
search and serves any ``AnnIndex`` (``--method`` in the driver picks lsh /
kdtree / bruteforce / hnsw).  ``stats()`` reports the service's own p50 /
p99 batch latency.  Runs on the card by default.
"""
import argparse

from repro_torch.launch import serve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--docs", type=int, default=50_000)
    args = ap.parse_args(argv)
    out = serve.main(["--n-docs", str(args.docs), "--queries", "256", "--batch", "64",
                      "--q", "50", "--device", args.device])
    assert out["recall@k"] > 0.9  # depth-100 + rerank
    assert out["p50_ms_per_batch"] is not None  # the latency ring buffer filled


if __name__ == "__main__":
    main()
