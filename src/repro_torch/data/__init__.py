"""Seeded synthetic data: ANN corpora (``embeddings``), LM token batches
(``lm``) and recsys batches (``recsys``) on the host (numpy); graphs
(``graph``: built with numpy, sampled on the device)."""
