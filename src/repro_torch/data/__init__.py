"""Seeded synthetic data (numpy, host side): ANN corpora (``embeddings``)
and LM token batches (``lm``)."""
