"""Models: the decoder-only transformer LM (``transformer``)."""
