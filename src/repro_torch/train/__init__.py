"""Training: optimizers, the train step, checkpoints (port of
``repro/train/``: ``optimizer``, ``train_loop``, ``checkpoint``)."""
