"""Training: optimizers, the train step, checkpoints, gradient compression
and GPipe (port of ``repro/train/``: ``optimizer``, ``train_loop``,
``checkpoint``, ``compression``, ``pipeline``)."""
