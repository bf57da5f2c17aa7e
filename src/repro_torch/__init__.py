"""PyTorch + CUDA port of the ``repro`` ANN package, laid out like it.

Entry points take ``device=`` (default ``"cuda"``); a tensor on the CPU runs
the plain PyTorch version of every kernel, a tensor on the card launches the
hand-written kernel or raises.  Nothing here imports JAX or ``repro``.
"""
