"""AnnIndex facade (port of ``repro/core/index.py``):

    idx = AnnIndex.build(vectors, FakeWordsConfig(quantization=50))  # on "cuda"
    scores, ids = idx.search(queries, k=10, depth=100, rerank=True)

``blockmax_keep`` (with ``blockmax_block_size``) turns on two-stage blockmax
pruning for fake-words and LSH indexes: only the ``blockmax_keep`` blocks
with the best upper bounds are scored (:mod:`repro_torch.core.blockmax`).

:func:`index_from_numpy` takes the arrays and dtypes that the reference's
``AnnIndex.save`` writes (``index.npz`` + ``config.json``), so an index the
JAX package built searches identically here.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import builder
from repro_torch.core import pipeline as pl
from repro_torch.core.blockmax import BlockMaxIndex, build_blockmax
from repro_torch.core.types import (
    BruteForceConfig,
    FakeWordsConfig,
    FakeWordsIndex,
    FlatIndex,
    LexicalLshConfig,
    LshIndex,
    SearchParams,
)

AnyConfig = Union[FakeWordsConfig, LexicalLshConfig, BruteForceConfig]
AnyIndex = Union[FakeWordsIndex, LshIndex, FlatIndex]

_METHOD_BY_INDEX = {FakeWordsIndex: "fake-words", LshIndex: "lexical-lsh",
                    FlatIndex: "bruteforce"}


def _check_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device is available")
    return dev


@dataclasses.dataclass
class AnnIndex:
    """One retrieval architecture for the ported encodings: owns the method
    config, the index container and its staged search pipeline.
    ``blockmax_keep`` / ``blockmax_block_size`` switch on blockmax pruning
    (fake-words and LSH indexes); ``bm`` is built from the index when not
    given."""

    config: AnyConfig
    index: AnyIndex
    blockmax_keep: Optional[int] = None
    blockmax_block_size: int = 256
    bm: Optional[BlockMaxIndex] = None

    def __post_init__(self):
        self.pipeline: pl.SearchPipeline = pl.build_pipeline(self.config)
        if self.blockmax_keep is None:
            return
        if self.bm is None:
            if not isinstance(self.index, (FakeWordsIndex, LshIndex)):
                raise ValueError(f"blockmax pruning is not supported for {self.method}")
            self.bm = build_blockmax(self.index, self.blockmax_block_size)
        self.pipeline = dataclasses.replace(
            self.pipeline, matcher=pl.BlockMaxMatcher(self.blockmax_keep, self.bm))

    @classmethod
    def build(
        cls,
        vectors,
        config: AnyConfig,
        keep_vectors: bool = True,
        blockmax_keep: Optional[int] = None,
        blockmax_block_size: int = 256,
        device="cuda",
    ) -> "AnnIndex":
        """Build through :class:`repro_torch.core.builder.BuildPipeline` on
        ``device``.  ``vectors``: (N, dim) numpy array or tensor (moved to
        ``device``); ``keep_vectors`` keeps the fp32 originals for rerank.
        Raises when ``device`` is a CUDA device and none is available."""
        dev = _check_device(device)
        v = torch.as_tensor(vectors, device=dev)
        bp = builder.make_build_pipeline(config, "exact" if keep_vectors else "none")
        return cls(config=config, index=bp.build_local(v), blockmax_keep=blockmax_keep,
                   blockmax_block_size=blockmax_block_size)

    @property
    def method(self) -> str:
        return _METHOD_BY_INDEX[type(self.index)]

    @property
    def device(self) -> torch.device:
        return self.index.device

    @property
    def num_docs(self) -> int:
        return self.index.num_docs

    def nbytes(self) -> int:
        return self.index.nbytes()

    def search(
        self,
        queries,
        k: int = 10,
        depth: int = 100,
        rerank: bool = False,
        params: Optional[SearchParams] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """encode -> match [-> prune] -> optional rerank.  ``params`` takes
        precedence over ``k`` / ``depth`` / ``rerank``.  ``queries`` (B, dim)
        numpy or tensor; it is moved to the index's device."""
        p = params if params is not None else SearchParams(k=k, depth=depth, rerank=rerank)
        q = torch.as_tensor(queries, device=self.device)
        return self.pipeline.search(self.index, q, p)


def _tensor(a: np.ndarray, dtype_name: str, device: torch.device) -> torch.Tensor:
    """npz array -> tensor; bfloat16 arrives as a uint16 view."""
    if dtype_name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16).to(device)
    if a.dtype.name != dtype_name:
        raise ValueError(f"array dtype {a.dtype.name} does not match the recorded {dtype_name}")
    return torch.from_numpy(np.array(a)).to(device)


def index_from_numpy(
    method: str,
    config: dict,
    arrays: Dict[str, np.ndarray],
    dtypes: Dict[str, str],
    device="cuda",
    blockmax_keep: Optional[int] = None,
    blockmax_block_size: int = 256,
) -> AnnIndex:
    """The port's index from the reference's persisted form: ``method`` and
    ``config`` as in ``config.json``, ``arrays`` the ``index.npz`` members
    (dotted names), ``dtypes`` their recorded dtype names, and the blockmax
    knobs as ``config.json`` records them (the block bounds are rebuilt
    from the arrays, as the reference's ``load`` does).  Covers
    "fake-words", "lexical-lsh" and "bruteforce"."""
    dev = _check_device(device)
    unported = sorted(n for n in arrays if n.startswith(("vq.", "pq.", "metadata.")))
    if unported:
        raise NotImplementedError(
            f"arrays {unported} belong to stores not ported yet "
            "(ROADMAP.md, queue A: quantized read path, filtering)")
    t = {name: _tensor(a, dtypes[name], dev) for name, a in arrays.items()}
    if method == "fake-words":
        cfg = FakeWordsConfig(**config)
        index = FakeWordsIndex(
            tf=t["tf"], idf=t["idf"], norm=t["norm"], df=t["df"],
            scored=t.get("scored"), vectors=t.get("vectors"))
    elif method == "lexical-lsh":
        cfg = LexicalLshConfig(**config)
        index = LshIndex(sig=t["sig"], vectors=t.get("vectors"))
    elif method == "bruteforce":
        cfg = BruteForceConfig(**config)
        index = FlatIndex(vectors=t["vectors"])
    else:
        raise NotImplementedError(f"method {method!r} is not ported yet (ROADMAP.md, queue A)")
    return AnnIndex(config=cfg, index=index, blockmax_keep=blockmax_keep,
                    blockmax_block_size=blockmax_block_size)
