"""Cached search executables: on the card, captured CUDA graphs.

A search whose shapes are fixed once its static knobs are (the packed
segmented search, the graph traversal) is captured once as a
``torch.cuda.CUDAGraph`` and replayed.  A graph reads the buffers it was
captured over at their addresses, so an entry is keyed on the caller's
knobs, its *owner* (the object whose lifetime bounds those buffers: a packed
view, a graph's adjacency) and the addresses, shapes and dtypes of the
buffers, and it goes when its owner is freed.  On the CPU an entry is the
plain callable under the same key.

Every capture in the package goes through :func:`capture`: one at a time
in the process (:data:`CAPTURE_LOCK`), on a side stream of its own, in
``thread_local`` mode.  A serving worker captures while caller threads go
on with their own device work (an ``IndexWriter.add`` copies rows to the
card); in the default ``global`` mode such a call in another thread is
refused while the capture runs.  Work joins a capture only through the
capturing stream, and the other threads' current streams are their own,
so their work runs as it is issued and none of it is recorded.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

__all__ = ["CAPTURE_LOCK", "ExecutableCache", "capture"]

#: Held for the whole of every capture, its warm-up run included: CUDA
#: graphs allow one capture at a time in a process, whichever thread starts
#: it.
CAPTURE_LOCK = threading.Lock()


def capture(dev: torch.device, warmup: Callable[[], Any],
            body: Callable[[], Any]) -> Tuple["torch.cuda.CUDAGraph", Any]:
    """Under :data:`CAPTURE_LOCK`, on a side stream: ``warmup()`` once for
    real (CUDA graphs require it), then ``body()`` captured in
    ``thread_local`` mode.  Returns the graph and ``body()``'s result (the
    graph's output buffers).  Other threads' device work, on their own
    streams, goes on meanwhile and is not recorded."""
    with CAPTURE_LOCK:
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            warmup()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # entering it synchronizes the device and empties the allocator's cache
        with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
            out = body()
        return graph, out


def _tensors(obj, out: List[Any]) -> List[Any]:
    """Every tensor inside ``obj`` (dataclasses, tuples, lists; None and
    other leaves skipped), in field order."""
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _tensors(getattr(obj, f.name), out)
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            _tensors(x, out)
    return out


def _aval(x: Optional[torch.Tensor]):
    return None if x is None else (tuple(x.shape), x.dtype, x.device)


def _fused_launches() -> Dict[str, int]:
    """The fused top-k wrappers' launch counts (the kernels a cached search
    runs)."""
    from repro_torch.kernels.fused_topk import kernel

    fns = (kernel.fused_topk, kernel.fused_topk_gathered, kernel.fused_topk_quantized,
           kernel.fused_topk_gathered_quantized)
    return {fn.__name__: fn.launches for fn in fns}


class _GraphEntry:
    """One captured CUDA graph of ``fn(*resident, *fed)``: the ``resident``
    tensors are read where they lie (their addresses are in the cache key),
    the ``fed`` ones are copied into static buffers before each replay, and
    the outputs are cloned out of the graph's pool.  ``captured`` counts
    the kernel wrappers' launches recorded into the graph (a replay runs
    them again without moving the wrappers' counters); ``pool_bytes`` is
    the device memory the capture reserved (the graph's private pool).
    Threads share an entry: a call's feed, replay and copy-out are issued
    as one under the entry's lock, so that on one stream no other call's
    inputs land in the static buffers between them."""

    def __init__(self, fn: Callable, resident: Tuple[Any, ...], fed: Tuple[Any, ...]):
        dev = next(x.device for x in _tensors(fed, []))
        self._lock = threading.Lock()
        self.static = tuple(None if x is None else x.clone() for x in fed)
        before = {}

        def body():
            before.update(_fused_launches())
            reserved = torch.cuda.memory_reserved(dev)
            return reserved, fn(*resident, *self.static)

        self.graph, (reserved, self.out) = capture(
            dev, lambda: fn(*resident, *self.static), body)
        after = _fused_launches()
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.captured = {k: after[k] - before[k] for k in after if after[k] != before[k]}

    def __call__(self, resident, fed):
        with self._lock:
            for buf, x in zip(self.static, fed):
                if buf is not None:
                    buf.copy_(x)
            self.graph.replay()
            return tuple(o.clone() for o in self.out)


_GENERATIONS = itertools.count(1)


class ExecutableCache:
    """Bounded LRU of search executables, explicitly keyed.

    On the card an entry is a captured CUDA graph (:class:`_GraphEntry`).
    A graph reads the buffers it was captured over at their addresses, so
    the key is the caller's static knobs, the generation of the ``owner``
    whose buffers it reads (a number for the owner's life, so a later
    object at a freed one's address gets another), and, for every
    ``resident`` tensor, its address, shape and dtype, and for every
    ``fed`` tensor (copied in at each call: the query operands, a mask) its
    shape and dtype.  A hit therefore always reads the current buffers:
    writes into the owner's buffers in place keep its entries valid, a new
    owner is a miss.  When an owner is freed its entries go with it, so no
    graph (with its private memory pool) outlives the buffers it reads.
    ``compiles`` counts builds (captures on the card), ``hits`` reuses,
    ``evictions`` entries dropped past ``capacity``; an owner's death does
    not count as an eviction.  Threads may share the cache: its table is
    read and written under a lock, which a capture does not hold."""

    def __init__(self, capacity: int = 64):
        self.capacity = capacity
        self._lock = threading.RLock()  # re-entrant: an owner may die inside get
        self._entries: "OrderedDict[Any, Any]" = OrderedDict()
        self._gens: Dict[int, int] = {}
        self.hits = 0
        self.compiles = 0
        self.evictions = 0

    def _generation(self, owner) -> int:
        gen = self._gens.get(id(owner))
        if gen is None:
            gen = self._gens[id(owner)] = next(_GENERATIONS)
            weakref.finalize(owner, self._drop, id(owner), gen)
        return gen

    def _drop(self, oid: int, gen: int) -> None:
        with self._lock:
            if self._gens.get(oid) == gen:
                del self._gens[oid]
            for full_key in [fk for fk in self._entries if fk[0] == gen]:
                del self._entries[full_key]

    def get(self, key, owner, build_fn: Callable[[], Callable], resident: Tuple[Any, ...],
            fed: Tuple[Any, ...]):
        """The entry for ``key`` over ``owner``'s buffers and the arguments'
        layout, built from ``build_fn()`` (a function of ``*resident,
        *fed``) on a miss.  Call it as ``entry(resident, fed)``."""
        res = tuple((x.data_ptr(),) + _aval(x) for x in _tensors(resident, []))
        with self._lock:
            full_key = (self._generation(owner), key, res,
                        tuple(_aval(x) if isinstance(x, torch.Tensor) else x for x in fed))
            hit = self._entries.get(full_key)
            if hit is not None:
                self._entries.move_to_end(full_key)
                self.hits += 1
                return hit
        fn = build_fn()
        if any(x.is_cuda for x in _tensors(fed, [])):
            entry = _GraphEntry(fn, resident, fed)
        else:
            def entry(res, fd):
                return fn(*res, *fd)
        with self._lock:
            self.compiles += 1
            self._entries[full_key] = entry
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.evictions += 1
        return entry

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.hits = self.compiles = self.evictions = 0

    def stats(self) -> dict:
        with self._lock:
            pool = sum(getattr(e, "pool_bytes", 0) for e in self._entries.values())
            return {"entries": len(self._entries), "hits": self.hits,
                    "compiles": self.compiles, "evictions": self.evictions,
                    "pool_bytes": pool}
