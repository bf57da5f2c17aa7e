"""LM serving engine: continuous-batching decode over a shared KV cache
(port of ``repro/serve/engine.py``).

A fixed pool of B slots; each slot holds one in-flight request.  Per step:

  1. admit queued requests into free slots (a prefill writes the request's
     KV into the slot's cache region and emits its first token);
  2. one batched decode advances every active slot by a token, each at its
     own length; inactive slots decode at their length and write nothing;
  3. slots that emit EOS (or reach ``max_len`` or ``max_new_tokens``)
     retire and free up.

Device work is the prefill (:func:`repro_torch.models.transformer.prefill`,
K9 in every layer) and the batched decode (plain torch), eager: no CUDA
graph yet.  Admission and retirement are host-side bookkeeping.  The cache
layout (L, B, T_max, Hkv, dh) is the model's.

As in the reference, the batched decode's MoE layers add no shared expert
(the model's own ``decode_step`` and ``prefill`` do).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.index import _check_device
from repro_torch.kernels.common import f32_matmul
from repro_torch.models import transformer as tfm

Params = Dict[str, Any]


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray          # (plen,) int32
    max_new_tokens: int = 32
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class EngineConfig:
    batch_slots: int = 8
    max_len: int = 512
    eos_id: int = 1
    greedy: bool = True


class DecodeEngine:
    """Host-side continuous batcher around the prefill and the batched
    decode, on ``device`` (the parameters must lie there)."""

    def __init__(self, params: Params, cfg: tfm.TransformerConfig, ecfg: EngineConfig,
                 device="cuda"):
        self.device = _check_device(device)
        tfm.tree_map(self._on_device, params)
        self.params = params
        self.cfg = cfg
        self.ecfg = ecfg
        b, t = ecfg.batch_slots, ecfg.max_len
        self.cache = tfm.make_cache(cfg, b, t, device=self.device)
        # Per-slot decode positions (the engine's cache['length'] is per slot).
        self.cache["length"] = torch.zeros(b, dtype=torch.int64, device=self.device)
        self.slot_req: List[Optional[Request]] = [None] * b
        self.queue: List[Request] = []
        self._retired: List[Request] = []
        self.steps = 0

    def _on_device(self, name: str, x: torch.Tensor) -> None:
        if x.device.type != self.device.type or (
                self.device.index is not None and x.device != self.device):
            raise ValueError(f"parameter {name} lies on {x.device}, the engine on {self.device}")

    # -- device work -------------------------------------------------------

    def _prefill(self, prompt: np.ndarray, slot: int) -> int:
        """Prefill one request into cache slot ``slot``; returns its first
        token (argmax of the last position's logits: the first maximum)."""
        tokens = torch.as_tensor(np.asarray(prompt), dtype=torch.int64, device=self.device)
        c, logits = tfm.prefill(self.params, tokens[None, :], self.cfg)
        plen = tokens.shape[0]
        self.cache["k"][:, slot, :plen] = c["k"][:, 0]
        self.cache["v"][:, slot, :plen] = c["v"][:, 0]
        self.cache["length"][slot] = plen
        # Autoregressive decode needs the token on the host: one sync an admit.
        return int(torch.argmax(logits[0]))

    @torch.no_grad()
    def _decode(self, tokens: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        """Batched decode with per-slot lengths.  tokens: (B,), active: (B,)
        bool.  An active slot writes its token's K and V at its length and
        attends to positions <= length; inactive slots compute and write
        nothing.  Returns the next tokens (B,)."""
        cfg = self.cfg
        b, dh = tokens.shape[0], cfg.dh
        lengths = self.cache["length"]
        x = tfm._embed(self.params, tokens, cfg)[:, None, :]
        positions = lengths[:, None]
        rows = torch.nonzero(active)[:, 0]
        at = lengths[rows]
        pos = torch.arange(self.ecfg.max_len, device=self.device)
        mask = (pos[None, :] <= lengths[:, None])[:, None, None, :]  # (B, 1, 1, T)
        for i, (is_moe, layer) in enumerate(tfm.iter_layers(self.params, cfg)):
            k_cache, v_cache = self.cache["k"][i], self.cache["v"][i]
            q, k, v = tfm.qkv(tfm.rms_norm(x, layer["ln1"], cfg.norm_eps), layer, cfg, positions)
            k_cache[rows, at] = k[rows, 0]
            v_cache[rows, at] = v[rows, 0]
            _, logits = tfm._grouped(q, k_cache)
            probs = torch.softmax(torch.where(mask, logits, tfm._NEG), dim=-1)
            attn = f32_matmul(probs.to(v_cache.dtype), v_cache.permute(0, 2, 1, 3))
            x = x + attn.to(v_cache.dtype).reshape(b, 1, cfg.n_heads * dh) @ layer["wo"].to(
                x.dtype)
            h = tfm.rms_norm(x, layer["ln2"], cfg.norm_eps)
            x = x + (tfm.moe_ffn(h, layer, cfg, dropless=True) if is_moe
                     else tfm.swiglu(h, layer))
        logits = tfm._head(self.params, x[:, 0], cfg)
        self.cache["length"] = torch.where(active, lengths + 1, lengths)
        return torch.argmax(logits, dim=-1)

    # -- host-side batching ------------------------------------------------

    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        for slot in range(self.ecfg.batch_slots):
            if self.slot_req[slot] is None and self.queue:
                req = self.queue.pop(0)
                req.out_tokens.append(self._prefill(req.prompt, slot))
                self.slot_req[slot] = req

    def step(self) -> int:
        """One engine tick; returns the number of active slots."""
        self._admit()
        active_mask = np.array([r is not None for r in self.slot_req])
        if not active_mask.any():
            return 0
        toks = np.zeros(self.ecfg.batch_slots, np.int64)
        for i, r in enumerate(self.slot_req):
            if r is not None:
                toks[i] = r.out_tokens[-1]
        next_tok = self._decode(torch.from_numpy(toks).to(self.device),
                                torch.from_numpy(active_mask).to(self.device))
        # The sampled token is the next step's input and gates retirement:
        # one sync a step.
        next_np = next_tok.cpu().numpy()
        for i, r in enumerate(self.slot_req):
            if r is None:
                continue
            tok = int(next_np[i])
            r.out_tokens.append(tok)
            done = tok == self.ecfg.eos_id or len(r.out_tokens) >= r.max_new_tokens
            if done or len(r.prompt) + len(r.out_tokens) >= self.ecfg.max_len:
                r.done = True
                self._retired.append(r)
                self.slot_req[i] = None  # retire; the slot is free again
                self.cache["length"][i] = 0  # a new request starts clean
        self.steps += 1
        return int(active_mask.sum())

    def run(self, max_steps: int = 10_000) -> List[Request]:
        """Drive the engine until the queue and slots drain, or ``max_steps``
        ticks taken within this call (``self.steps`` counts across calls);
        returns the requests retired since the last ``run``, those retired
        by direct ``step`` calls in between included (each returned once)."""
        done: List[Request] = list(self._retired)
        self._retired.clear()
        taken = 0
        while (self.queue or any(self.slot_req)) and taken < max_steps:
            self.step()
            taken += 1
            done.extend(self._retired)
            self._retired.clear()
        return done
