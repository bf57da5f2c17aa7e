"""Helpers shared by the ``test_torch_*`` files: moving arrays from JAX /
numpy to torch, holding top-k results against each other, and emulating
on the CPU the split-TF32 arithmetic of K4 (an f32 query over int8 or int4
rows) and of K1 f32 (over raw f32 rows), K2's selection (splits, a stale
count threshold, a buffer merged by counting), the fused top-k kernels'
pass 2 (the threshold rule and tree merge), and K9's attention and its
bf16 backward."""
import dataclasses
from typing import Optional, Tuple

import numpy as np
import pytest
import torch

from repro_torch.kernels.fused_topk import ref as fused_ref

# The suite runs several pytest workers on one host, each with JAX's own
# thread pool; torch's default intra-op pool (one thread per core) in every
# worker would oversubscribe the cores.  The port's CPU tests are small.
torch.set_num_threads(1)


def to_torch(a) -> torch.Tensor:
    """numpy or JAX array -> CPU tensor (a copy); bfloat16 through its bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def assert_topk_match(got, want, exact: bool, rtol: float = 1e-5, atol: float = 1e-5):
    """Hold (scores, ids) ``got`` against ``want``.  ``want`` may carry one
    rank more than ``got`` so that the last rank's gap is known.  Exact:
    bit-equal.  Else scores within rtol/atol, and ids equal at every rank
    whose wanted score differs from both neighbours by more than that
    tolerance (elsewhere a summation-order difference may swap a near-tie)."""
    gs, gi = (np.asarray(x) for x in got)
    ws, wi = (np.asarray(x) for x in want)
    d = gs.shape[1]
    if exact:
        np.testing.assert_array_equal(gs, ws[:, :d])
        np.testing.assert_array_equal(gi, wi[:, :d])
        return
    np.testing.assert_allclose(gs, ws[:, :d], rtol=rtol, atol=atol)
    with np.errstate(invalid="ignore"):
        big = np.abs(np.diff(ws, axis=1)) > atol + rtol * np.abs(ws[:, 1:])
    pad = np.ones_like(big[:, :1])
    lone = (np.concatenate([pad, big], 1) & np.concatenate([big, pad], 1))[:, :d]
    lone |= ~np.isfinite(ws[:, :d])
    np.testing.assert_array_equal(gi[lone], wi[:, :d][lone])


def assert_rows_close(got, want, tol: float) -> None:
    """Hold dense float output ``got`` against ``want`` (tensors, numpy or
    JAX arrays) row by row (the last dimension: a query's scores, or one
    attention output row), so that a row of small values is held to its own
    scale and not to the largest value in the whole output: each element
    within rtol = ``tol`` and atol = ``tol`` times the row's largest |want|,
    and the row's error norm within ``tol / 2`` of its norm."""
    g, w = (x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32) for x in (got, want))
    assert g.shape == w.shape, (g.shape, w.shape)
    if not w.size:
        return
    with np.errstate(invalid="ignore"):
        diff = np.abs(g - w)
        excess = diff - tol * (np.abs(w) + np.abs(w).max(axis=-1, keepdims=True))
        bad = ~(excess <= 0)  # NaN on either side counts as bad
        rows = np.linalg.norm(diff, axis=-1) - tol / 2 * np.linalg.norm(w, axis=-1)
        bad_rows = ~(rows <= 0)
    assert not bad.any(), (f"{int(bad.sum())} of {bad.size} elements past rtol = atol = {tol} "
                           f"of their row's scale, worst by {np.nanmax(excess)}; first at "
                           f"{np.argwhere(bad)[0].tolist()}")
    assert not bad_rows.any(), (f"{int(bad_rows.sum())} of {bad_rows.size} rows' error norms "
                                f"past {tol / 2} of their norms, worst by {np.nanmax(rows)}")


def cut_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 values cut to tf32 (10 fraction bits, rounded toward zero): the
    13 low bits cleared, as the kernel's split does."""
    bits = x.float().contiguous().view(torch.int32)
    return (bits & -0x2000).view(torch.float32)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to tf32 (10 fraction bits, to nearest, ties away
    from zero): 0x1000 added to the bits (the sign is apart, so this rounds
    the magnitude) and the 13 low bits cleared, as K9's f32 backward's
    split does (``cvt.rna.tf32.f32``'s rounding)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32_topk(q: torch.Tensor, docs: torch.Tensor, scale: torch.Tensor, depth: int,
                    filt: Optional[torch.Tensor] = None, n_docs: Optional[int] = None,
                    lo: bool = True, group: int = 0,
                    first_group: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's split-TF32 arithmetic for an f32 query, emulated in torch: q split
    into hi = cut_tf32(q) and lo = cut_tf32(q - hi).  Over int8 rows (N, T)
    with per-row scales (N, 1) (``group`` 0): each value widened exactly,
    each part's products summed in f32, and the sum times the row's scale
    once.  Over packed int4 rows (N, Tg / 2) with group scales (N, Tg /
    group): each nibble widened exactly to nibble - 8, each part's products
    summed in f32 per 32-column chunk, and each chunk's sum times the row's
    scale for its group plus the row's sum, rounded once to f32 as the
    kernel's fmaf rounds it (the float64 sum is rounded to f32; it could
    differ from fmaf only by a double rounding in a halfway case)
    (``first_group``: the first group's scale for every chunk, a planted
    fault).  Then the top ``depth``
    in descending order, ties to the lowest id, masked or missing slots (-inf,
    -1).  ``lo=False`` keeps the hi part alone (one tf32 pass)."""
    hi = cut_tf32(q)
    parts = [hi, cut_tf32(q - hi)] if lo else [hi]
    if group == 0:
        d = docs.float()
        s = parts[0] @ d.T
        for p in parts[1:]:
            s = s + p @ d.T
        s = s * scale.T
    else:
        t = q.shape[1]
        nib = torch.stack([docs & 15, docs >> 4], -1).reshape(docs.shape[0], -1)
        d = nib[:, :t].float() - 8
        s = torch.zeros((q.shape[0], docs.shape[0]))
        for c0 in range(0, t, 32):
            part = parts[0][:, c0:c0 + 32] @ d[:, c0:c0 + 32].T
            for p in parts[1:]:
                part = part + p[:, c0:c0 + 32] @ d[:, c0:c0 + 32].T
            sc = scale[:, 0 if first_group else c0 // group].double()
            s = (part.double() * sc + s.double()).float()
    keep = torch.ones_like(s, dtype=torch.bool)
    if n_docs is not None:
        keep[:, n_docs:] = False
    if filt is not None:
        keep &= filt.bool().expand_as(keep)
    s, i = torch.sort(torch.where(keep, s, -torch.inf), dim=1, descending=True, stable=True)
    s, i = s[:, :depth], i[:, :depth].to(torch.int32)
    return s, torch.where(s == -torch.inf, torch.full_like(i, -1), i)


def split_tf32x3_scores(q: torch.Tensor, docs: torch.Tensor, doc_lo: bool = True,
                        chunk: int = 32) -> torch.Tensor:
    """K1 f32's split-TF32 arithmetic over raw f32 rows, emulated in torch:
    q and every doc row split by bit masks into hi = cut_tf32(x) and lo =
    cut_tf32(x - hi); per ``chunk``-column chunk the three products doc lo x
    q hi, doc hi x q lo and doc hi x q hi summed in f32 from zero, in that
    order, and each chunk's sum added to the row's f32 sum (the kernel's
    fold).  ``doc_lo=False`` drops doc lo x q hi (the planted fault: the
    doc cut to tf32).  Returns the (B, N) f32 scores."""
    q, docs = q.float(), docs.float()
    q_hi, d_hi = cut_tf32(q), cut_tf32(docs)
    q_lo, d_lo = cut_tf32(q - q_hi), cut_tf32(docs - d_hi)
    s = torch.zeros((q.shape[0], docs.shape[0]))
    for c0 in range(0, q.shape[1], chunk):
        c = slice(c0, c0 + chunk)
        part = torch.zeros_like(s)
        if doc_lo:
            part = part + q_hi[:, c] @ d_lo[:, c].T
        part = part + q_lo[:, c] @ d_hi[:, c].T
        s = s + (part + q_hi[:, c] @ d_hi[:, c].T)
    return s


def sorted_topk(s: torch.Tensor, depth: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top ``depth`` of scores (B, N): descending, ties to the lowest id."""
    s, i = torch.sort(s, dim=1, descending=True, stable=True)
    return s[:, :depth], i[:, :depth].to(torch.int32)


def _precedes(a_s, a_i, b_s, b_i):
    """(a_s, a_i) comes before (b_s, b_i) in the output order: score desc,
    id asc (broadcasting)."""
    return (a_s > b_s) | ((a_s == b_s) & (a_i < b_i))


def merge_counted(ls: torch.Tensor, li: torch.Tensor, cs: torch.Tensor, ci: torch.Tensor,
                  width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The counting merge of the kernels' pass 1 (``merge_buffer``): the
    sorted list (ls, li) and the unsorted candidates (cs, ci) into one
    sorted list of at most ``width`` entries without sorting: a list
    entry's slot is its index plus the candidates before it, a candidate's
    the list entries and the candidates before it; slots >= width drop.
    Raises if two entries share a slot."""
    slot_l = torch.arange(len(ls)) + _precedes(cs[None, :], ci[None, :], ls[:, None],
                                               li[:, None]).sum(1)
    slot_c = (_precedes(ls[None, :], li[None, :], cs[:, None], ci[:, None]).sum(1)
              + _precedes(cs[None, :], ci[None, :], cs[:, None], ci[:, None]).sum(1))
    slots = torch.cat([slot_l, slot_c])
    if len(torch.unique(slots)) != len(slots):
        raise AssertionError("two entries share a slot")
    keep = slots < width
    n = int(keep.sum())
    out_s, out_i = torch.empty(n), torch.empty(n, dtype=torch.long)
    out_s[slots[keep]] = torch.cat([ls, cs])[keep]
    out_i[slots[keep]] = torch.cat([li, ci])[keep]
    return out_s, out_i


def lsh_split_topk(q: torch.Tensor, docs: torch.Tensor, depth: int, bn: int, splits: int,
                   filt: Optional[torch.Tensor] = None, n_docs: Optional[int] = None,
                   tau_id: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's selection (``fused_topk_lsh_partial`` in csrc/fused_topk.cu and
    pass 2), emulated on the CPU over the plain collision counts
    (``fused_topk.ref.scores_ref``): the
    ``n_docs`` rows cut into tiles of ``bn`` docs and ``splits`` ranges of
    whole tiles; in each range, tile by tile in ascending id order, a count
    that beats its query's threshold (strictly: the count of the list's
    depth-th entry, -inf until the list holds depth entries; no id) goes to
    a buffer, which merges into the list (width depth rounded up to 32) by
    counting (``merge_counted``) once it holds more than bn / 4, and after
    the range's last tile (the kernel merges it too when another query's
    buffer passes that mark: only how stale the threshold gets differs); the
    threshold is read again only then, so it is stale in between.  Then pass 2 (``threshold_merge``; ``tau_id=False``
    cuts its lists at the threshold's score without its id, the planted
    fault K2_STRICT of chip_smoke.py).  Returns (B, depth), -inf slots id
    -1."""
    counts = fused_ref.scores_ref(q, docs, "lsh")
    b, n = counts.shape
    n = n if n_docs is None else n_docs
    width = (depth + 31) // 32 * 32
    n_tiles = -(-n // bn)
    per = -(-n_tiles // splits)
    splits = -(-n_tiles // per)
    part_s = torch.full((splits, b, width), -torch.inf)
    part_i = torch.full((splits, b, width), 2**30, dtype=torch.int32)
    for qi in range(b):
        keep = torch.ones(n, dtype=torch.bool)
        if filt is not None:
            keep &= (filt if filt.dim() == 1 else filt[qi])[:n].bool()
        for sp in range(splits):
            ls, li = torch.empty(0), torch.empty(0, dtype=torch.long)
            cs, ci = [], []
            thr = -torch.inf
            tiles = range(sp * per, min(n_tiles, sp * per + per))
            for t in tiles:
                for d in range(t * bn, min(n, t * bn + bn)):
                    if keep[d] and counts[qi, d] > thr:
                        cs.append(float(counts[qi, d]))
                        ci.append(d)
                if len(cs) > bn // 4 or t == tiles[-1]:
                    ls, li = merge_counted(ls, li, torch.tensor(cs),
                                           torch.tensor(ci, dtype=torch.long), width)
                    cs, ci = [], []
                    thr = float(ls[depth - 1]) if len(ls) >= depth else -torch.inf
            part_s[sp, qi, :len(ls)] = ls
            part_i[sp, qi, :len(li)] = li.to(torch.int32)
    return threshold_merge(part_s, part_i, depth, splits, tau_id=tau_id)


def threshold_merge(part_s: torch.Tensor, part_i: torch.Tensor, depth: int,
                    lists: int, tau_id: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused top-k kernels' pass 2, emulated in torch: each query's
    splits' sorted lists (splits, B, K) cut to their first ``depth``
    entries; tau, the best of the lists' depth-th entries under (score
    desc, id asc); each list cut after its last entry at or before tau;
    then up to ``lists`` lists at a time merged as a tree (lists 2p and
    2p + 1 into list p, an entry's slot its index plus its rank in the other
    list, list 2p first where two entries are equal, slots >= depth
    dropped), a later chunk with the result so far in its first slot and
    its lists cut at the better of tau and that result's depth-th entry,
    once it has depth entries.  Returns the first ``depth`` entries (B,
    depth), -inf slots as id -1.  ``tau_id=False``: the lists cut at tau's
    score with id -1, so entries tied with tau are cut (a planted fault)."""
    splits, b, _ = part_s.shape
    out_s = torch.full((b, depth), -torch.inf)
    out_i = torch.full((b, depth), -1, dtype=torch.int32)
    for qi in range(b):
        s, i = part_s[:, qi, :depth], part_i[:, qi, :depth].long()
        tau_s, tau_i = s[0, -1], i[0, -1]
        for j in range(1, splits):
            if _precedes(s[j, -1], i[j, -1], tau_s, tau_i):
                tau_s, tau_i = s[j, -1], i[j, -1]
        if not tau_id:
            tau_i = torch.tensor(-1)
        x, s0 = [], 0
        while s0 < splits:
            take = min(splits - s0, lists - len(x))
            for j in range(s0, s0 + take):
                keep = ~_precedes(tau_s, tau_i, s[j], i[j])
                x.append((s[j][keep], i[j][keep]))
            s0 += take
            while len(x) > 1:
                y = []
                for p in range(0, len(x), 2):
                    if p + 1 == len(x):
                        y.append(x[p])
                        continue
                    (a_s, a_i), (b_s, b_i) = x[p], x[p + 1]
                    pos_a = torch.arange(len(a_s)) + _precedes(
                        b_s[None, :], b_i[None, :], a_s[:, None], a_i[:, None]).sum(1)
                    pos_b = torch.arange(len(b_s)) + (~_precedes(
                        b_s[:, None], b_i[:, None], a_s[None, :], a_i[None, :])).sum(1)
                    n = min(depth, len(a_s) + len(b_s))
                    m_s, m_i = torch.empty(n), torch.empty(n, dtype=torch.long)
                    for pos, vs, vi in ((pos_a, a_s, a_i), (pos_b, b_s, b_i)):
                        keep = pos < depth
                        m_s[pos[keep]], m_i[pos[keep]] = vs[keep], vi[keep]
                    y.append((m_s, m_i))
                x = y
            if len(x[0][0]) == depth and _precedes(x[0][0][-1], x[0][1][-1], tau_s, tau_i):
                tau_s, tau_i = x[0][0][-1], x[0][1][-1]
        r_s, r_i = x[0]
        out_s[qi, :len(r_s)] = r_s
        out_i[qi, :len(r_s)] = torch.where(r_s == -torch.inf, -1, r_i).to(torch.int32)
    return out_s, out_i


def flash_bf16_emulation(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, p: str = "bf16x2",
                         out_dtype: Optional[torch.dtype] = None, tile: int = 64) -> torch.Tensor:
    """The arithmetic of K9's bf16 kernel (``flash_attention_bf16``) on the
    CPU: q (B, Hq, S, D), k and v (B, Hkv, S, D) widened to f32, f32 logits
    ``q k^T / sqrt(D)`` with keys past the row at -1e30, an online softmax
    over ``tile``-key tiles (row max m, row sum l of the f32 probabilities),
    the probabilities as the P V product takes them, and the output ``acc /
    max(l, 1e-30)`` cast to ``out_dtype`` (default q's dtype).  ``p``:
    "bf16x2" the kernel's split, each probability as hi = its bf16 rounding
    plus lo = the remainder's (exact in f32 as hi + lo); "bf16" hi alone;
    "f32" unrounded.  A tile past a row's diagonal changes nothing (its
    probabilities are 0 and its alpha 1), so every row walks every tile."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    qf = q.float()
    kf, vf = (torch.repeat_interleave(x.float(), group, dim=1) for x in (k, v))
    m = torch.full((b, hq, s, 1), -1e30)
    l = torch.zeros((b, hq, s, 1))
    acc = torch.zeros((b, hq, s, d))
    rows = torch.arange(s)[:, None]
    for k0 in range(0, s, tile):
        logits = (qf @ kf[:, :, k0:k0 + tile].transpose(-1, -2)) / d**0.5
        logits = torch.where(torch.arange(k0, min(k0 + tile, s)) <= rows, logits, -1e30)
        m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
        probs = torch.exp(logits - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + probs.sum(-1, keepdim=True)
        if p != "f32":
            hi = probs.bfloat16().float()
            probs = hi + (probs - hi).bfloat16().float() if p == "bf16x2" else hi
        acc = alpha * acc + probs @ vf[:, :, k0:k0 + tile]
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(out_dtype or q.dtype)


def flash_tf32x3_emulation(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, k_lo: bool = True,
                           p_lo: bool = True, tile: int = 64) -> torch.Tensor:
    """The arithmetic of K9's f32 kernel (``flash_attention_tf32``) on the
    CPU: q (B, Hq, S, D), k and v (B, Hkv, S, D) f32, each split by bit
    masks into hi = cut_tf32(x) and lo = cut_tf32(x - hi).  The logits sum,
    per 8-column k-step, q hi x k lo, q lo x k hi and q hi x k hi, in that
    order; keys past the row are -1e30; an online softmax over ``tile``-key
    tiles (row max m, row sum l of the f32 probabilities); each tile's P V
    sums from zero, per 8-key step, p hi x v lo, p lo x v hi and p hi x v
    hi, and is folded into the output as ``acc * alpha + tile``; the output
    is ``acc / max(l, 1e-30)``.  ``k_lo=False`` drops q hi x k lo and
    ``p_lo=False`` drops p lo x v hi (planted faults: K or P cut to tf32)."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    qf = q.float()
    kf, vf = (torch.repeat_interleave(x.float(), group, dim=1) for x in (k, v))
    (q_hi, q_lo), (k_hi, k_lo_part), (v_hi, v_lo) = (
        (cut_tf32(x), cut_tf32(x - cut_tf32(x))) for x in (qf, kf, vf))
    logits = torch.zeros((b, hq, s, s))
    for c0 in range(0, d, 8):
        c = slice(c0, c0 + 8)
        if k_lo:
            logits = logits + q_hi[..., c] @ k_lo_part[..., c].transpose(-1, -2)
        logits = logits + q_lo[..., c] @ k_hi[..., c].transpose(-1, -2)
        logits = logits + q_hi[..., c] @ k_hi[..., c].transpose(-1, -2)
    logits = torch.where(torch.arange(s) <= torch.arange(s)[:, None], logits / d**0.5, -1e30)
    m = torch.full((b, hq, s, 1), -1e30)
    l = torch.zeros((b, hq, s, 1))
    acc = torch.zeros((b, hq, s, d))
    for k0 in range(0, s, tile):
        m_new = torch.maximum(m, logits[..., k0:k0 + tile].amax(-1, keepdim=True))
        probs = torch.exp(logits[..., k0:k0 + tile] - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + probs.sum(-1, keepdim=True)
        p_hi = cut_tf32(probs)
        p_lo_part = cut_tf32(probs - p_hi)
        part = torch.zeros_like(acc)
        for j0 in range(0, probs.shape[-1], 8):
            j, kv = slice(j0, j0 + 8), slice(k0 + j0, k0 + j0 + 8)
            part = part + p_hi[..., j] @ v_lo[:, :, kv]
            if p_lo:
                part = part + p_lo_part[..., j] @ v_hi[:, :, kv]
            part = part + p_hi[..., j] @ v_hi[:, :, kv]
        acc = acc * alpha + part
        m = m_new
    return acc / torch.clamp(l, min=1e-30)


def cuda_device() -> torch.device:
    """The first CUDA device; skips the calling test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def port_lm_config(jcfg):
    """The port's ``TransformerConfig`` of a JAX package's one: the same
    fields, its dtypes as torch's (the sharding fields have no
    counterpart).  Reads the JAX config's attributes only: no JAX import."""
    from repro_torch.models import transformer as tfm

    kw = {}
    for f in dataclasses.fields(tfm.TransformerConfig):
        v = getattr(jcfg, f.name)
        if f.name in ("dtype", "param_dtype"):
            v = getattr(torch, np.dtype(v).name)
        elif f.name == "moe" and v is not None:
            v = tfm.MoEConfig(**dataclasses.asdict(v))
        kw[f.name] = v
    return tfm.TransformerConfig(**kw)


def assert_logits_close(got, want, tol: float, what: str = "logits") -> None:
    """Hold model outputs ``got`` to ``want`` relative to their scale: the
    error's norm within ``tol`` of ``want``'s norm, and no element off by
    more than 2 ``tol`` of ``want``'s largest magnitude.  (A bf16 forward
    differs from another bf16 forward of the same model, summed in another
    order, by ~1% of that scale, spread over most elements; a row rule
    would hold every logit row to that noise.)"""
    g, w = (x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32) for x in (got, want))
    assert g.shape == w.shape, (what, g.shape, w.shape)
    err = np.linalg.norm(g - w) / np.linalg.norm(w)
    worst = np.abs(g - w).max() / np.abs(w).max()
    assert err <= tol and worst <= 2 * tol, (
        f"{what}: error norm {err:.3g} of the norm (tol {tol}), worst element {worst:.3g} of "
        f"the largest (tol {2 * tol})")


def assert_attention_grads_close(got, want, tol: float, dq_rows: bool = True) -> None:
    """Hold attention gradients ``got`` = (dq, dk, dv) to ``want``: dk and
    dv row by row (:func:`assert_rows_close`); dq too where ``dq_rows``,
    except its row 0: query 0 attends to key 0 alone, so its probability is
    1, dP equals Delta and its gradient is zero in exact arithmetic; each
    side returns its own rounding noise there, held within ``tol`` of the
    largest |dq| of its (batch, head).  Without ``dq_rows`` dq is held to
    its whole scale (:func:`assert_logits_close`): a bf16 backward reads
    the output rounded to bf16 for Delta, and in the first rows, where dq
    is a small difference of near-equal terms, that rounding moves a row
    by several percent of its own norm (against the reference's exact f32
    probabilities: up to 13% at row 1, 0.2% of the tensor's norm)."""
    dq, dq_want = (x.detach().float().cpu() if isinstance(x, torch.Tensor)
                   else torch.from_numpy(np.array(x, np.float32)) for x in (got[0], want[0]))
    assert dq.shape == dq_want.shape, (dq.shape, dq_want.shape)
    if dq_rows:
        assert_rows_close(dq[..., 1:, :], dq_want[..., 1:, :], tol)
        scale = dq_want.abs().amax(dim=(-1, -2))
        row0 = dq[..., 0, :].abs().amax(dim=-1)
        assert bool((row0 <= tol * scale).all()), (f"dq row 0 {float(row0.max())} past {tol} of "
                                                   f"{float(scale.min())}")
    else:
        assert_logits_close(dq, dq_want, tol, "dq")
    for g, w in zip(got[1:], want[1:]):
        assert_rows_close(g, w, tol)


def flat_tree(tree, prefix: str = "") -> dict:
    """{dotted name: numpy leaf} of a nested dict of JAX, numpy or torch
    leaves (sorted keys: JAX's flattening order)."""
    out = {}
    for k in sorted(tree):
        x = tree[k]
        if isinstance(x, dict):
            out.update(flat_tree(x, f"{prefix}{k}."))
        else:
            out[prefix + k] = x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return out


def assert_adam_close(got: dict, want: dict, init: dict, lr: float, steps: int) -> None:
    """Hold parameters after ``steps`` AdamW steps (dicts of numpy leaves by
    name) to ``want`` from the same ``init``.  Adam divides a gradient by
    the root of its running square, so an element whose gradient is a
    cancellation (a few ulps either way in two packages that sum in another
    order) takes a step of up to ~``lr`` in either direction.  So: each
    leaf's update (its change from ``init``) within 1e-4 of its norm, no
    element further apart than 2 ``lr`` a step, and at most 1% of the
    elements apart by more than rtol 1e-5, atol 1e-6."""
    assert got.keys() == want.keys()
    for name, w in want.items():
        g, w, i = (np.asarray(x, np.float64) for x in (got[name], w, init[name]))
        diff = np.abs(g - w)
        upd = np.linalg.norm(w - i)
        assert np.linalg.norm(g - w) <= 1e-4 * max(upd, 1e-12), (name, np.linalg.norm(g - w), upd)
        assert diff.max() <= 2 * lr * steps, (name, diff.max())
        assert (diff > 1e-6 + 1e-5 * np.abs(w)).mean() <= 0.01, (name, (diff > 1e-6).sum())


# The shapes (B, Hq, Hkv, S, D) at which the card's tests hold K9's
# backward in bf16 and in f32 (tests/test_torch_gpu.py), chosen so that on a 132-SM card
# ``kernel.bwd_plan`` takes each kind of split (MHA; one query head a block;
# an even and an uneven split of a group; the whole group a block) and every
# head width meets an S off the 64-row tiles
# (tests/test_torch_flash_attention.py::test_bwd_cuda_cases_reach_every_split).
BWD_CUDA_CASES = ((2, 8, 2, 1000, 32), (1, 4, 4, 130, 96), (1, 7, 1, 65, 128), (2, 4, 2, 257, 64),
                  (1, 14, 2, 777, 128), (3, 6, 3, 193, 96), (1, 16, 2, 1024, 64),
                  (2, 8, 8, 100, 32), (16, 8, 2, 1024, 32), (16, 7, 1, 1800, 32),
                  (8, 32, 8, 1024, 64))
# f32 cases that the card's tests hold with dq by rows (the f32 row rule,
# as before the split-TF32 backward), beside BWD_CUDA_CASES in f32.
BWD_CUDA_F32_ROW_CASES = ((1, 4, 2, 200, 96), (2, 4, 4, 63, 32), (1, 7, 1, 129, 128))
# (dtype, B, Hq, Hkv, S, D) of tests/test_torch_gpu.py's backward test:
# BWD_CUDA_CASES in bf16, BWD_CUDA_F32_ROW_CASES, then BWD_CUDA_CASES in f32.
BWD_CUDA_DTYPE_CASES = (*((torch.bfloat16, *c) for c in BWD_CUDA_CASES),
                        *((torch.float32, *c) for c in BWD_CUDA_F32_ROW_CASES),
                        *((torch.float32, *c) for c in BWD_CUDA_CASES))


def flash_bwd_emulation(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                        lse: torch.Tensor, dout: torch.Tensor, p_lo: bool = True,
                        ds_lo: bool = True) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The arithmetic of K9's bf16 backward (``flash_attention_bwd_dkdv_bf16``
    and ``flash_attention_bwd_dq_bf16``) on the CPU: f32 logits ``q k^T /
    sqrt(D)`` from the bf16 operands, P = exp(logits - lse) (0 past the
    row), Delta = rowsum(dout o out) in f32, dS = P o (dout v^T - Delta) in
    f32, then P and dS as the products take them: hi = the bf16 rounding
    plus lo = the remainder's (``p_lo`` / ``ds_lo``; without it hi alone, the
    one bf16 rounding); dv = P^T dout, dk = scale dS^T q, dq = scale dS k,
    summed in f32 (dk, dv over each KV head's group) and cast to the
    operands' dtype."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    qf, of = q.float(), dout.float()
    kf, vf = (torch.repeat_interleave(x.float(), group, dim=1) for x in (k, v))
    scale = d**-0.5
    logits = scale * (qf @ kf.transpose(-1, -2))
    causal = torch.arange(s) <= torch.arange(s)[:, None]
    p = torch.where(causal, torch.exp(logits - lse[..., None]), 0.0)
    ds = p * (of @ vf.transpose(-1, -2) - (of * out.float()).sum(-1, keepdim=True))

    def as_taken(x, lo):
        hi = x.bfloat16().float()
        return hi + (x - hi).bfloat16().float() if lo else hi

    p, ds = as_taken(p, p_lo), as_taken(ds, ds_lo)
    dq = scale * (ds @ kf)
    dk = (scale * (ds.transpose(-1, -2) @ qf)).reshape(b, -1, group, s, d).sum(2)
    dv = (p.transpose(-1, -2) @ of).reshape(b, -1, group, s, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# The lo terms of K9's f32 backward, by product and operand: "s:k" is q hi x
# k lo in S = q k^T, "dv:p" is p lo x dout hi in dv = P^T dout, and so on
# (``flash_bwd_tf32x3_emulation``'s ``drop``).
BWD_TF32_LO_TERMS = ("s:q", "s:k", "dp:do", "dp:v", "dv:p", "dv:do", "dk:ds", "dk:q", "dq:ds",
                     "dq:k")


def flash_bwd_tf32x3_emulation(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                               drop: Tuple[str, ...] = ()
                               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The arithmetic of K9's f32 backward (``flash_attention_bwd_dkdv_f32``
    and ``flash_attention_bwd_dq_f32``) on the CPU: each of its five
    products ``a b`` as split TF32, every operand split into hi =
    round_tf32(x) and lo = round_tf32(x - hi) (x - hi is exact in f32;
    hi + lo is x to 2^-22), and the product the sum of the three tf32
    products a hi x b lo, a lo x b hi and a hi x b hi (a lo x b lo, below
    2^-22 of it, left out), summed in f64 (tf32 products are exact there)
    from its start and rounded once to f32: S = q k^T from 0; dP - Delta =
    dout v^T from -Delta (Delta = rowsum(dout o out) in f32), as the kernel
    starts dP's sums; P = exp(S / sqrt(D) - lse) (0 past the row); dS = P o
    (dP - Delta); then dv = P^T dout, dk = scale dS^T q, dq = scale dS k
    (dk, dv summed over each KV head's group).  ``drop`` names lo terms to
    leave out (``BWD_TF32_LO_TERMS``: "s:k" drops q hi x k lo, the
    product's operand k rounded once to tf32)."""
    assert set(drop) <= set(BWD_TF32_LO_TERMS), drop
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    qf, of = q.float(), dout.float()
    kf, vf = (torch.repeat_interleave(x.float(), group, dim=1) for x in (k, v))

    def x3(name, a, a_name, c, c_name, start=0.0):  # a @ c as the kernel's three tf32 products
        a_hi, c_hi = round_tf32(a), round_tf32(c)
        a_lo, c_lo = round_tf32(a - a_hi), round_tf32(c - c_hi)
        acc = a_hi.double() @ c_hi.double() + start
        if f"{name}:{c_name}" not in drop:
            acc = acc + a_hi.double() @ c_lo.double()
        if f"{name}:{a_name}" not in drop:
            acc = acc + a_lo.double() @ c_hi.double()
        return acc.float()

    scale = d**-0.5
    logits = scale * x3("s", qf, "q", kf.transpose(-1, -2), "k")
    causal = torch.arange(s) <= torch.arange(s)[:, None]
    p = torch.where(causal, torch.exp(logits - lse[..., None]), 0.0)
    delta = (of * out.float()).sum(-1, keepdim=True)
    ds = p * x3("dp", of, "do", vf.transpose(-1, -2), "v", start=-delta.double())
    dq = scale * x3("dq", ds, "ds", kf, "k")
    dk = (scale * x3("dk", ds.transpose(-1, -2), "ds", qf, "q")).reshape(b, -1, group, s, d).sum(2)
    dv = x3("dv", p.transpose(-1, -2), "p", of, "do").reshape(b, -1, group, s, d).sum(2)
    return dq, dk, dv
