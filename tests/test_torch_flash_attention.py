"""The port's causal GQA flash attention (K9, ``flash_attention`` and
``causal_attention``) against the JAX package's.

The same numpy inputs go to both packages.  The port runs its CPU route
(the plain ``attention_ref``); the JAX side runs its Pallas kernel with
``interpret=True`` and its ``ref.attention_ref``.  f32 outputs must agree
within 1e-4, bf16 outputs within 1e-2, both relative to each output row's
scale (rtol = tol, atol = tol x the largest |output| of the row).
Interpret-mode JAX attention is slow, so S stays at most 256.  The bf16
kernel's arithmetic (64-key tiles, P split into two bf16 parts) and the f32
kernel's (split TF32: three tf32 products for each product of Q K^T and of
P V, each tile's P V folded into the output) are emulated here
(``torch_parity.flash_bf16_emulation``, ``flash_tf32x3_emulation``) and
held to both packages.  So is the bf16 backward's (P and dS split into two
bf16 parts: ``torch_parity.flash_bwd_emulation``), held to the port's plain
backward, which tests/test_torch_lm_grad.py holds to JAX's; the f32
backward's (split TF32: three tf32 products for each of its five products,
``torch_parity.flash_bwd_tf32x3_emulation``), held to JAX's gradient and to
the port's plain backward; and the plan that splits the GQA groups of both
over blocks (``kernel.bwd_plan``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (BWD_CUDA_DTYPE_CASES, BWD_TF32_LO_TERMS, assert_attention_grads_close,
                          assert_rows_close, flash_bf16_emulation, flash_bwd_emulation,
                          flash_bwd_tf32x3_emulation, flash_tf32x3_emulation, to_torch)

from repro.kernels.flash_attention.kernel import flash_attention as jflash_attention
from repro.kernels.flash_attention.ops import causal_attention as jcausal_attention
from repro.kernels.flash_attention.ref import attention_ref as jattention_ref
from repro_torch.kernels import common
from repro_torch.kernels.flash_attention import causal_attention, flash_attention, kernel, ref

TOL = {"f32": 1e-4, "bf16": 1e-2}


def _qkv(b, hq, hkv, s, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    return [jnp.asarray(rng.normal(size=(b, h, s, d)), jdt) for h in (hq, hkv, hkv)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("b,hq,hkv,s,d", [
    (1, 4, 4, 1, 32),     # MHA, one position
    (1, 4, 2, 130, 64),   # GQA group 2, unaligned S
    (1, 4, 1, 256, 96),   # MQA, phi3-mini's head width
    (2, 2, 2, 130, 96),   # MHA, B = 2
    (1, 8, 4, 256, 32),   # GQA group 2
    (1, 4, 1, 130, 32),   # MQA, unaligned S
])
def test_flash_attention_matches_jax(b, hq, hkv, s, d, dtype):
    jq, jk, jv = _qkv(b, hq, hkv, s, d, dtype, seed=hq * s + d)
    got = flash_attention(to_torch(jq), to_torch(jk), to_torch(jv))
    assert got.dtype == (torch.float32 if dtype == "f32" else torch.bfloat16)
    assert got.shape == (b, hq, s, d)
    assert_rows_close(got, jflash_attention(jq, jk, jv, interpret=True), TOL[dtype])
    assert_rows_close(got, jattention_ref(jq, jk, jv), TOL[dtype])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("b,hq,hkv,s", [(1, 4, 2, 130), (2, 2, 1, 64)])
def test_flash_attention_cpu_route_takes_any_head_dim(b, hq, hkv, s, dtype):
    """D = 16 has no kernel instance; the CPU route computes it, as the
    reference does for any D."""
    jq, jk, jv = _qkv(b, hq, hkv, s, 16, dtype, seed=hq * s + 16)
    got = flash_attention(to_torch(jq), to_torch(jk), to_torch(jv))
    assert got.shape == (b, hq, s, 16)
    assert_rows_close(got, jflash_attention(jq, jk, jv, interpret=True), TOL[dtype])
    assert_rows_close(got, jattention_ref(jq, jk, jv), TOL[dtype])


def test_causal_attention_is_the_reference_entry_point():
    jq, jk, jv = _qkv(2, 6, 2, 70, 64, "f32", seed=5)
    got = causal_attention(to_torch(jq), to_torch(jk), to_torch(jv))
    assert_rows_close(got, jcausal_attention(jq, jk, jv, use_kernel=False), TOL["f32"])


def test_plain_version_in_blocks_equals_one_block(monkeypatch):
    """The plain version forms the logits a block of heads and rows at a
    time; the blocks change no more than the last bits of the products
    (the matmuls of other shapes sum in another order)."""
    q, k, v = (to_torch(a) for a in _qkv(1, 4, 2, 130, 32, "f32", seed=6))
    whole = ref.attention_ref(q, k, v)
    monkeypatch.setattr(ref, "_TILE_ELEMS", 3 * 130)  # one head, three rows a block
    torch.testing.assert_close(ref.attention_ref(q, k, v), whole, rtol=1e-6, atol=1e-6)


def test_flash_attention_refuses_what_the_kernel_does_not_take(monkeypatch):
    x = torch.zeros((1, 4, 8, 64))
    with pytest.raises(ValueError):  # Hq not a multiple of Hkv, on either route
        flash_attention(x, torch.zeros((1, 3, 8, 64)), torch.zeros((1, 3, 8, 64)))
    with pytest.raises(ValueError):  # operands on two devices
        flash_attention(x, x.to("meta"), x)
    # The kernel's route (the operands taken as lying on one card) refuses
    # what the kernel has no instance for; the CPU route computes it.
    monkeypatch.setattr(common, "on_cpu", lambda *tensors: False)
    with pytest.raises(ValueError):  # head width without an instance
        flash_attention(*(torch.zeros((1, 4, 8, 48)),) * 3)
    with pytest.raises(ValueError):
        flash_attention(*(torch.zeros((1, 4, 8, 16)),) * 3)
    with pytest.raises(TypeError):
        flash_attention(x, x.bfloat16(), x)
    with pytest.raises(TypeError):
        flash_attention(*(x.half(),) * 3)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (7, 1)])  # MHA; GQA group 7 (deepseek-coder-33b's)
@pytest.mark.parametrize("d", [64, 96, 128])
@pytest.mark.parametrize("s", [130, 256])
def test_bf16_kernel_arithmetic_matches_jax(s, d, hq, hkv):
    """The bf16 kernel's arithmetic, emulated (f32 logits, an online softmax
    over 64-key tiles with the -1e30 mask, P as hi + lo bf16 parts, l from
    the f32 P, the output rounded to bf16), against JAX's Pallas kernel and
    reference under the bf16 row rule."""
    jq, jk, jv = _qkv(1, hq, hkv, s, d, "bf16", seed=3 * s + d + hq)
    got = flash_bf16_emulation(to_torch(jq), to_torch(jk), to_torch(jv))
    assert got.dtype == torch.bfloat16 and got.shape == (1, hq, s, d)
    assert_rows_close(got, jflash_attention(jq, jk, jv, interpret=True), TOL["bf16"])
    assert_rows_close(got, jattention_ref(jq, jk, jv), TOL["bf16"])


@pytest.mark.parametrize("hq,hkv", [(4, 4), (7, 1)])
@pytest.mark.parametrize("d", [64, 96, 128])
@pytest.mark.parametrize("s", [130, 256])
def test_bf16_kernel_arithmetic_with_f32_p_is_the_plain_version(s, d, hq, hkv):
    """With P left in f32 and the output in f32, the emulation's tiles and
    online softmax are the port's plain version up to the order of the f32
    sums (1e-5 of each row)."""
    q, k, v = (to_torch(a).float() for a in _qkv(1, hq, hkv, s, d, "bf16", seed=5 * s + d))
    got = flash_bf16_emulation(q, k, v, p="f32", out_dtype=torch.float32)
    assert_rows_close(got, ref.attention_ref(q, k, v), 1e-5)


def test_bf16_p_needs_its_low_part():
    """Why the kernel splits P: P rounded once to bf16 (2^-8 of each
    probability at most) moves whole rows of a bf16 output past the row
    rule's 1e-2 / 2 of their norm at S = 1024, where hi + lo passes."""
    q, k, v = (to_torch(a) for a in _qkv(1, 4, 1, 1024, 32, "bf16", seed=1))
    want = ref.attention_ref(q, k, v)
    assert_rows_close(flash_bf16_emulation(q, k, v), want, TOL["bf16"])
    with pytest.raises(AssertionError, match="rows' error norms"):
        assert_rows_close(flash_bf16_emulation(q, k, v, p="bf16"), want, TOL["bf16"])


@pytest.mark.parametrize("hq,hkv", [(4, 4), (7, 1)])  # MHA; GQA group 7
@pytest.mark.parametrize("d", [64, 96, 128])
@pytest.mark.parametrize("s", [130, 256])
def test_tf32_kernel_arithmetic_matches_jax(s, d, hq, hkv):
    """The f32 kernel's arithmetic, emulated (q, k, p and v split into tf32
    hi and lo parts, three tf32 products a k-step of Q K^T and a key step of
    P V, an online softmax over 64-key tiles with the -1e30 mask, each
    tile's P V folded into the output), against JAX's Pallas kernel and
    reference under the f32 row rule."""
    jq, jk, jv = _qkv(1, hq, hkv, s, d, "f32", seed=7 * s + d + hq)
    got = flash_tf32x3_emulation(to_torch(jq), to_torch(jk), to_torch(jv))
    assert got.dtype == torch.float32 and got.shape == (1, hq, s, d)
    assert_rows_close(got, jflash_attention(jq, jk, jv, interpret=True), TOL["f32"])
    assert_rows_close(got, jattention_ref(jq, jk, jv), TOL["f32"])


@pytest.mark.parametrize("dropped", ["k_lo", "p_lo"])
def test_tf32_kernel_needs_each_low_part(dropped):
    """Why each operand is split: without q hi x k lo (K cut to tf32) or
    without p lo x v hi (P cut to tf32) the emulated f32 kernel moves whole
    rows past the f32 row rule's 1e-4 / 2 of their norm against the port's
    plain version, where the full split passes."""
    q, k, v = (to_torch(a) for a in _qkv(1, 4, 1, 256, 64, "f32", seed=2))
    want = ref.attention_ref(q, k, v)
    assert_rows_close(flash_tf32x3_emulation(q, k, v), want, TOL["f32"])
    with pytest.raises(AssertionError, match="past"):
        assert_rows_close(flash_tf32x3_emulation(q, k, v, **{dropped: False}), want, TOL["f32"])


def test_bwd_p_and_ds_need_their_low_parts():
    """Why the bf16 backward splits P and dS: at chip_smoke.py's S = 1,000,
    D = 32 case the emulated kernel holds to the port's plain backward under
    the bf16 row rule with both split; P rounded once to bf16 moves dv rows
    past the rule's 1e-2 / 2 of their norm, dS rounded once dq rows."""
    q, k, v = (to_torch(a) for a in _qkv(2, 8, 2, 1000, 32, "bf16", seed=0))
    dout = to_torch(_qkv(2, 8, 8, 1000, 32, "bf16", seed=1)[0])
    out, lse = ref.attention_fwd_ref(q, k, v)
    want = ref.attention_bwd_ref(q, k, v, out, lse, dout)
    assert_attention_grads_close(flash_bwd_emulation(q, k, v, out, lse, dout), want, TOL["bf16"])
    dv = flash_bwd_emulation(q, k, v, out, lse, dout, p_lo=False)[2]
    with pytest.raises(AssertionError, match="rows' error norms"):
        assert_rows_close(dv, want[2], TOL["bf16"])
    dq = flash_bwd_emulation(q, k, v, out, lse, dout, ds_lo=False)[0]
    with pytest.raises(AssertionError, match="rows' error norms"):
        assert_rows_close(dq[..., 1:, :], want[0][..., 1:, :], TOL["bf16"])


def _bwd_inputs(b, hq, hkv, s, d, seed):
    """f32 q, k, v, dout (torch) and the plain forward's out and lse."""
    q, k, v = (to_torch(a) for a in _qkv(b, hq, hkv, s, d, "f32", seed=seed))
    dout = to_torch(_qkv(b, hq, hq, s, d, "f32", seed=seed + 1)[0])
    return (q, k, v, *ref.attention_fwd_ref(q, k, v), dout)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (7, 1)])  # MHA; GQA group 7
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [130, 256])
def test_bwd_tf32_kernel_arithmetic_matches_jax(s, d, hq, hkv):
    """The f32 backward's arithmetic, emulated (each of S, dP, dv, dk and dq
    as three tf32 products of split operands), against the JAX package's
    gradient of its f32 ``attention_ref`` (``jax.vjp``): dk and dv under the
    f32 row rule, dq within it of its tensor's scale.  dq's first rows are
    small differences of near-equal terms (a query that attends almost all
    to one key), which f32 rounding moves by a large part of their own
    norm: at S 256, D 128, GQA 7 the port's own plain backward (f32
    products) misses dq's row rule against JAX's gradient
    (``test_plain_f32_backward_misses_dq_rows_against_jax``).  The next
    test holds dq by rows against the plain backward."""
    q, k, v, out, lse, dout = _bwd_inputs(1, hq, hkv, s, d, seed=11 * s + d + hq)
    got = flash_bwd_tf32x3_emulation(q, k, v, out, lse, dout)
    assert [x.dtype for x in got] == [torch.float32] * 3
    _, vjp = jax.vjp(jattention_ref, *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    assert_attention_grads_close(got, vjp(jnp.asarray(dout.numpy())), TOL["f32"], dq_rows=False)


def test_plain_f32_backward_misses_dq_rows_against_jax():
    """Why the f32 comparisons with JAX hold dq at its tensor's scale: the
    port's plain backward (f32 products, as JAX's) at the S 256, D 128, GQA
    7 case of ``test_bwd_tf32_kernel_arithmetic_matches_jax`` keeps dk and
    dv by rows and dq at its scale, but misses dq's row rule in a first row,
    a small difference of near-equal terms."""
    q, k, v, out, lse, dout = _bwd_inputs(1, 7, 1, 256, 128, seed=11 * 256 + 128 + 7)
    plain = ref.attention_bwd_ref(q, k, v, out, lse, dout)
    _, vjp = jax.vjp(jattention_ref, *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    want = vjp(jnp.asarray(dout.numpy()))
    assert_attention_grads_close(plain, want, TOL["f32"], dq_rows=False)
    with pytest.raises(AssertionError, match="rows' error norms"):
        assert_attention_grads_close(plain, want, TOL["f32"])


@pytest.mark.parametrize("b,hq,hkv,s,d", [(2, 8, 2, 1000, 32), (1, 7, 1, 300, 128)])
def test_bwd_tf32_kernel_arithmetic_matches_plain_version(b, hq, hkv, s, d):
    """The same emulation at chip_smoke.py's f32 S = 1,000, D = 32 case and
    its GQA 7 case, against the port's plain backward (``attention_bwd_ref``,
    f32 products) under the f32 row rule, dq's row 0 at its head's scale."""
    args = _bwd_inputs(b, hq, hkv, s, d, seed=s + d)
    assert_attention_grads_close(flash_bwd_tf32x3_emulation(*args),
                                 ref.attention_bwd_ref(*args), TOL["f32"])


@pytest.fixture(scope="module")
def bwd_f32_case():
    """S = 1,000, D = 32 (the bf16 split test's shape) and its plain backward."""
    args = _bwd_inputs(2, 8, 2, 1000, 32, seed=0)
    return args, ref.attention_bwd_ref(*args)


def test_bwd_tf32_kernel_keeps_the_row_rule(bwd_f32_case):
    args, want = bwd_f32_case
    assert_attention_grads_close(flash_bwd_tf32x3_emulation(*args), want, TOL["f32"])


@pytest.mark.parametrize("term", BWD_TF32_LO_TERMS)
def test_bwd_tf32_kernel_needs_each_low_part(term, bwd_f32_case):
    """Why the f32 backward keeps all three tf32 products of each of its
    five products: without any one lo term (that product's operand rounded
    once to tf32, 2^-11 of itself) the emulation misses the f32 row rule
    against the plain backward, where the full split keeps it
    (``test_bwd_tf32_kernel_keeps_the_row_rule``)."""
    args, want = bwd_f32_case
    with pytest.raises(AssertionError, match="past"):
        assert_attention_grads_close(flash_bwd_tf32x3_emulation(*args, drop=(term,)), want,
                                     TOL["f32"])


@pytest.mark.parametrize("sms", [132, 16])
@pytest.mark.parametrize("b,hq,hkv,s", [
    (4, 32, 32, 1024), (1, 56, 8, 2048), (2, 8, 2, 1000), (16, 7, 1, 1800), (8, 32, 8, 1024),
    (1, 64, 1, 70), (64, 48, 6, 4096), (3, 12, 4, 1), (16, 8, 2, 1024)])
def test_bwd_plan_slices_cover_each_head_once(b, hq, hkv, s, sms):
    """The plan's slices of a group (``heads_per_block`` consecutive query
    heads each, the last maybe shorter) take every query head of the group
    exactly once (MHA: one slice of one head); a group is split only where
    its longest walk (from key tile 0) would exceed half a block slot's
    share of the work (two blocks an SM), and then no block walks more
    query heads than keep it under that."""
    group = hq // hkv
    hpb = kernel.bwd_plan(b, hq, hkv, s, sms)
    assert 1 <= hpb <= group
    slices = -(-group // hpb)
    heads = [h for sl in range(slices) for h in range(sl * hpb, min(group, (sl + 1) * hpb))]
    assert heads == list(range(group))
    tiles = -(-s // 64)
    share = b * hq * tiles * (tiles + 1) / 2 / (2 * sms)  # query tiles a block slot walks
    assert hpb == group or hpb * tiles <= max(tiles, share / 2)
    if hpb < group:  # split only where the whole group's walk exceeds it
        assert group * tiles > share / 2


def test_bwd_cuda_cases_reach_every_split():
    """tests/test_torch_gpu.py's backward cases of each dtype (bf16 and f32)
    reach, on a 132-SM card, each kind of split the plan takes (MHA; one
    query head a block; an even and an uneven split; the whole group of
    more than one head a block) and, at every head width, an S off the
    64-row tiles."""
    for dtype in (torch.bfloat16, torch.float32):
        cases = [c for dt, *c in BWD_CUDA_DTYPE_CASES if dt == dtype]
        kinds = set()
        for b, hq, hkv, s, d in cases:
            group, hpb = hq // hkv, kernel.bwd_plan(b, hq, hkv, s)
            kinds.add("mha" if group == 1 else "whole" if hpb == group else "one" if hpb == 1
                      else "even" if group % hpb == 0 else "uneven")
        assert kinds == {"mha", "one", "even", "uneven", "whole"}, dtype
        assert {d for *_, s, d in cases if s % 64} == {32, 64, 96, 128}, dtype
