"""The port's sharded training pieces (``repro_torch.train.compression``,
``repro_torch.train.pipeline``, and the data-parallel step composed of
``distributed.shard_rows``, ``tfm.loss_fn`` and ``psum``) against the JAX
package's, on the CPU.

The JAX side's ``shard_map`` paths run as the reference's own sharded
tests run them (``tests/test_distributed.py:17-33``): once for the module
(:func:`jref`), in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8``, which writes every
input and output to one ``.npz``; the port runs here on meshes of
``cpu`` devices over the same arrays.  Anchors: ``test_distributed.py:214``
(compression and GPipe) and the data-parallel half of ``:191``.
Tolerances:

  * ``compressed_psum``: bit for bit (the same f32 operations in the same
    order; ``torch.round`` and ``jnp.round`` both round half to even; XLA
    fuses the residual's multiply and subtract, which the port rounds once
    too: ``compression.residual_leaf``);
  * GPipe against JAX: the reference test's 1e-6 on the output, 1e-5 on
    gradients; against the port's own layers run one microbatch at a time:
    bit for bit (the same ops at the same shapes);
  * the micro-LM stage: the LM parity tests' logits tolerance (f32 1e-4,
    bf16 2e-2, ``assert_logits_close``);
  * the data-parallel loss: rtol 2e-4 (``test_distributed.py:191``'s).
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_logits_close, port_lm_config

from repro.models import transformer as jtfm
from repro_torch.core import distributed
from repro_torch.models import transformer as tfm
from repro_torch.train import compression, pipeline
from repro_torch.train.optimizer import tree_leaves

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CPU = "cpu"
LM_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LEAVES = ("b", "e", "w")  # compressed_psum's leaves: bf16 (8, 32), f32 (24, 5, 7), f32 (32, 16)

_JAX_SCRIPT = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.models import transformer as tfm
from repro.launch.train import micro_lm_config
from repro.train import compression, pipeline
out = {}
def put(key, x):
    x = np.asarray(x)
    out[key] = x.astype(np.float32) if x.dtype.name == "bfloat16" else x

# compressed_psum: three leaves (one bf16, one with a nonzero residual), two calls
mesh8 = jax.make_mesh((8,), ("data",))
rng = np.random.default_rng(41)
def grads(scale):
    return {"w": jnp.asarray(scale * rng.standard_normal((32, 16)), jnp.float32),
            "b": jnp.asarray(scale * rng.standard_normal((8, 32)), jnp.bfloat16),
            "e": jnp.asarray(scale * rng.standard_normal((24, 5, 7)), jnp.float32)}
g1, g2 = grads(1.0), grads(3.0)
r0 = {"w": jnp.zeros((32, 16)), "b": jnp.zeros((8, 32)),
      "e": jnp.asarray(0.01 * rng.standard_normal((24, 5, 7)), jnp.float32)}
reduce = jax.jit(compat.shard_map(
    lambda g, r: compression.compressed_psum(g, r, "data"), mesh=mesh8,
    in_specs=(P("data"), P("data")), out_specs=(P(), P("data"))))
o1, r1 = reduce(g1, r0)
o2, r2 = reduce(g2, r1)
for name, tree in (("g1", g1), ("g2", g2), ("r0", r0), ("o1", o1), ("r1", r1), ("o2", o2),
                   ("r2", r2)):
    for leaf, x in tree.items():
        put(f"cp/{name}/{leaf}", x)

# test_distributed.py:214: the reference test's own case
g = jnp.arange(8 * 64, dtype=jnp.float32).reshape(8, 64) / 100.0
o, r = jax.jit(compat.shard_map(
    lambda gs, r: compression.compressed_psum(gs, r, "data"), mesh=mesh8,
    in_specs=(P("data"), P("data")), out_specs=(P(), P("data"))))({"w": g}, {"w": jnp.zeros((8, 64))})
put("ref/g", g); put("ref/out", o["w"]); put("ref/r", r["w"])

# GPipe, the reference test's tanh case, its gradient, the 10-layer caveat and batch_axes
n_layers, d, M, mb = 8, 16, 4, 2
ws = jax.random.normal(jax.random.key(0), (n_layers, d, d)) * (1.0 / np.sqrt(d))
x = jax.random.normal(jax.random.key(1), (M, mb, d))
cot = jax.random.normal(jax.random.key(2), (M, mb, d))
layer_fn = lambda h, w: jnp.tanh(h @ w)
mesh4 = jax.make_mesh((4,), ("pipe",))
gp = pipeline.build_gpipe_fn(mesh4, layer_fn, n_stages=4)
put("gp/ws", ws); put("gp/x", x); put("gp/cot", cot); put("gp/out", jax.jit(gp)(ws, x))
dws, dx = jax.jit(jax.grad(lambda w, x: jnp.sum(gp(w, x) * cot), argnums=(0, 1)))(ws, x)
put("gp/dws", dws); put("gp/dx", dx)
ws10 = jax.random.normal(jax.random.key(3), (10, d, d)) * (1.0 / np.sqrt(d))
put("gp10/ws", ws10); put("gp10/out", jax.jit(gp)(ws10, x))
mesh42 = jax.make_mesh((4, 2), ("pipe", "data"))
xb = jax.random.normal(jax.random.key(4), (M, 4, d))
gpb = pipeline.build_gpipe_fn(mesh42, layer_fn, n_stages=4, batch_axes=("data",))
put("gpb/x", xb); put("gpb/out", jax.jit(gpb)(ws, xb))

# a micro-LM stage: tfm._dense_layer over 4 layers, one a stage
for dtype in ("float32", "bfloat16"):
    cfg = micro_lm_config()
    cfg = type(cfg)(**{**cfg.__dict__, "n_layers": 4, "dtype": jnp.dtype(dtype)})
    params = tfm.init_params(jax.random.key(0), cfg)
    toks = jax.random.randint(jax.random.key(1), (2, 2, 16), 0, cfg.vocab)
    xlm = params["embed"].astype(cfg.dtype)[toks]
    positions = jnp.broadcast_to(jnp.arange(16)[None], (2, 16))
    fn = pipeline.build_gpipe_fn(
        mesh4, lambda h, layer: tfm._dense_layer(h, layer, cfg, positions), n_stages=4)
    put(f"lm/{dtype}/toks", toks); put(f"lm/{dtype}/out", jax.jit(fn)(params["layers"], xlm))
np.savez(sys.argv[1], **out)
'''


@pytest.fixture(scope="module")
def jref(tmp_path_factory):
    """The JAX package's sharded outputs (one subprocess under 8 fake host
    devices)."""
    path = str(tmp_path_factory.mktemp("jax-sharded-train") / "ref.npz")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_JAX_SCRIPT), path],
                       capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, PYTHONPATH=SRC))
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr[-3000:]}"
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _t(a, dtype=None):
    x = torch.from_numpy(np.array(a))
    return x if dtype is None else x.to(dtype)


def _per_shard(tree, n):
    """A tree of global (n * rows, ...) arrays as n trees of (rows, ...)
    tensors: ``shard_map``'s ``P("data")``."""
    return [{k: v.chunk(n)[s] for k, v in tree.items()} for s in range(n)]


def _cp_tree(jref, name):
    return {leaf: _t(jref[f"cp/{name}/{leaf}"], torch.bfloat16 if name.startswith("g")
                     and leaf == "b" else None) for leaf in LEAVES}


def test_compressed_psum_bit_equal_to_jax_over_two_calls(jref):
    mesh = distributed.make_mesh((8,), ("data",), device=CPU)
    r = _per_shard(_cp_tree(jref, "r0"), 8)
    for call in ("1", "2"):
        g = _per_shard(_cp_tree(jref, f"g{call}"), 8)
        assert g[0]["b"].dtype == torch.bfloat16
        out, r = compression.compressed_psum(g, r, mesh, "data")
        want_out, want_r = _cp_tree(jref, f"o{call}"), _cp_tree(jref, f"r{call}")
        for leaf in LEAVES:
            for s in range(8):
                assert out[s][leaf].dtype == torch.float32
                assert torch.equal(out[s][leaf], want_out[leaf]), (call, leaf, s)
            assert torch.equal(torch.cat([x[leaf] for x in r]), want_r[leaf]), (call, leaf)


def test_compressed_psum_reference_case(jref):
    """``test_distributed.py:214``'s case and bound; its outputs equal JAX's,
    and the residual is what quantization dropped."""
    mesh = distributed.make_mesh((8,), ("data",), device=CPU)
    g = _t(jref["ref/g"])
    out, new_r = compression.compressed_psum(
        [{"w": x} for x in g.chunk(8)], [{"w": torch.zeros(1, 64)} for _ in range(8)], mesh,
        "data")
    exact = g.mean(0)
    err = float((out[0]["w"].reshape(-1, 64)[0] - exact).abs().max())
    assert err < 5e-3 * float(exact.abs().max()) + 1e-4, err
    assert torch.equal(out[0]["w"], _t(jref["ref/out"]))
    assert torch.equal(torch.cat([r["w"] for r in new_r]), _t(jref["ref/r"]))
    scale = torch.clamp_min(g.abs().max(), 1e-12) / 127.0
    q = compression.quantize_leaf(g, scale)
    assert torch.equal(torch.cat([r["w"] for r in new_r]), compression.residual_leaf(g, q, scale))


def test_compressed_psum_helpers():
    params = {"a": torch.zeros(3, 4), "b": {"c": torch.zeros(5, dtype=torch.bfloat16)}}
    r = compression.init_residual(params)
    assert r["b"]["c"].dtype == torch.float32 and r["a"].shape == (3, 4)
    assert compression.wire_bytes(params, compressed=False) == 4 * 17
    assert compression.wire_bytes(params, compressed=True) == 17  # the reference's count
    # half to even, as jnp.round, and the clip
    q = compression.quantize_leaf(torch.tensor([0.5, 1.5, 2.5, -0.5, 300.0, -300.0]),
                                  torch.tensor(1.0))
    assert q.tolist() == [0, 2, 2, 0, 127, -127] and q.dtype == torch.int8


def _tanh(h, w):
    return torch.tanh(h @ w)


def _sequential(layer_fn, layers, x):
    """The port's layers run one microbatch at a time, in order."""
    outs = []
    for j in range(x.shape[0]):
        h = x[j]
        for w in layers:
            h = layer_fn(h, w)
        outs.append(h)
    return torch.stack(outs)


def test_gpipe_tanh_matches_jax_and_sequential(jref):
    ws, x = _t(jref["gp/ws"]), _t(jref["gp/x"])
    mesh = distributed.make_mesh((4,), ("pipe",), device=CPU)
    out = pipeline.build_gpipe_fn(mesh, _tanh, n_stages=4)(ws, x)
    np.testing.assert_allclose(out.numpy(), jref["gp/out"], atol=1e-6)
    assert torch.equal(out, _sequential(_tanh, ws.unbind(0), x))


def test_gpipe_gradient_matches_jax(jref):
    ws = _t(jref["gp/ws"]).requires_grad_()
    x = _t(jref["gp/x"]).requires_grad_()
    mesh = distributed.make_mesh((4,), ("pipe",), device=CPU)
    out = pipeline.build_gpipe_fn(mesh, _tanh, n_stages=4)(ws, x)
    dws, dx = torch.autograd.grad(out, (ws, x), _t(jref["gp/cot"]))
    np.testing.assert_allclose(dws.numpy(), jref["gp/dws"], atol=1e-5)
    np.testing.assert_allclose(dx.numpy(), jref["gp/dx"], atol=1e-5)


def test_gpipe_drops_trailing_layers_as_the_reference(jref):
    """10 layers over 4 stages: per = 10 // 4 = 2, so both packages run
    layers 0-7 and drop 8 and 9 (a reference caveat, reproduced)."""
    ws, x = _t(jref["gp10/ws"]), _t(jref["gp/x"])
    mesh = distributed.make_mesh((4,), ("pipe",), device=CPU)
    out = pipeline.build_gpipe_fn(mesh, _tanh, n_stages=4)(ws, x)
    np.testing.assert_allclose(out.numpy(), jref["gp10/out"], atol=1e-6)
    assert torch.equal(out, _sequential(_tanh, ws.unbind(0)[:8], x))
    assert not torch.equal(out, _sequential(_tanh, ws.unbind(0), x))
    assert [tuple(p.shape) for p in tree_leaves(pipeline.stage_params({"w": ws}, 3, 4))] == [
        (2, 16, 16)]


def test_gpipe_batch_axes_on_a_2d_mesh(jref):
    ws, x = _t(jref["gp/ws"]), _t(jref["gpb/x"])
    mesh = distributed.make_mesh((4, 2), ("pipe", "data"), device=CPU)
    out = pipeline.build_gpipe_fn(mesh, _tanh, n_stages=4, batch_axes=("data",))(ws, x)
    np.testing.assert_allclose(out.numpy(), jref["gpb/out"], atol=1e-6)
    assert torch.equal(out, _sequential(_tanh, ws.unbind(0), x))
    with pytest.raises(ValueError, match="not divisible"):
        pipeline.build_gpipe_fn(mesh, _tanh, n_stages=4, batch_axes=("data",))(ws, x[:, :3])
    with pytest.raises(ValueError, match="stages"):
        pipeline.build_gpipe_fn(mesh, _tanh, n_stages=2)


def test_gpipe_counts_each_stage_once_a_microbatch():
    """Inactive ticks are skipped: over S + M - 1 ticks each stage runs its
    layers on M microbatches, forward and backward, and its forward once
    more for the checkpoint's recompute."""
    calls = []

    def layer_fn(h, w):
        calls.append(torch.is_grad_enabled())
        return torch.tanh(h @ w)

    ws = torch.randn(8, 4, 4, generator=torch.Generator().manual_seed(0)).requires_grad_()
    x = torch.randn(3, 2, 4, generator=torch.Generator().manual_seed(1))
    mesh = distributed.make_mesh((4,), ("pipe",), device=CPU)
    out = pipeline.build_gpipe_fn(mesh, layer_fn, n_stages=4)(ws, x)
    assert len(calls) == 8 * 3
    out.sum().backward()
    assert len(calls) == 2 * 8 * 3
    assert pipeline.bubble_fraction(4, 4) == 3 / 7


def _micro_cfg(dtype):
    from repro.launch.train import micro_lm_config as jmicro

    jcfg = dataclasses.replace(jmicro(), n_layers=4, dtype=jnp.dtype(dtype))
    return jcfg, port_lm_config(jcfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpipe_micro_lm_stage_matches_run_layers_and_jax(jref, dtype):
    jcfg, cfg = _micro_cfg(dtype)
    params = tfm.params_from_numpy(jtfm.init_params(jax.random.key(0), jcfg), cfg, device=CPU)
    toks = _t(jref[f"lm/{dtype}/toks"])
    x = tfm._embed(params, toks, cfg)  # (M, mb, S, d)
    positions = torch.arange(16).expand(2, 16)
    mesh = distributed.make_mesh((4,), ("pipe",), device=CPU)
    out = pipeline.build_gpipe_fn(
        mesh, lambda h, layer: tfm._dense_layer(h, layer, cfg, positions), n_stages=4)(
        params["layers"], x)
    with torch.no_grad():
        want = torch.stack([tfm._run_layers(params, x[j], cfg) for j in range(2)])
    assert torch.equal(out, want)
    assert_logits_close(out, jref[f"lm/{dtype}/out"], LM_TOL[dtype], f"gpipe micro-lm {dtype}")


def test_data_parallel_loss_and_gradients_match_jax():
    """The data-parallel half of ``test_distributed.py:191``: the batch split
    over 4 data shards of a (4, 2) mesh, each shard's loss from
    ``loss_fn``; the mean of the losses against JAX's single-device loss
    (rtol 2e-4), and ``psum`` / 4 of the shards' gradients against
    ``jax.grad`` of the whole batch (f32: 1e-5 of each leaf's scale)."""
    jcfg = jtfm.TransformerConfig(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                                  vocab=128, dtype=jnp.float32)
    jparams = jtfm.init_params(jax.random.key(0), jcfg)
    jtoks = jax.random.randint(jax.random.key(1), (8, 16), 0, 128)
    ref, jgrads = jax.value_and_grad(lambda p: jtfm.loss_fn(p, jtoks, jtoks, jcfg))(jparams)
    cfg = port_lm_config(jcfg)
    params = tfm.params_from_numpy(jparams, cfg, device=CPU)
    leaves = []
    tfm.tree_map(lambda n, v: leaves.append((n, v.requires_grad_())), params)
    mesh = distributed.make_mesh((4, 2), ("data", "model"), device=CPU)
    losses, grads = [], []
    for toks in distributed.shard_rows(mesh, np.array(jtoks), ("data",)):
        loss = tfm.loss_fn(params, toks, toks, cfg)
        losses.append(loss.detach())
        grads.append(torch.autograd.grad(loss, [v for _, v in leaves]))
    assert len(losses) == 4
    np.testing.assert_allclose(float(distributed.psum(losses) / 4), float(ref), rtol=2e-4)
    want = {}
    jtfm_flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    for path, g in jtfm_flat:
        want[".".join(p.key for p in path)] = np.asarray(g)
    for j, (n, _) in enumerate(leaves):
        mean = distributed.psum([g[j] for g in grads]) / 4
        assert_logits_close(mean, want[n], 1e-5, f"data-parallel grad {n}")
