"""The port's training stack (``repro_torch.train``, ``launch/train.py``)
against the JAX package's, on the CPU.

Same numpy inputs go to both packages.  Tolerances:

  * schedules, norms, clipping and single optimizer updates: rtol 1e-6
    (f32 step arithmetic in both; the packages round the same formulas in
    another order, a few ulps);
  * several updates and the train step (1 and 4 microbatches): rtol 1e-5,
    atol 1e-6 (Adam divides by sqrt(nu): an ulp in a small gradient
    becomes a larger step);
  * checkpoints: bit for bit, both ways.

Ports of the anchors ``tests/test_train.py:36,49,63,70,91,125``; the
crash-restart anchor runs ``python -m repro_torch.launch.train --device
cpu``, and the watchdog anchor drives a patched clock, so that it does not
depend on the machine's load.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import to_torch

from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train.train_loop import build_train_step as jbuild_train_step
from repro.train.train_loop import make_train_state as jmake_train_state
from repro_torch.launch import train as train_driver
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.train_loop import (TrainState, Watchdog, build_train_step,
                                          make_train_state)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _np_tree(seed, scale=1.0):
    """A parameter-like tree: a matrix, a vector, a stacked (layers, n, m)
    leaf and a nested dict."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (scale * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    return {"w": f(6, 5), "b": f(5), "stack": f(3, 4, 5), "inner": {"ln": f(7), "m": f(2, 7)}}


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.from_numpy(v.copy())
            for k, v in tree.items()}


def _close(got, want, rtol, atol=0.0):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k], rtol, atol)
        return
    np.testing.assert_allclose(to_torch(got).numpy() if not isinstance(got, torch.Tensor)
                               else got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol)


def test_cosine_schedule_and_clipping_match_jax():
    lr, jlr = (m.cosine_schedule(3e-4, 4, 24) for m in (opt_mod, jopt))
    for step in range(0, 30):
        np.testing.assert_allclose(float(lr(torch.tensor(step, dtype=torch.int32))),
                                   float(jlr(jnp.int32(step))), rtol=1e-6)
    tree = _np_tree(1, scale=3.0)
    jt = jax.tree.map(jnp.asarray, tree)
    np.testing.assert_allclose(float(opt_mod.global_norm(_torch_tree(tree))),
                               float(jopt.global_norm(jt)), rtol=1e-6)
    for max_norm in (1.0, 1e3):
        got, norm = opt_mod.clip_by_global_norm(_torch_tree(tree), max_norm)
        want, jnorm = jopt.clip_by_global_norm(jt, max_norm)
        np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
        _close(got, want, rtol=1e-6)


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizer_updates_match_jax(kind):
    """Single updates within 1e-6, then four in a row within 1e-5: AdamW on
    a cosine schedule with clipping that bites (max_grad_norm 1 against
    gradients of norm ~10), Adafactor with weight decay and its factored
    moments on the rank-3 stacked leaf."""
    kw = (dict(lr=opt_mod.cosine_schedule(1e-2, 2, 6)) if kind == "adamw"
          else dict(lr=5e-2, weight_decay=0.01))
    jkw = (dict(lr=jopt.cosine_schedule(1e-2, 2, 6)) if kind == "adamw"
           else dict(lr=5e-2, weight_decay=0.01))
    opt, jo = getattr(opt_mod, kind)(**kw), getattr(jopt, kind)(**jkw)
    params, jparams = _torch_tree(_np_tree(2)), jax.tree.map(jnp.asarray, _np_tree(2))
    state, jstate = opt.init(params), jo.init(jparams)
    for step in range(4):
        g = _np_tree(10 + step, scale=2.0)
        params, state, info = opt.update(_torch_tree(g), state, params)
        jparams, jstate, jinfo = jo.update(jax.tree.map(jnp.asarray, g), jstate, jparams)
        rtol = 1e-6 if step == 0 else 1e-5
        _close(params, jparams, rtol=rtol, atol=1e-6)
        _close({k: v for k, v in state.items() if k != "step"},
               {k: v for k, v in jstate.items() if k != "step"}, rtol=rtol, atol=1e-6)
        assert int(state["step"]) == int(jstate["step"]) == step + 1
        assert sorted(info) == sorted(jinfo)
        for key in info:
            np.testing.assert_allclose(float(info[key]), float(jinfo[key]), rtol=1e-6)


def _quadratic(seed=0):
    """The anchor's problem with numpy data: (loss_fn, jax_loss_fn,
    batch_at(i) -> numpy {"x", "y"}, numpy params)."""
    rng = np.random.default_rng(seed)
    w_true = rng.standard_normal((8, 4)).astype(np.float32)

    def loss_fn(p, batch):
        return torch.mean((batch["x"] @ p["w"] + p["b"] - batch["y"]) ** 2)

    def jloss_fn(p, batch):
        return jnp.mean((batch["x"] @ p["w"] + p["b"] - batch["y"]) ** 2)

    def batch_at(i):
        x = np.random.default_rng((seed, i)).standard_normal((16, 8)).astype(np.float32)
        return {"x": x, "y": x @ w_true}

    params = {"w": np.zeros((8, 4), np.float32), "b": np.zeros((4,), np.float32)}
    return loss_fn, jloss_fn, batch_at, params


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizers_converge(kind):
    """Anchor ``tests/test_train.py:36``."""
    loss_fn, _, batch_at, params = _quadratic()
    opt = opt_mod.adamw(lr=1e-2) if kind == "adamw" else opt_mod.adafactor(lr=5e-2)
    state = make_train_state(_torch_tree(params), opt)
    step = build_train_step(loss_fn, opt)
    first = None
    for i in range(300):
        state, m = step(state, _torch_tree(batch_at(i)))
        if first is None:
            first = float(m["loss"])
    assert float(m["loss"]) < 0.05 * first
    assert int(state.step) == 300


@pytest.mark.parametrize("micro", [1, 4])
def test_train_step_matches_jax(micro):
    """``build_train_step`` with 1 and 4 microbatches against the
    reference's on the same batches: losses, metrics and parameters over
    5 steps."""
    loss_fn, jloss_fn, batch_at, params = _quadratic(1)
    opt, jo = opt_mod.adamw(lr=1e-2), jopt.adamw(lr=1e-2)
    state = make_train_state(_torch_tree(params), opt)
    jstate = jmake_train_state(jax.tree.map(jnp.asarray, params), jo)
    step = build_train_step(loss_fn, opt, n_microbatches=micro)
    jstep = jax.jit(jbuild_train_step(jloss_fn, jo, n_microbatches=micro))
    for i in range(5):
        b = batch_at(i)
        state, m = step(state, _torch_tree(b))
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, b))
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5)
    _close(state.params, jstate.params, rtol=1e-5, atol=1e-6)
    assert int(state.step) == int(jstate.step) == 5


def test_microbatch_accumulation_matches_full_batch():
    """Anchor ``tests/test_train.py:49``."""
    loss_fn, _, batch_at, params = _quadratic()
    opt = opt_mod.adamw(lr=1e-2)
    s1 = make_train_state(_torch_tree(params), opt)
    s4 = make_train_state(_torch_tree(params), opt)
    step1 = build_train_step(loss_fn, opt, n_microbatches=1)
    step4 = build_train_step(loss_fn, opt, n_microbatches=4)
    for i in range(5):
        s1, _ = step1(s1, _torch_tree(batch_at(i)))
        s4, _ = step4(s4, _torch_tree(batch_at(i)))
    for k in ("w", "b"):
        np.testing.assert_allclose(s1.params[k].detach().numpy(), s4.params[k].detach().numpy(),
                                   rtol=2e-4, atol=2e-5)
    with pytest.raises(ValueError):
        build_train_step(loss_fn, opt, n_microbatches=3)(s1, _torch_tree(batch_at(0)))


def test_grad_clipping():
    """Anchor ``tests/test_train.py:63``."""
    clipped, norm = opt_mod.clip_by_global_norm({"w": torch.full((10,), 100.0)}, 1.0)
    assert float(torch.linalg.norm(clipped["w"])) <= 1.0 + 1e-5
    assert float(norm) > 100.0


def test_checkpoint_atomicity_prune_and_restore(tmp_path):
    """Anchor ``tests/test_train.py:70``."""
    _, _, _, params = _quadratic()
    state = make_train_state(_torch_tree(params), opt_mod.adamw())
    d = str(tmp_path)
    for s in (1, 2, 3):
        ckpt.save(d, s, state, keep=2)
    assert ckpt.list_steps(d) == [2, 3]
    os.makedirs(os.path.join(d, "step_00000099.tmp"))  # a stale .tmp dir is invisible
    assert ckpt.latest_step(d) == 3
    restored, step = ckpt.restore(d, state)
    assert step == 3 and isinstance(restored, TrainState)
    for (ka, a), (kb, b) in zip(ckpt._flatten_with_paths(restored),
                                ckpt._flatten_with_paths(state)):
        assert ka == kb and a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises((ValueError, KeyError)):  # a shape mismatch is refused
        ckpt.restore(d, {"params": {"w": torch.zeros((9, 4)), "b": torch.zeros((4,))}})
    bad = make_train_state({"w": torch.zeros((9, 4)), "b": torch.zeros((4,))}, opt_mod.adamw())
    with pytest.raises(ValueError):
        ckpt.restore(d, bad)


def test_save_async_copies_before_the_next_update(tmp_path):
    """``save_async`` snapshots the state before it returns: an in-place
    update right after it does not reach the checkpoint (a CPU tensor's
    ``.cpu()`` would be the tensor itself)."""
    _, _, _, params = _quadratic()
    state = make_train_state(_torch_tree(params), opt_mod.adamw())
    t = ckpt.save_async(str(tmp_path), 1, state)
    state.params["w"].add_(1.0)
    t.join()
    restored, _ = ckpt.restore(str(tmp_path), state)
    assert float(restored.params["w"].abs().max()) == 0.0


def _lm_like_params():
    tree = _np_tree(5)
    tree["layers"] = {"wq": np.arange(24, dtype=np.float32).reshape(2, 3, 4)}
    return tree


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_checkpoints_cross_between_packages(tmp_path, kind):
    """A checkpoint the JAX package writes restores into the port's state,
    and the port's into the JAX package's: every leaf bit for bit, the
    manifests' keys, shapes and dtypes the same, the step kept."""
    params = _lm_like_params()
    jstate = jmake_train_state(jax.tree.map(jnp.asarray, params), getattr(jopt, kind)())
    # give the moments and steps non-zero values
    jstate = jax.tree.map(lambda x: x + jnp.ones_like(x) * 0.5 if x.dtype == jnp.float32
                          else x + 7, jstate)
    jckpt.save(str(tmp_path / "jax"), 7, jstate)
    state = make_train_state(_torch_tree(params), getattr(opt_mod, kind)())
    restored, step = ckpt.restore(str(tmp_path / "jax"), state)
    assert step == 7
    jflat = jax.tree_util.tree_flatten_with_path(jstate)[0]
    flat = ckpt._flatten_with_paths(restored)
    assert [k for k, _ in flat] == [jax.tree_util.keystr(k) for k, _ in jflat]
    for (_, a), (_, b) in zip(flat, jflat):
        assert a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ckpt.save(str(tmp_path / "torch"), 9, restored)
    back, jstep = jckpt.restore(str(tmp_path / "torch"), jstate)
    assert jstep == 9
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    manifests = [json.load(open(tmp_path / d / f"step_{s:08d}" / "manifest.json"))["leaves"]
                 for d, s in (("jax", 7), ("torch", 9))]
    assert ([(m["key"], m["shape"], m["dtype"]) for m in manifests[0]]
            == [(m["key"], m["shape"], m["dtype"]) for m in manifests[1]])


def test_train_driver_crash_restart_is_deterministic(tmp_path):
    """Anchor ``tests/test_train.py:91`` on the port's driver (``--device
    cpu``): an uninterrupted run and a run crashed after step 13 (exit 42)
    and restarted (it resumes from the checkpoint of step 8) end on the
    same loss.  24 steps, not the anchor's 60, to keep the file short."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "micro-lm",
            "--steps", "24", "--global-batch", "2", "--seq-len", "32", "--ckpt-every", "8",
            "--log-every", "23", "--device", "cpu"]

    def run(args, ckdir):
        return subprocess.run(base + ["--ckpt-dir", str(ckdir)] + args, capture_output=True,
                              text=True, env=env, timeout=600)

    r1 = run([], tmp_path / "a")
    assert r1.returncode == 0, r1.stdout + r1.stderr
    r2a = run(["--kill-at", "13"], tmp_path / "b")
    assert r2a.returncode == 42, r2a.stdout + r2a.stderr
    assert "simulated crash at step 13" in r2a.stdout
    r2b = run([], tmp_path / "b")
    assert r2b.returncode == 0, r2b.stdout + r2b.stderr
    assert "resumed from step 8" in r2b.stdout

    def final_loss(out):
        for line in reversed(out.splitlines()):
            if "last_loss" in line:
                return float(line.split("'last_loss':")[1].split(",")[0])
        raise AssertionError(out)

    assert abs(final_loss(r1.stdout) - final_loss(r2b.stdout)) < 1e-4
    assert ckpt.list_steps(str(tmp_path / "a")) == [8, 16, 24]


def test_watchdog_flags_stragglers():
    """Anchor ``tests/test_train.py:125`` with the clock patched: five 10 ms
    steps, then a 100 ms one, flagged once."""
    now = [0.0]
    wd = Watchdog(threshold=1.5, clock=lambda: now[0])
    logs = []
    for i in range(6):
        wd.start()
        now[0] += 0.1 if i == 5 else 0.01
        wd.stop(i, log=logs.append)
    assert wd.flagged == 1 and "straggler" in logs[-1]


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        train_driver.main(["--arch", "micro-lm", "--steps", "1"])
    with pytest.raises(RuntimeError):
        train_driver.train(train_driver.micro_lm_config(),
                           train_driver.parser().parse_args(["--device", "cuda"]))
