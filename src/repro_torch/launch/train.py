"""End-to-end training driver with checkpoint / restart fault tolerance
(port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch tiny-lm --steps 300 \
        --ckpt-dir /tmp/ckpt --ckpt-every 50

Trains on one device (``--device``, the card unless the caller asks for
the CPU): deterministic stateless data (step -> batch, ``data/lm.py``),
AdamW with a cosine schedule, async atomic checkpoints, automatic resume
from the latest one, and a straggler watchdog.  ``--kill-at`` injects a
crash (exit 42) after that step, to show the restart.  Prints the
reference's lines: ``[train] resumed from step N``, ``[train] step i:
loss ...``, ``[train] done: {...}``.

``--arch tiny-lm`` is a ~100M-parameter config, ``micro-lm`` a ~3M one;
the assigned LM archs run with the same code path.  :func:`train` runs the
driver on a given :class:`TransformerConfig` (a full-width model with its
depth cut, say).  The port's data stream (numpy) differs from the
reference's (threefry), so the two drivers' losses are not comparable.
"""
from __future__ import annotations

import argparse
from typing import Optional

import torch

from repro_torch import configs
from repro_torch.core.index import _check_device
from repro_torch.data import lm as lm_data
from repro_torch.models import transformer as tfm
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.train_loop import Watchdog, build_train_step, make_train_state


def tiny_lm_config() -> tfm.TransformerConfig:
    """~100M params: 12L x 768d x 12H, vocab 32064 (phi-mini tokenizer
    scale) — the end-to-end example model."""
    return tfm.TransformerConfig(
        name="tiny-lm", n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
        d_ff=2048, vocab=32064,
    )


def micro_lm_config() -> tfm.TransformerConfig:
    """~3M params: the CI-scale model."""
    return tfm.TransformerConfig(
        name="micro-lm", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        d_ff=256, vocab=2048,
    )


def get_model(arch: str) -> tfm.TransformerConfig:
    if arch == "tiny-lm":
        return tiny_lm_config()
    if arch == "micro-lm":
        return micro_lm_config()
    spec = configs.get(arch)
    if spec.family != "lm":
        raise ValueError(f"{arch} is a {spec.family} architecture; the driver covers LM archs")
    return spec.make_model(None)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tiny-lm")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--kill-at", type=int, default=-1,
                    help="simulate a crash after this step (fault-tolerance demo)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def train(cfg: tfm.TransformerConfig, args: argparse.Namespace,
          watchdog: Optional[Watchdog] = None) -> dict:
    """The driver's body on model ``cfg`` with :func:`parser`'s ``args``.
    Returns the summary it prints last; raises SystemExit(42) at
    ``--kill-at``."""
    dev = _check_device(args.device)
    total, active = cfg.param_count()
    print(f"[train] {cfg.name}: {total/1e6:.1f}M params ({active/1e6:.1f}M active)")
    data_cfg = lm_data.LmDataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                                    global_batch=args.global_batch, seed=args.seed)
    opt = opt_mod.adamw(lr=opt_mod.cosine_schedule(args.lr, args.warmup, args.steps))

    def loss_of(params, batch):
        return tfm.loss_fn(params, batch["tokens"], batch["labels"], cfg)

    step_fn = build_train_step(loss_of, opt, args.microbatches)

    start_step = 0
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    state = make_train_state(params, opt)
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        state, start_step = ckpt.restore(args.ckpt_dir, state)
        print(f"[train] resumed from step {start_step}")

    watchdog = watchdog or Watchdog()
    losses = []
    pending = None
    for step in range(start_step, args.steps):
        batch = {k: x.to(dev) for k, x in lm_data.batch_at(data_cfg, step).items()}
        watchdog.start()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        dt = watchdog.stop(step)
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"[train] step {step}: loss {loss:.4f} ({dt*1e3:.0f} ms)", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            if pending is not None:
                pending.join()  # one in-flight async save at a time
            pending = ckpt.save_async(args.ckpt_dir, step + 1, state)
        if args.kill_at == step:
            if pending is not None:
                pending.join()
            print(f"[train] simulated crash at step {step}")
            raise SystemExit(42)
    if pending is not None:
        pending.join()
    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, args.steps, state)
    summary = {
        "first_loss": losses[0] if losses else None,
        "last_loss": losses[-1] if losses else None,
        "steps_run": len(losses),
        "stragglers_flagged": watchdog.flagged,
    }
    print(f"[train] done: {summary}")
    return summary


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    return train(get_model(args.arch), args)


if __name__ == "__main__":
    main()
