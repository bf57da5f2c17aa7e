"""End-to-end training demo on the port: an LM trained a few hundred
steps, with a crash in the middle and a restart that resumes from the
latest atomic checkpoint.

    PYTHONPATH=src python examples/train_e2e_torch.py [--steps 300] [--arch tiny-lm]
        [--device cuda]

The counterpart of ``examples/train_e2e.py``: the same driver flags, run by
``python -m repro_torch.launch.train`` on the card (``--device cpu`` for a
machine without one; micro-lm is the size for that).
"""
import argparse
import os
import subprocess
import sys
import tempfile

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="tiny-lm", help="tiny-lm (~100M) | micro-lm (~3M)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    env = dict(os.environ, PYTHONPATH=SRC)
    with tempfile.TemporaryDirectory() as ck:
        base = [
            sys.executable, "-m", "repro_torch.launch.train",
            "--arch", args.arch, "--steps", str(args.steps),
            "--global-batch", str(args.batch), "--seq-len", str(args.seq),
            "--ckpt-dir", ck, "--ckpt-every", str(max(10, args.steps // 6)),
            "--log-every", "20", "--device", args.device,
        ]
        kill_at = args.steps // 2
        print(f"== phase 1: train until a simulated crash at step {kill_at}")
        r = subprocess.run(base + ["--kill-at", str(kill_at)], env=env)
        if r.returncode != 42:
            raise SystemExit(f"expected the simulated crash (exit 42), got exit {r.returncode}")
        print("== phase 2: restart; it resumes from the latest atomic checkpoint")
        r = subprocess.run(base, env=env)
        if r.returncode != 0:
            raise SystemExit(f"the restarted run failed with exit {r.returncode}")
        print("== done: the loss curve continued through the crash (stateless data + "
              "checkpoint restore; see repro_torch/launch/train.py)")


if __name__ == "__main__":
    main()
