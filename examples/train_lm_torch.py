"""End-to-end driver of the PyTorch port's training: the twin of
``examples/train_lm.py``.  Trains a small LM for a few hundred steps with
the port's whole stack (AdamW with float32 master weights, the
deterministic data pipeline, async checkpoints, restart on failure), on
the card unless ``--device cpu``:

    PYTHONPATH=src python examples/train_lm_torch.py --steps 200
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 20

It runs ``python -m repro_torch.launch.train`` on the reduced config of
``--arch``; that launcher trains the published configs too (without
``--smoke``).
"""
import argparse
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3p2_1b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cmd = [sys.executable, "-m", "repro_torch.launch.train",
           "--arch", args.arch, "--smoke",
           "--steps", str(args.steps), "--batch", "8", "--seq", "128",
           "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "50",
           "--device", args.device]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                               else []))
    raise SystemExit(subprocess.call(cmd, env=env))
