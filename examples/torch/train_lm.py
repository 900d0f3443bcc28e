"""End-to-end training on the PyTorch/CUDA port: a GQA LM on the
synthetic pipeline (the port of ``examples/train_lm.py``).

Defaults to a ~6M-param config; ``--hundred-m`` selects a ~100M-param
model (same code path). Demonstrates the production loop: checkpoint /
resume, heartbeat, straggler report, LR schedule, gradient clipping. One
device: the reference's (1, 1) debug mesh is the port's ``mesh=None`` (a
mesh of the port is a process group's; ``python -m
repro_torch.launch.train --mesh debug`` runs one).

  PYTHONPATH=src python examples/torch/train_lm.py --steps 300
  PYTHONPATH=src python examples/torch/train_lm.py --hundred-m --steps 300
  PYTHONPATH=src python examples/torch/train_lm.py --device cpu --steps 30
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.train import train_loop
from repro_torch.models import model_zoo as zoo
from repro_torch.models.config import ModelConfig
from repro_torch.train.optimizer import AdamWConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--hundred-m", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="checkpoints/train_lm")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.hundred_m:
        cfg = ModelConfig("lm-100m", "dense", n_layers=12, d_model=768,
                          n_heads=12, n_kv=4, d_ff=2048, vocab=32768,
                          dtype="float32")
    else:
        cfg = ModelConfig("lm-7m", "dense", n_layers=4, d_model=256,
                          n_heads=8, n_kv=4, d_ff=1024, vocab=4096,
                          dtype="float32")
    print(f"model: {cfg.name}  params={zoo.param_count(cfg) / 1e6:.1f}M")
    opt = AdamWConfig(lr=1e-3, warmup_steps=max(args.steps // 20, 10),
                      decay_steps=args.steps)
    data = DataConfig(vocab=cfg.vocab, global_batch=args.batch,
                      seq_len=args.seq)
    _, hist = train_loop(cfg, opt, data, None, args.steps, args.ckpt_dir,
                         save_interval=max(args.steps // 4, 10),
                         device=args.device)
    print(f"loss: {hist[0]:.4f} -> {hist[-1]:.4f} over {len(hist)} steps")
    assert hist[-1] < hist[0], "no learning?"
    print("OK")


if __name__ == "__main__":
    main()
