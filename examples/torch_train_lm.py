"""End-to-end driver on the PyTorch/CUDA port, the twin of
``examples/train_lm.py``: train a ~100M-param LM for a few hundred steps
with the full substrate (checkpointing, restart-safe; straggler
watchdog; AdamW + warmup-cosine; synthetic Zipfian data), assert that
the loss fell, then serve a few generations from the trained weights.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300]
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu \\
        --steps 30 --d-model 64 --layers 2
"""
import argparse
import tempfile

import torch

from repro_torch.configs.base import LMConfig
from repro_torch.data import SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.models.transformer import init_lm, lm_loss
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.serve import generate
from repro_torch.train import Trainer, TrainerConfig

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=300)
ap.add_argument("--d-model", type=int, default=512)
ap.add_argument("--layers", type=int, default=8)
ap.add_argument("--device", default=None,
                help="torch device (default: cuda)")
args = ap.parse_args()
device = resolve_device(args.device)

# ~100M params: 8L x 512d + 32k vocab
cfg = LMConfig(name="lm100m", n_layers=args.layers, d_model=args.d_model,
               n_heads=8, n_kv_heads=4, d_ff=2048, vocab=32_000,
               attention_chunk=128)
params = init_lm(cfg, torch.Generator(device=device).manual_seed(0), device)
n_params = sum(p.numel() for p in params.parameters())
print(f"model: {n_params / 1e6:.1f}M params on {device}")

data = SyntheticTokens(vocab=cfg.vocab, batch=8, seq_len=128, device=device)


def loss_fn(p, b):
    return lm_loss(p, cfg, b["tokens"], b["labels"], loss_chunk=128)


with tempfile.TemporaryDirectory() as ckpt_dir:
    trainer = Trainer(
        loss_fn, adamw(warmup_cosine(3e-4, 20, args.steps)), params, data,
        TrainerConfig(total_steps=args.steps, ckpt_dir=ckpt_dir,
                      ckpt_interval=100, log_interval=25))
    params = trainer.run()
    first, last = trainer.history[0][1], trainer.history[-1][1]
    print(f"loss: {first:.3f} -> {last:.3f}")
    assert last < first, "loss did not improve"

prompts = torch.randint(0, cfg.vocab, (2, 8),
                        generator=torch.Generator().manual_seed(7))
out = generate(params, cfg, prompts.numpy(), n_new=16, max_len=64)
print("generated token ids:", out.tolist())
