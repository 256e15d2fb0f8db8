"""Training launcher of the PyTorch port (counterpart of
``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-9b \\
      --smoke --steps 50 --ckpt-dir /tmp/ckpt

  PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm-mlperf \\
      --smoke --steps 20 --device cpu

Runs the end-to-end trainer (checkpoint/restart, straggler watchdog,
optional gradient compression) on one device: CUDA unless ``--device
cpu`` is given (without a CUDA device and without ``--device`` the
launcher raises). Flag names and defaults follow ``repro.launch.train``;
``--device`` is the port's addition, as in ``launch.sssp`` and
``launch.serve``. Families: ``lm`` (``SyntheticTokens``, AdamW with
warmup-cosine over chunked cross-entropy), ``recsys``
(``SyntheticClicks``, DLRM) and ``gnn`` (``random_graph(512, 4096)``
with ``gnn_full_batch`` features, full-batch training). Weights are
random from seed 0 on the device.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-interval", type=int, default=25)
    ap.add_argument("--compression", default="none",
                    choices=["none", "int8", "topk"])
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import family_of, get_config
    from repro_torch.data import SyntheticClicks, SyntheticTokens
    from repro_torch.device import resolve_device
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import Trainer, TrainerConfig

    family = family_of(args.arch)
    cfg = get_config(args.arch, smoke=args.smoke)
    opt = adamw(warmup_cosine(args.lr, 10, args.steps))
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(0)

    if family == "lm":
        from repro_torch.models.transformer import init_lm, lm_loss
        params = init_lm(cfg, gen, device)
        data = SyntheticTokens(vocab=cfg.vocab, batch=args.batch,
                               seq_len=args.seq, device=device)

        def loss_fn(p, b):
            return lm_loss(p, cfg, b["tokens"], b["labels"],
                           loss_chunk=min(args.seq, 512))
    elif family == "recsys":
        from repro_torch.models.dlrm import dlrm_loss, init_dlrm
        params = init_dlrm(cfg, gen, device)
        data = SyntheticClicks(cfg.vocab_sizes, cfg.n_dense,
                               batch=args.batch, device=device)

        def loss_fn(p, b):
            return dlrm_loss(p, cfg, b["dense"], b["sparse"], b["labels"])
    elif family == "gnn":
        from repro_torch.data import gnn_full_batch
        from repro_torch.graphs import random_graph
        from repro_torch.models.gnn import gnn_loss, init_gnn

        g = random_graph(512, 4096, seed=0, device=device)
        fb = gnn_full_batch(512, cfg.d_in, cfg.n_classes, seed=0,
                            device=device)

        class _GraphData:
            def batch_at(self, step):
                return dict(fb, src=g.src, dst=g.dst)

        data = _GraphData()
        params = init_gnn(cfg, gen, device)

        def loss_fn(p, b):
            return gnn_loss(p, cfg, dict(x=b["x"], src=b["src"],
                                         dst=b["dst"]),
                            b["labels"], b["label_mask"])
    else:
        raise SystemExit(f"use launch.sssp for family {family!r}")

    trainer = Trainer(
        loss_fn, opt, params, data,
        TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                      ckpt_interval=args.ckpt_interval,
                      compression=args.compression,
                      microbatch=args.microbatch))
    trainer.run()
    if trainer.history:
        first, last = trainer.history[0][1], trainer.history[-1][1]
        print(f"[train] loss {first:.4f} -> {last:.4f} over "
              f"{args.steps} steps")
    if trainer.watchdog.events:
        print(f"[train] straggler events: {trainer.watchdog.events}")


if __name__ == "__main__":
    main()
