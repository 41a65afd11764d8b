"""Puzzle (MP3) self-supervised pretraining on one GPU, masked position
prediction (the port's counterpart of ``train_puzzle.py``).

    python -m vit_tpu_torch.train_puzzle --dataset synthetic --no_wandb \\
        --epochs 1 --steps_per_epoch 5 --log_every 1 [--device cpu]

``train_puzzle.py``'s flags and defaults (image 256, patch 16, the B
encoder, mask ratio 0.75, bs 64, AdamW at lr 1.5e-4, weight decay 0.05, no
clip) and the loop of ``vit_tpu_torch.train_mae`` (its loaders, as the JAX
script imports ``train_mae.get_loaders``; its refusals, per-step masks,
checkpoints, resume, SIGTERM and log, under ``<run_dir>/puzzle/``), with
``train/pos_acc`` beside the loss and the best checkpoint by the highest
validation position accuracy. Fine-tune with ``python -m
vit_tpu_torch.train_vit --init_from <ckpt_dir>``: patch projection, learned
``pos_emb`` and the stack transfer.
"""

from __future__ import annotations

import argparse

import torch

from vit_tpu_torch import train_vit
from vit_tpu_torch.models.puzzle import Puzzle, PuzzleConfig
from vit_tpu_torch.train.step import (make_puzzle_eval_step,
                                      make_puzzle_train_step)
from vit_tpu_torch.train_mae import add_common_args, pick_device, pretrain
from vit_tpu_torch.utils.init import init_params_


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_common_args(parser, "ckpt/puzzle")
    args = parser.parse_args(argv)
    args.min_lr = args.lr / 10
    return args


def main(argv=None) -> dict:
    """Pretrain Puzzle as the flags say; returns the logged metrics."""
    args = parse_args(argv)
    train_vit.check_ported(args)
    device = pick_device(args, "train_puzzle")
    config = PuzzleConfig(args.image_size, args.in_channels, args.patch_size,
                          args.transformer, args.mask_ratio, args.dropout,
                          dtype=torch.bfloat16 if args.mixed
                          else torch.float32)
    model = Puzzle(config, device=device)
    init_params_(model, torch.Generator(device=device).manual_seed(args.seed))
    run_name = (f"puzzle_{args.patch_size}px_{args.image_size}px_"
                f"{args.transformer}_{args.mask_ratio}mr_{args.bs}bs_"
                f"{args.lr}lr")
    return pretrain(args, model, config, make_puzzle_train_step(model),
                    make_puzzle_eval_step(model), project="puzzle",
                    run_name=run_name, best_key="pos_acc", mode="max")


if __name__ == "__main__":
    main()
