"""ViT-VQGAN training on one GPU (the port's counterpart of
``train_vit_vqgan.py``).

    python -m vit_tpu_torch.train_vit_vqgan --dataset synthetic --no_wandb \\
        [--perceptual_weights random] [--device cpu]

It takes ``train_vit_vqgan.py``'s flags with the same defaults: ViT-VQGAN-B
at image 128, patch 16 (64 latents, one a patch), codebook 2048 × 12, bs
32, bf16 compute (``--mixed``), AdamW at lr 1e-4, weight decay 1e-4, clip
1.0, 5,000 warmup steps into a cosine over 500,000 to lr / 10, a log every
500 steps. ``--latent_tokens`` is accepted and unused, as in the JAX entry
(the latents are the patches). The pixel loss is the true L1
(``pixel_loss="l1"``). ``--device`` (default ``cuda``) picks the card or,
with ``cpu``, the kernels' plain versions; ``--mixed false`` computes in
fp32 through the kernels' fp32 forms, with TF32 off.

The tokenizer loop (``train/loop.py``) logs to
``<run_dir>/vit-vqgan[-synthetic]/<run>.jsonl``, checkpoints "best" (with
``best_config.json``, which ``train_llamagen_titok --vq_ckpt`` reads) and
"last" under ``--ckpt_dir``, resumes with the stream position
(``--resume``) and saves "last" on SIGTERM. From the loop too:
``--quantizer fsq``, ``--ema_decay``, ``--watch`` and
``--perceptual_weights``/``--perceptual_quant``.

The data: ``--dataset imagenet`` (the default; ``--data_dir`` holds
``train/`` and ``val/`` class folders) or ``synthetic`` (the shapes
stream). Refused, each with a message naming its ROADMAP item:
``--attn_impl xla``, ``--scan_layers`` and ``--mesh``/``--pp_microbatches``.
``--no_wandb`` is accepted; the port logs to files only.

``build_parser``, ``check_ported`` and ``get_loader`` serve
``train_enhancing_vitvqgan`` too.
"""

from __future__ import annotations

import argparse

import torch

from vit_tpu_torch.data import decoders
from vit_tpu_torch.data.synthetic import SyntheticImageLoader
from vit_tpu_torch.data.video import _require_dir
from vit_tpu_torch.models.vit_vqgan import ViTVQGAN, ViTVQGANConfig
from vit_tpu_torch.train.loop import run_tokenizer_training
from vit_tpu_torch.utils.config import str2bool
from vit_tpu_torch.utils.precision import disable_tf32


def build_parser(description: str, *, warmup_steps: int, ckpt_dir: str,
                 quantizer: bool) -> argparse.ArgumentParser:
    """The ViT-VQGAN entries' flags (``train_vit_vqgan.py:23-85``,
    ``train_enhancing_vitvqgan.py:21-77``), which differ in the warmup,
    the checkpoint directory and ``--quantizer``."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--image_size", type=int, default=128)
    parser.add_argument("--patch_size", type=int, default=16)
    parser.add_argument("--latent_tokens", type=int, default=256,
                        help="accepted and unused: one latent a patch")
    parser.add_argument("--codebook_size", type=int, default=2048)
    parser.add_argument("--latent_dim", type=int, default=12)
    parser.add_argument("--transformer", type=str, default="B")
    parser.add_argument("--bs", type=int, default=32)
    parser.add_argument("--mixed", type=str2bool, default=True)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--weight_decay", type=float, default=1e-4)
    parser.add_argument("--warmup_steps", type=int, default=warmup_steps)
    parser.add_argument("--train_steps", type=int, default=500_000)
    parser.add_argument("--dataset", type=str, default="imagenet",
                        choices=["imagenet", "synthetic"])
    parser.add_argument("--epochs", type=int, default=100000)
    parser.add_argument("--data_dir", type=str, default=None)
    parser.add_argument("--steps_per_epoch", type=int, default=100)
    parser.add_argument("--max_epoch_steps", type=int, default=0,
                        help="cap batches per epoch (0 = the whole epoch)")
    parser.add_argument("--perceptual_weights", type=str, default=None,
                        help='"random" or a converted ConvNeXt-S .npz; '
                             "omit to disable the term")
    parser.add_argument("--perceptual_quant", type=str, default=None,
                        choices=[None, "int8"])
    parser.add_argument("--perceptual_weight", type=float, default=1.0)
    if quantizer:
        parser.add_argument("--quantizer", type=str, default="vq",
                            choices=["vq", "fsq"])
    parser.add_argument("--attn_impl", type=str, default=None,
                        choices=[None, "pallas", "xla"])
    parser.add_argument("--scan_layers", type=str2bool, default=False)
    parser.add_argument("--ckpt_dir", type=str, default=ckpt_dir)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--ema_decay", type=float, default=0.0)
    parser.add_argument("--log_every", type=int, default=500)
    parser.add_argument("--ckpt_every", type=int, default=250,
                        help="min steps between checkpoint saves")
    parser.add_argument("--image_every", type=int, default=5000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--no_wandb", action="store_true")
    parser.add_argument("--run_dir", type=str, default=None,
                        help="metrics and image root (default: "
                             "$VIT_TPU_RUN_DIR or runs/)")
    parser.add_argument("--watch", action="store_true")
    parser.add_argument("--mesh", type=str, default=None)
    parser.add_argument("--pp_microbatches", type=int, default=0)
    # the port's own
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the kernels) or cpu (their plain "
                             "versions)")
    return parser


def parse_args(argv=None) -> argparse.Namespace:
    args = build_parser(__doc__.split("\n")[0], warmup_steps=5000,
                        ckpt_dir="titok_models/vit_vqgan",
                        quantizer=True).parse_args(argv)
    args.min_lr = args.lr / 10.0
    return args


def check_ported(args: argparse.Namespace) -> None:
    """Raise on every flag whose path the port does not have, on a
    dataset whose package this machine lacks and on a dataset whose
    --data_dir is not given or not a directory."""
    missing = decoders.missing(args.dataset)
    refused = [
        (args.attn_impl == "xla",
         "--attn_impl xla: the port's attention is its kernels (ROADMAP "
         "Queue A #10, no port needed)"),
        (args.scan_layers,
         "--scan_layers: the port runs the unrolled stack (ROADMAP Queue A "
         "#10, no port needed)"),
        (args.mesh is not None or args.pp_microbatches,
         "--mesh/--pp_microbatches: the port trains on one GPU (ROADMAP "
         "Queue A #9, multi-GPU)"),
        (bool(missing), missing),
    ]
    for bad, why in refused:
        if bad:
            raise NotImplementedError(why)
    if args.dataset != "synthetic":
        _require_dir(args.data_dir, f"--dataset {args.dataset}")


def get_loader(args):
    """The training stream of ``--dataset``, one process's."""
    if args.dataset == "synthetic":
        return SyntheticImageLoader(args.image_size, args.bs,
                                    steps_per_epoch=args.steps_per_epoch,
                                    seed=args.seed, mode="shapes")
    from vit_tpu_torch.data.imagenet import get_imagenet_loaders

    print(f"DECODER: {decoders.jpeg_decoder()}", flush=True)
    return get_imagenet_loaders(args.image_size, args.bs,
                                data_dir=args.data_dir)[0]


def setup_device(args: argparse.Namespace, entry: str) -> torch.dtype:
    """Check the card is there (unless ``--device cpu``), keep TF32 off for
    ``--mixed false`` on it; returns the compute dtype."""
    if torch.device(args.device).type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"{entry}: no CUDA device (pass --device cpu "
                             "for the plain versions)")
        if not args.mixed:
            disable_tf32()
    return torch.bfloat16 if args.mixed else torch.float32


def main(argv=None):
    """Train as the flags say; returns the final train state."""
    args = parse_args(argv)
    check_ported(args)
    dtype = setup_device(args, "train_vit_vqgan")
    config = ViTVQGANConfig(args.image_size, args.patch_size,
                            args.codebook_size, args.latent_dim,
                            args.transformer, dtype=dtype,
                            quantizer=args.quantizer)
    project_name = ("vit-vqgan" if args.dataset == "imagenet"
                    else "vit-vqgan-synthetic")
    run_name = (f"{args.patch_size}px_{args.image_size}px_{args.transformer}_"
                f"{config.latent_tokens}_{args.codebook_size}")
    return run_tokenizer_training(
        args, ViTVQGAN(config), config, get_loader(args),
        project_name=project_name, run_name=run_name,
        codebook_size=config.codebook_size,
        pixel_loss="l1")  # the reference's abs().mean() (train_vit_vqgan.py:152)


if __name__ == "__main__":
    main()
