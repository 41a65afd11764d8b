"""Enhancing ViT-VQGAN training on one GPU (the port's counterpart of
``train_enhancing_vitvqgan.py``).

    python -m vit_tpu_torch.train_enhancing_vitvqgan --dataset synthetic \\
        --no_wandb [--perceptual_weights random] [--device cpu]

It takes ``train_enhancing_vitvqgan.py``'s flags with the same defaults:
image 128, patch 16, codebook 2048 × 12, bs 32, 10,000 warmup steps into a
cosine over 500,000, a log every 500 steps, and the variant's fixed ViT-B
dims whatever ``--transformer`` says. The loss is the L1 pixel loss, plus
the perceptual and quantizer terms, on the tokenizer loop
(``train/loop.py``); weights start Xavier-uniform
(``utils/init.py:init_enhancing_``). The flags, refusals and data are
``train_vit_vqgan``'s, without ``--quantizer``.
"""

from __future__ import annotations

from vit_tpu_torch.models.enhancing_vqgan import (EnhancingViTVQGAN,
                                                  EnhancingVQGANConfig)
from vit_tpu_torch.train.loop import run_tokenizer_training
from vit_tpu_torch.train_vit_vqgan import (build_parser, check_ported,
                                           get_loader, setup_device)
from vit_tpu_torch.utils.init import init_enhancing_


def parse_args(argv=None):
    args = build_parser(__doc__.split("\n")[0], warmup_steps=10000,
                        ckpt_dir="titok_models/enhancing",
                        quantizer=False).parse_args(argv)
    args.min_lr = args.lr / 10.0
    return args


def main(argv=None):
    """Train as the flags say; returns the final train state."""
    args = parse_args(argv)
    check_ported(args)
    dtype = setup_device(args, "train_enhancing_vitvqgan")
    config = EnhancingVQGANConfig(args.image_size, args.patch_size,
                                  args.codebook_size, args.latent_dim,
                                  args.transformer, dtype=dtype)
    project_name = ("vit-vqgan" if args.dataset == "imagenet"
                    else "enhancing-vqgan-synthetic")
    run_name = (f"{args.patch_size}px_{args.image_size}px_{args.transformer}_"
                f"{args.latent_tokens}_{args.codebook_size}")
    return run_tokenizer_training(
        args, EnhancingViTVQGAN(config), config, get_loader(args),
        project_name=project_name, run_name=run_name,
        codebook_size=config.codebook_size, pixel_loss="l1",
        init=init_enhancing_)


if __name__ == "__main__":
    main()
