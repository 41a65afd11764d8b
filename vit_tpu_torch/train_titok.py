"""TiTok 1-D tokenizer training on one GPU (the port's counterpart of
``train_titok.py``), the flagship workload.

    python -m vit_tpu_torch.train_titok --dataset synthetic --no_wandb \\
        [--perceptual_weights random] [--device cpu]

It takes ``train_titok.py``'s flags with the same defaults: TiTok-B at image
128, patch 16, 256 latent tokens, codebook 2048 × 12, bs 32, bf16 compute
(``--mixed``), AdamW at lr 1e-4 (bf16 first moment, ``--adam_mu_dtype``),
weight decay 1e-4, clip 1.0, 5,000 warmup steps into a cosine over 1,000,000
to lr / 10. ``--device`` (default ``cuda``) picks the card or, with
``cpu``, the kernels' plain versions; ``--mixed false`` computes in fp32
through the kernels' fp32 forms, with TF32 off in cuBLAS and cuDNN.

The loop (``train/loop.py``) logs to ``<run_dir>/titok-synthetic/<run>.jsonl``,
checkpoints "best" and "last" under ``--ckpt_dir``, resumes with the stream
position (``--resume``) and saves "last" on SIGTERM.

The data: ``--dataset imagenet`` (the default; ``--data_dir`` holds
``train/`` and ``val/`` class folders, decoded by the native libjpeg
pipeline when it builds, else by Pillow, as the entry prints), ``dmlab``
(``.npz`` clips at image 64, eight random frames of each of bs / 8 clips a
batch), ``minecraft`` (``.mp4`` through OpenCV, image 128) and
``synthetic`` (the shapes stream); ``--loader_backend grain`` with
``--loader_processes`` reads ImageNet through Grain. A dataset or backend
whose package this machine lacks is refused before the first batch, with a
message naming the package.

Ported too: both quantizers
(``--quantizer vq|fsq``; FSQ at 8 levels a latent channel, its usage bitmap
still ``--codebook_size`` long, as in ``train_titok.py``), the perceptual
loss (``--perceptual_weights random|<.npz>``, ``--perceptual_quant int8``),
``--ema_decay`` (the weight average, saved in each checkpoint), ``--watch``
(gradient and parameter histograms on log steps, to the TensorBoard sink),
``--n_layers``, ``--max_epoch_steps`` and ``--profile_dir`` (a
``torch.profiler`` Chrome trace of steps 10-15). Every other path is
refused with a message naming its ROADMAP item.
``--no_wandb`` is accepted; the port logs to files only.
"""

from __future__ import annotations

import argparse

import torch

from vit_tpu_torch.data import decoders
from vit_tpu_torch.data.synthetic import SyntheticImageLoader
from vit_tpu_torch.data.video import _require_dir
from vit_tpu_torch.models.titok import TiTok, TiTokConfig
from vit_tpu_torch.train.loop import run_tokenizer_training
from vit_tpu_torch.utils.config import str2bool
from vit_tpu_torch.utils.precision import disable_tf32


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    # train_titok.py's flags, with its defaults
    parser.add_argument("--image_size", type=int, default=128)
    parser.add_argument("--patch_size", type=int, default=16)
    parser.add_argument("--latent_tokens", type=int, default=256)
    parser.add_argument("--codebook_size", type=int, default=2048)
    parser.add_argument("--latent_dim", type=int, default=12)
    parser.add_argument("--transformer", type=str, default="B")
    parser.add_argument("--bs", type=int, default=32)
    parser.add_argument("--mixed", type=str2bool, default=True)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--perceptual_weight", type=float, default=1.0)
    parser.add_argument("--weight_decay", type=float, default=1e-4)
    parser.add_argument("--warmup_steps", type=int, default=5000)
    parser.add_argument("--train_steps", type=int, default=1_000_000)
    parser.add_argument("--dataset", type=str, default="imagenet",
                        choices=["imagenet", "dmlab", "minecraft",
                                 "synthetic"])
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
    parser.add_argument("--quantizer", type=str, default="vq",
                        choices=["vq", "fsq"])
    parser.add_argument("--attn_impl", type=str, default=None,
                        choices=[None, "pallas", "xla"])
    parser.add_argument("--scan_layers", type=str2bool, default=False)
    parser.add_argument("--n_layers", type=int, default=None,
                        help="encoder and decoder depth (None = the preset's)")
    parser.add_argument("--ckpt_dir", type=str, default="titok_models")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--ema_decay", type=float, default=0.0)
    parser.add_argument("--log_every", type=int, default=100)
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
    parser.add_argument("--loader_backend", type=str, default="threads",
                        choices=["threads", "grain"])
    parser.add_argument("--loader_processes", type=int, default=0)
    parser.add_argument("--adam_mu_dtype", type=str, default="bfloat16",
                        choices=[None, "float32", "bfloat16"])
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler trace of steps 10-15 "
                             "here")
    # the port's own
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the kernels) or cpu (their plain "
                             "versions)")
    args = parser.parse_args(argv)
    args.min_lr = args.lr / 10.0  # reference train_titok.py:114
    return args


def check_ported(args: argparse.Namespace) -> None:
    """Raise on every flag whose path the port does not have yet, on a
    dataset or backend whose package this machine lacks, and on a dataset
    whose --data_dir is not given or not a directory."""
    missing = decoders.missing(args.dataset, backend=args.loader_backend)
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
    """The training stream of ``--dataset`` (``train_titok.py:get_loader``),
    one process's: shard 0 of 1."""
    if args.dataset == "synthetic":
        return SyntheticImageLoader(args.image_size, args.bs,
                                    steps_per_epoch=args.steps_per_epoch,
                                    seed=args.seed, mode="shapes")
    if args.dataset == "imagenet":
        from vit_tpu_torch.data.imagenet import get_imagenet_loaders

        print(f"DECODER: {decoders.jpeg_decoder()}", flush=True)
        return get_imagenet_loaders(args.image_size, args.bs,
                                    data_dir=args.data_dir,
                                    backend=args.loader_backend,
                                    processes=args.loader_processes,
                                    shard_id=0, num_shards=1)[0]
    if args.dataset == "dmlab":
        assert args.image_size == 64  # reference train_titok.py:120
        from vit_tpu_torch.data.video import get_dmlab_image_loaders

        return get_dmlab_image_loaders(args.bs, dataset_path=args.data_dir,
                                       shard_id=0, num_shards=1)[0]
    assert args.image_size == 128  # reference train_titok.py:124
    from vit_tpu_torch.data.video import get_minecraft_image_loaders

    print("DECODER: OpenCV", flush=True)
    return get_minecraft_image_loaders(args.bs, dataset_path=args.data_dir,
                                       shard_id=0, num_shards=1)[0]


def main(argv=None):
    """Train as the flags say; returns the final train state."""
    args = parse_args(argv)
    check_ported(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_titok: no CUDA device (pass --device cpu "
                         "for the plain versions)")
    if not args.mixed and device.type == "cuda":
        disable_tf32()
    dtype = torch.bfloat16 if args.mixed else torch.float32
    titok_config = TiTokConfig(args.image_size, args.patch_size,
                               args.latent_tokens, args.codebook_size,
                               args.latent_dim, args.transformer, dtype=dtype,
                               quantizer=args.quantizer)
    if args.n_layers is not None:
        for name in ("enc_vit_config", "dec_vit_config"):
            sub = getattr(titok_config, name)
            sub.trans_config = sub.trans_config.replace(n_layers=args.n_layers)

    project_name = {"imagenet": "titok", "dmlab": "titok-dmlab",
                    "minecraft": "titok-minecraft",
                    "synthetic": "titok-synthetic"}[args.dataset]
    run_name = (f"{args.patch_size}px_{args.image_size}px_{args.transformer}_"
                f"{args.latent_tokens}_{args.codebook_size}")
    return run_tokenizer_training(
        args, TiTok(titok_config), titok_config, get_loader(args),
        project_name=project_name, run_name=run_name,
        codebook_size=titok_config.codebook_size,
        pixel_loss="l2")  # the reference's squared error (train_titok.py:155)


if __name__ == "__main__":
    main()
