"""Reconstruction quality of a trained tokenizer checkpoint: PSNR, SSIM, the
perceptual distance, LPIPS and codebook usage (counterpart of
``eval_recon.py``).

Usage:
  python -m vit_tpu_torch.eval_recon --ckpt titok_models --model titok \\
      --dataset synthetic --bs 16
  python -m vit_tpu_torch.eval_recon --ckpt titok_models/vit_vqgan \\
      --model vit_vqgan --dataset imagenet --data_dir /path/to/imagenet

Prints one JSON line with the JAX tool's keys and rounding:
  {"psnr": ..., "codebook_usage": ..., "n": N, "ssim": ...,
   "perceptual": ..., "lpips": ...}
``ssim`` is null when the images are smaller than its 11 × 11 window;
``perceptual`` and ``lpips`` appear only with ``--perceptual_weights`` and
``--lpips_weights`` ("random" for an architecture-only smoke, or the JAX
package's ``.npz``).

The checkpoint is read as ``serve/export.py:_source`` reads it: the
``<tag>_config.json`` beside the ``<tag>`` weights, the EMA average under
``--use_ema``. The model runs on ``--device`` (the card by default), with
its kernels; the metrics run there in fp32 with TF32 off. Reconstructions
are clipped to [0, 1]; the perceptual loss compares them with the unclipped
input, LPIPS with the clipped one, as the JAX tool does.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from vit_tpu_torch.serve.export import _codec, _source

MODELS = ("titok", "vit_vqgan", "tatitok")
RANDOM_PERCEPTUAL_WARNING = (
    "=" * 78 + "\n"
    "WARNING: perceptual metric uses RANDOMLY INITIALIZED ConvNeXt weights.\n"
    "The number below is NOT comparable to LPIPS or to the reference's "
    "perceptual\nloss — convert real IMAGENET1K_V1 weights with "
    "scripts/convert_perceptual_weights.py\nand pass the .npz instead.\n"
    + "=" * 78)
RANDOM_LPIPS_WARNING = (
    "WARNING: lpips metric uses RANDOM weights — architecture smoke only, "
    "NOT comparable to published LPIPS numbers; convert real weights with "
    "scripts/convert_lpips_weights.py.")


def load_model(args):
    """(tokenizer in eval mode on ``args.device``, its config)."""
    model, cfg, _, _ = _source(args.ckpt, args.model, args.tag,
                               getattr(args, "use_ema", False),
                               torch.device(args.device))
    return model, cfg


def image_loader(args, image_size: int):
    """The evaluation batches of ``--dataset``: (images NHWC float32,
    labels)."""
    if args.dataset == "synthetic":
        from vit_tpu_torch.data.synthetic import SyntheticImageLoader

        # the mode must match what the tokenizer was trained on
        return SyntheticImageLoader(image_size, args.bs,
                                    steps_per_epoch=args.batches, seed=1,
                                    mode=args.synthetic_mode)
    if args.dataset == "imagenet":
        from vit_tpu_torch.data.imagenet import get_imagenet_loaders

        return get_imagenet_loaders(image_size, args.bs,
                                    data_dir=args.data_dir)[1]
    from vit_tpu_torch.data.video import (get_dmlab_image_loaders,
                                          get_minecraft_image_loaders)

    fn = (get_dmlab_image_loaders if args.dataset == "dmlab"
          else get_minecraft_image_loaders)
    return fn(args.bs, dataset_path=args.data_dir)[0]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ckpt", type=str, required=True)
    parser.add_argument("--model", type=str, default="titok", choices=MODELS)
    parser.add_argument("--tag", type=str, default="best")
    parser.add_argument("--use_ema", action="store_true",
                        help="eval the EMA weight average (--ema_decay runs)")
    parser.add_argument("--dataset", type=str, default="synthetic",
                        choices=["synthetic", "imagenet", "dmlab",
                                 "minecraft"])
    parser.add_argument("--data_dir", type=str, default=None)
    parser.add_argument("--bs", type=int, default=16)
    parser.add_argument("--batches", type=int, default=10)
    parser.add_argument("--synthetic_mode", type=str, default="shapes",
                        choices=["shapes", "noise"],
                        help="synthetic data mode (must match training; "
                             "train_titok --dataset synthetic uses 'shapes')")
    parser.add_argument("--perceptual_weights", type=str, default=None)
    parser.add_argument("--lpips_weights", type=str, default=None,
                        help='.npz from scripts/convert_lpips_weights.py '
                             '(or "random" for an architecture-only smoke); '
                             'adds an "lpips" field to the output')
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device the model and metrics run on")
    return parser


def build_metrics(args, device):
    """(perceptual loss or None, LPIPS closure or None) of
    ``--perceptual_weights`` and ``--lpips_weights`` on ``device``."""
    perceptual = None
    if args.perceptual_weights:
        from vit_tpu_torch.train.loop import build_perceptual

        if args.perceptual_weights == "random":
            print(RANDOM_PERCEPTUAL_WARNING, file=sys.stderr)
        perceptual = build_perceptual(args, torch.float32, device)
    lpips = None
    if args.lpips_weights:
        from vit_tpu_torch.losses import lpips as lpips_mod

        if args.lpips_weights == "random":
            print(RANDOM_LPIPS_WARNING, file=sys.stderr)
            lp_params = lpips_mod.init_params()
        else:
            lp_params = lpips_mod.load_params(args.lpips_weights)
        lpips = lpips_mod.lpips_fn(lp_params, device=device)
    return perceptual, lpips


@torch.inference_mode()
def batch_metrics(model, encode, x: torch.Tensor, perceptual=None,
                  lpips=None) -> dict:
    """One batch's numbers on the host: per-image ``psnr`` and ``ssim``
    (none below the 11 × 11 window), the batch's ``perceptual`` distance,
    per-image ``lpips`` and the ``codes``."""
    from vit_tpu_torch.utils.metrics import psnr, ssim

    x_clip = x.clamp(0.0, 1.0)
    recon = model(x)[0].clamp(0.0, 1.0)
    out = {"psnr": psnr(recon, x_clip).cpu().numpy()}
    if min(x.shape[1:3]) >= 11:   # SSIM's 11 × 11 VALID window
        out["ssim"] = ssim(recon, x_clip).cpu().numpy()
    if perceptual is not None:
        out["perceptual"] = float(perceptual(recon, x))
    if lpips is not None:
        out["lpips"] = lpips(recon, x_clip).cpu().numpy()
    out["codes"] = encode(x).cpu().numpy()
    return out


@torch.inference_mode()
def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        from vit_tpu_torch.utils.precision import disable_tf32

        disable_tf32()
    model, cfg = load_model(args)
    loader = image_loader(args, cfg.image_size)
    perceptual, lpips = build_metrics(args, device)

    encode = _codec(model, args.model)[0]
    psnrs, ssims, percs, lpipss, n = [], [], [], [], 0
    usage = np.zeros(cfg.codebook_size, np.float32)
    for i, (images, _) in enumerate(loader):
        if i >= args.batches:
            break
        x = torch.as_tensor(np.asarray(images, np.float32), device=device)
        got = batch_metrics(model, encode, x, perceptual, lpips)
        psnrs.append(got["psnr"])
        if "ssim" in got:
            ssims.append(got["ssim"])
        if perceptual is not None:
            percs.append(got["perceptual"])
        if lpips is not None:
            lpipss.append(got["lpips"])
        usage[got["codes"].reshape(-1)] = 1.0
        n += x.shape[0]

    out = {"psnr": round(float(np.concatenate(psnrs).mean()), 3),
           "codebook_usage": round(float(usage.mean()), 4), "n": n}
    if ssims:
        out["ssim"] = round(float(np.concatenate(ssims).mean()), 4)
    else:
        print("eval_recon: images smaller than the 11x11 SSIM window — "
              "emitting ssim: null", file=sys.stderr)
        out["ssim"] = None
    if percs:
        out["perceptual"] = round(float(np.mean(percs)), 5)
    if lpipss:
        out["lpips"] = round(float(np.concatenate(lpipss).mean()), 5)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
