"""Tokenizer CLI: images ↔ codes with a trained checkpoint (counterpart of
``tokenize_images.py``).

  # encode a folder of images to a .npz of code indices
  python -m vit_tpu_torch.tokenize_images encode --ckpt titok_models \\
      --model titok --images "imgs/*.png" --out codes.npz

  # decode codes back to PNGs
  python -m vit_tpu_torch.tokenize_images decode --ckpt titok_models \\
      --model titok --codes codes.npz --out_dir recon/

Encode resizes each image with PIL's BILINEAR filter to the config's size
and divides by 255 in numpy on the host, then encodes ``--bs`` images a
call on ``--device`` (the card by default); the ``.npz`` holds ``codes``
and the sorted ``paths``. Decode clips to [0, 1] and writes ``(img *
255).astype(uint8)`` (truncation, not rounding) as ``{i:06d}.png``. The
checkpoint is read by ``eval_recon.load_model``.
"""

from __future__ import annotations

import argparse
import glob
from pathlib import Path

import numpy as np
import torch

from vit_tpu_torch.eval_recon import MODELS, load_model


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("mode", choices=["encode", "decode"])
    parser.add_argument("--ckpt", type=str, required=True)
    parser.add_argument("--model", type=str, default="titok", choices=MODELS)
    parser.add_argument("--tag", type=str, default="best")
    parser.add_argument("--images", type=str, default=None)
    parser.add_argument("--codes", type=str, default=None)
    parser.add_argument("--out", type=str, default="codes.npz")
    parser.add_argument("--out_dir", type=str, default="decoded")
    parser.add_argument("--bs", type=int, default=16)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device the model runs on")
    return parser


def read_images(paths, size: int) -> np.ndarray:
    """(N, size, size, 3) float32 in [0, 1]: each image converted to RGB,
    resized with PIL's BILINEAR filter and divided by 255 on the host."""
    from PIL import Image

    batch = []
    for p in paths:
        img = Image.open(p).convert("RGB").resize((size, size),
                                                  Image.BILINEAR)
        batch.append(np.asarray(img, np.float32) / 255.0)
    return np.stack(batch)


@torch.inference_mode()
def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    model, cfg = load_model(args)

    if args.mode == "encode":
        paths = sorted(glob.glob(args.images))
        if not paths:
            raise FileNotFoundError(f"no images match {args.images}")
        if args.model == "tatitok":
            def enc(x):
                return model.encode(x)[1]["min_encoding_indices"]
        else:
            enc = model.encode
        all_codes = []
        for i in range(0, len(paths), args.bs):
            x = read_images(paths[i:i + args.bs], cfg.image_size)
            all_codes.append(enc(torch.from_numpy(x).to(device)).cpu()
                             .numpy())
        codes = np.concatenate(all_codes)
        np.savez(args.out, codes=codes, paths=np.asarray(paths))
        print(f"encoded {len(paths)} images -> {args.out} "
              f"(codes shape {codes.shape})")
    else:
        codes = np.load(args.codes, allow_pickle=True)["codes"]
        dec = (model.decode_tokens if args.model == "tatitok"
               else model.decode_indices)
        out_dir = Path(args.out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        from PIL import Image

        for i in range(0, len(codes), args.bs):
            idx = torch.from_numpy(codes[i:i + args.bs]).to(device)
            imgs = dec(idx).float().clamp(0.0, 1.0).cpu().numpy()
            for j, img in enumerate(imgs):
                Image.fromarray((img * 255).astype(np.uint8)).save(
                    out_dir / f"{i + j:06d}.png")
        print(f"decoded {len(codes)} code sequences -> {out_dir}/")


if __name__ == "__main__":
    main()
