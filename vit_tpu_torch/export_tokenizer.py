"""Export a trained checkpoint for serving (counterpart of
``scripts/export_tokenizer.py``; see ``vit_tpu_torch/serve/export.py``).

Tokenizers (encode/decode):
  python -m vit_tpu_torch.export_tokenizer --ckpt titok_models \\
      --out exported/titok --bs 8 [--quantize int8]
  (--model titok | vit_vqgan | enhancing | tatitok | llamagen_titok)

Classifier (predict) / AR prior (generate):
  python -m vit_tpu_torch.export_tokenizer --model vit_classifier \\
      --ckpt ckpt/vit --out exported/vit
  python -m vit_tpu_torch.export_tokenizer --model videogpt --ckpt ... \\
      --out ... --cond_frames 8 --gen_frames 8

Serve the result:  python -m vit_tpu_torch.serve.server --dir exported/titok

The model is built on ``--device`` (the card by default; ``cpu`` on a host
without one). ``--platforms`` and ``--attn_impl`` are recorded in the
manifest; the port's attention is its kernels whatever they say. ``--dp``
above 1 and ``--dp_host_cpu`` are refused (ROADMAP Queue A #9).
"""

from __future__ import annotations

import argparse

from vit_tpu_torch.serve.export import (TOKENIZERS, export_classifier,
                                        export_tokenizer, export_videogpt)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--model", default="titok",
                    choices=[*TOKENIZERS, "vit_classifier", "videogpt"])
    ap.add_argument("--bs", type=int, default=1,
                    help="exported batch size, which the server pads "
                    "requests to; 0 = any batch, as it comes")
    ap.add_argument("--tag", default="best")
    ap.add_argument("--platforms", nargs="+", default=["cpu", "cuda"],
                    help="recorded in the manifest")
    ap.add_argument("--attn_impl", default="pallas",
                    choices=["xla", "pallas"],
                    help="recorded in the manifest; the port's attention "
                    "is its kernels")
    ap.add_argument("--cond_frames", type=int, default=8,
                    help="videogpt only: conditioning frames")
    ap.add_argument("--gen_frames", type=int, default=8,
                    help="videogpt only: frames to generate")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="videogpt only: 0 = greedy (reference); > 0 bakes "
                    "sampled decoding in (the call gains a seed input)")
    ap.add_argument("--top_k", type=int, default=None,
                    help="videogpt only: restrict sampling to the k best")
    ap.add_argument("--quantize", default=None, choices=["int8"],
                    help="int8: the transformer blocks' dense sites as int8 "
                    "products (~4x smaller weights; ~1%% per-product "
                    "quantization error)")
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel serving; not ported (ROADMAP Queue "
                    "A #9): only 1")
    ap.add_argument("--use_ema", action="store_true",
                    help="export the EMA weight average (checkpoints from "
                    "--ema_decay runs) instead of the live params")
    ap.add_argument("--dp_host_cpu", action="store_true",
                    help="not ported (ROADMAP Queue A #9)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the model is built and probed on")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.dp_host_cpu:
        raise NotImplementedError(
            "--dp_host_cpu: data-parallel export over virtual devices is "
            "not ported; the port serves on one GPU (ROADMAP Queue A #9, "
            "multi-GPU)")
    common = dict(bs=args.bs, tag=args.tag, platforms=tuple(args.platforms),
                  attn_impl=args.attn_impl, quantize=args.quantize,
                  dp=args.dp, use_ema=args.use_ema, device=args.device)
    if args.model in TOKENIZERS:
        out = export_tokenizer(args.ckpt, args.out, model=args.model, **common)
    elif args.model == "vit_classifier":
        out = export_classifier(args.ckpt, args.out, **common)
    else:
        out = export_videogpt(args.ckpt, args.out,
                              cond_frames=args.cond_frames,
                              gen_frames=args.gen_frames,
                              temperature=args.temperature,
                              top_k=args.top_k, **common)
    for p in sorted(out.iterdir()):
        print(f"{p}  ({p.stat().st_size} bytes)")
    return out


if __name__ == "__main__":
    main()
