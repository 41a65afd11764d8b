"""LlamaGen-TiTok training on one GPU (the port's counterpart of
``train_llamagen_titok.py``): TiTok compression of a frozen VQGAN's code
sequences, trained with cross-entropy.

    python -m vit_tpu_torch.train_llamagen_titok --dataset synthetic \\
        --no_wandb [--vq_ckpt <dir or .pt>] [--device cpu]

It takes ``train_llamagen_titok.py``'s flags with the same defaults:
LlamaGen-TiTok-S over 256 codes of a 16384 vocabulary, 256 latent tokens,
codebook 16384 × 12, bs 32, bf16 compute (``--mixed``), AdamW at lr 1e-4,
weight decay 1e-4, clip 1.0, 5,000 warmup steps into a cosine over
1,000,000 to lr / 10. ``--micro_steps k`` accumulates k micro-steps into
one update (``train/optim.py:MultiSteps``, the gradients' mean).

The codes come from one of three sources:
  - no ``--vq_ckpt`` (``--dataset synthetic`` only): random codes, a batch
    of bs / micro_steps drawn from ``(seed, epoch)``;
  - ``--vq_ckpt <dir>``: the "best" checkpoint that ``train_vit_vqgan``
    wrote, its config read from ``best_config.json``; each batch of images
    (synthetic at its image size, or ImageNet) is encoded on the device;
  - ``--vq_ckpt <file.pt>``: a LlamaGen ``{"model": state_dict}`` file
    (``models/llamagen_vq.py:load_llamagen_vq``), fp32 with TF32 off on the
    card, over images of 256.
With a VQ, the image stream's batch is bs whatever ``--micro_steps`` says,
as in the JAX entry (ROADMAP Queue C #11).

The loop (``train_llamagen_titok.py:246-330``): every ``--log_every``
micro-steps it logs to ``<run_dir>/titok-CE-<dataset>/<run>.jsonl`` and
prints ``e=.. s=.. loss=.. recon=.. usage=.. step_time=..``; at each such
step whose recon loss improves it saves "best" and "last" under
``--ckpt_dir`` with the stream position. Every ``--image_every`` steps,
when there is a VQ, it decodes the first four true and predicted code
sequences through it, logs both and resets the usage bitmap (which
therefore never resets without a VQ: ROADMAP Queue C #12). SIGTERM saves
"last" and exits 0; ``--resume`` continues from it with the stream.

As in the JAX entry, ``--perceptual_weight`` (ROADMAP Queue C #13) and
``--ckpt_every`` are parsed and not used. Refused, each with a message
naming its ROADMAP item: ``--attn_impl xla``, ``--scan_layers``,
``--mesh``/``--pp_microbatches``, a real dataset without ``--vq_ckpt`` (the
JAX entry's assertion), and what the JAX entry would fail on later
(ROADMAP Queue C #10): ``--dataset imagenet`` with a ViT-VQGAN whose image
size is not 256, an FSQ ViT-VQGAN, and a VQ whose code count or codebook
does not fit ``--vq_latent_tokens`` and ``--vq_codebook_size``.
``--no_wandb`` is accepted; the port logs to files only.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from vit_tpu_torch.data import decoders
from vit_tpu_torch.data.synthetic import SyntheticImageLoader
from vit_tpu_torch.data.video import _require_dir
from vit_tpu_torch.models.llamagen_titok import (LlamaGenTiTok,
                                                 LlamaGenTiTokConfig)
from vit_tpu_torch.train.checkpoint import Checkpointer
from vit_tpu_torch.train.loop import (image_batches, log_metrics,
                                      resume_position)
from vit_tpu_torch.train.optim import MultiSteps, make_optimizer
from vit_tpu_torch.train.preempt import GracefulShutdown
from vit_tpu_torch.train.state import TrainState, params_str
from vit_tpu_torch.train.step import make_llamagen_titok_train_step
from vit_tpu_torch.utils.config import str2bool
from vit_tpu_torch.utils.init import init_llamagen_titok_
from vit_tpu_torch.utils.logging import MetricsLogger
from vit_tpu_torch.utils.precision import disable_tf32

LLAMAGEN_IMAGE = 256   # LlamaGen's c2i input size (train_llamagen_titok.py:132)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    # train_llamagen_titok.py's flags, with its defaults
    parser.add_argument("--vq_codebook_size", type=int, default=16384)
    parser.add_argument("--vq_latent_tokens", type=int, default=256)
    parser.add_argument("--latent_tokens", type=int, default=256)
    parser.add_argument("--codebook_size", type=int, default=16384)
    parser.add_argument("--latent_dim", type=int, default=12)
    parser.add_argument("--transformer", type=str, default="S")
    parser.add_argument("--bs", type=int, default=32)
    parser.add_argument("--micro_steps", type=int, default=1)
    parser.add_argument("--mixed", type=str2bool, default=True)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--perceptual_weight", type=float, default=1.0,
                        help="parsed and not used, as in "
                             "train_llamagen_titok.py (a CE loss)")
    parser.add_argument("--weight_decay", type=float, default=1e-4)
    parser.add_argument("--warmup_steps", type=int, default=5000)
    parser.add_argument("--train_steps", type=int, default=1_000_000)
    parser.add_argument("--dataset", type=str, default="imagenet",
                        choices=["imagenet", "synthetic"])
    parser.add_argument("--epochs", type=int, default=100000)
    parser.add_argument("--data_dir", type=str, default=None)
    parser.add_argument("--vq_ckpt", type=str, default=None,
                        help="the frozen code source: a train_vit_vqgan "
                             "checkpoint directory or a LlamaGen .pt; omit "
                             "with --dataset synthetic for random codes")
    parser.add_argument("--steps_per_epoch", type=int, default=100)
    parser.add_argument("--attn_impl", type=str, default=None,
                        choices=[None, "pallas", "xla"])
    parser.add_argument("--scan_layers", type=str2bool, default=False)
    parser.add_argument("--ckpt_dir", type=str,
                        default="titok_models/llamagen")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--log_every", type=int, default=100)
    parser.add_argument("--ckpt_every", type=int, default=250,
                        help="parsed and not used, as in "
                             "train_llamagen_titok.py")
    parser.add_argument("--image_every", type=int, default=5000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--no_wandb", action="store_true")
    parser.add_argument("--run_dir", type=str, default=None,
                        help="metrics and image root (default: "
                             "$VIT_TPU_RUN_DIR or runs/)")
    parser.add_argument("--mesh", type=str, default=None)
    parser.add_argument("--pp_microbatches", type=int, default=0)
    # the port's own
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the kernels) or cpu (their plain "
                             "versions)")
    args = parser.parse_args(argv)
    args.min_lr = args.lr / 10.0
    return args


def check_ported(args: argparse.Namespace) -> None:
    """Raise on every flag whose path the port does not have, on what the
    JAX entry asserts, on a dataset whose package this machine lacks and
    on a dataset whose --data_dir is not given or not a directory."""
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
        (args.dataset != "synthetic" and not args.vq_ckpt,
         f"--dataset {args.dataset} needs --vq_ckpt, the frozen code source "
         "(train_llamagen_titok.py:150)"),
        (bool(args.vq_ckpt) and bool(decoders.missing(args.dataset)),
         decoders.missing(args.dataset)),
    ]
    for bad, why in refused:
        if bad:
            raise NotImplementedError(why)
    if args.dataset != "synthetic":
        _require_dir(args.data_dir, f"--dataset {args.dataset}")


class SyntheticCodes:
    """Random code batches of bs / micro_steps, drawn from ``(seed,
    epoch)`` (``train_llamagen_titok.py:152-168``), resumable through
    ``data/resume.py`` like every loader."""

    def __init__(self, args: argparse.Namespace):
        self.args = args
        self._epoch = 0

    def __iter__(self):
        a = self.args
        rng = np.random.default_rng((a.seed, self._epoch))
        self._epoch += 1
        for _ in range(a.steps_per_epoch):
            yield rng.integers(0, a.vq_codebook_size,
                               (a.bs // a.micro_steps, a.vq_latent_tokens),
                               dtype=np.int32), None


def load_vit_vqgan(directory: Path):
    """The "best" ViT-VQGAN of a ``train_vit_vqgan`` checkpoint directory,
    in its config's compute dtype."""
    from vit_tpu_torch.models.vit_vqgan import ViTVQGAN, ViTVQGANConfig
    from vit_tpu_torch.train.checkpoint import load_params
    from vit_tpu_torch.utils.config import dataclass_from_dict

    cfg = dataclass_from_dict(ViTVQGANConfig, json.loads(
        (directory / "best_config.json").read_text()))
    if cfg.quantizer == "fsq":
        raise NotImplementedError(
            f"--vq_ckpt {directory}: an FSQ ViT-VQGAN's codes range over "
            "prod(fsq_levels) and it has no index lookup to decode them "
            "(ROADMAP Queue C #10)")
    model = ViTVQGAN(cfg, device="meta")
    model.load_state_dict(load_params(str(directory), "best"), assign=True)
    return model


def frozen_vq(args: argparse.Namespace, device: torch.device):
    """``--vq_ckpt`` → (the frozen VQ on ``device`` in eval mode, its image
    size). Refuses a VQ whose codes the model cannot take, and ImageNet
    with a ViT-VQGAN that does not take its 256 px."""
    path = Path(args.vq_ckpt)
    if path.is_file():
        from vit_tpu_torch.models.llamagen_vq import load_llamagen_vq

        if device.type == "cuda":
            disable_tf32()   # fp32 convolutions: TF32 would move the codes
        vq = load_llamagen_vq(str(path))
        cfg = vq.config
        image_size = LLAMAGEN_IMAGE
        n_codes = (image_size // cfg.downsample_factor) ** 2
        n_embed = cfg.n_embed
    else:
        if args.dataset == "imagenet":
            cfg = json.loads((path / "best_config.json").read_text())
            if cfg["image_size"] != LLAMAGEN_IMAGE:
                raise NotImplementedError(
                    f"--dataset imagenet with --vq_ckpt {path}: the JAX "
                    f"entry loads ImageNet at {LLAMAGEN_IMAGE} px whatever "
                    f"the tokenizer takes, and this ViT-VQGAN takes "
                    f"{cfg['image_size']} px (ROADMAP Queue C #10)")
        vq = load_vit_vqgan(path)
        cfg = vq.config
        image_size, n_codes, n_embed = (cfg.image_size, cfg.latent_tokens,
                                        cfg.codebook_size)
    if n_codes != args.vq_latent_tokens or n_embed > args.vq_codebook_size:
        raise NotImplementedError(
            f"--vq_ckpt {path} gives {n_codes} codes of {n_embed}, which "
            f"--vq_latent_tokens {args.vq_latent_tokens} and "
            f"--vq_codebook_size {args.vq_codebook_size} must hold (the JAX "
            f"entry fails inside its step; ROADMAP Queue C #10)")
    return vq.to(device).eval().requires_grad_(False), image_size


def get_loader(args: argparse.Namespace, image_size: "int | None"):
    """The stream: code batches without a VQ, else image batches of bs at
    the VQ's image size (``train_llamagen_titok.py:81-168``)."""
    if args.vq_ckpt is None:
        return SyntheticCodes(args)
    if args.dataset == "synthetic":
        return SyntheticImageLoader(image_size, args.bs,
                                    steps_per_epoch=args.steps_per_epoch,
                                    seed=args.seed, mode="shapes")
    from vit_tpu_torch.data.imagenet import get_imagenet_loaders

    print(f"DECODER: {decoders.jpeg_decoder()}", flush=True)
    return get_imagenet_loaders(LLAMAGEN_IMAGE, args.bs,
                                data_dir=args.data_dir)[0]


def main(argv=None) -> TrainState:
    """Train as the flags say; returns the final train state."""
    args = parse_args(argv)
    check_ported(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_llamagen_titok: no CUDA device (pass "
                         "--device cpu for the plain versions)")
    if not args.mixed and device.type == "cuda":
        disable_tf32()
    vq, image_size = (frozen_vq(args, device) if args.vq_ckpt
                      else (None, None))
    if vq is not None and args.micro_steps > 1:
        print(f"WARNING: --micro_steps {args.micro_steps} with --vq_ckpt: "
              f"each micro-step takes a whole batch of {args.bs} images, as "
              f"in train_llamagen_titok.py (ROADMAP Queue C #11)", flush=True)
    dtype = torch.bfloat16 if args.mixed else torch.float32
    config = LlamaGenTiTokConfig(args.vq_codebook_size, args.vq_latent_tokens,
                                 args.latent_tokens, args.codebook_size,
                                 args.latent_dim, args.transformer,
                                 dtype=dtype)
    logger = MetricsLogger(
        f"titok-CE-{args.dataset}",
        f"{args.vq_codebook_size}_{args.vq_latent_tokens}vq_"
        f"{args.transformer}_{args.latent_tokens}_{args.codebook_size}ce_vq",
        config=vars(args), out_dir=args.run_dir, device=device)
    train_loader = get_loader(args, image_size)

    model = LlamaGenTiTok(config)
    init_llamagen_titok_(model, torch.Generator().manual_seed(args.seed))
    model.to(device).train().requires_grad_(True)
    tx = make_optimizer(args.lr, args.warmup_steps, args.train_steps,
                        args.min_lr, args.weight_decay, clip_norm=1.0)
    if args.micro_steps > 1:
        tx = MultiSteps(tx, args.micro_steps)
    state = TrainState.create(model, tx)

    ckpt = Checkpointer(args.ckpt_dir, mode="min")
    start_epoch, skip0, step0 = 0, 0, 0
    if args.resume:
        start_epoch, skip0, step0 = resume_position(ckpt, state, train_loader)
    train_step = make_llamagen_titok_train_step(model)
    print(f"STATS: enc_params={params_str(state.params)}", flush=True)

    def save_last(epoch: int, next_batch: int, consumed: int) -> None:
        ckpt.save(state, config=config, tag="last")
        ckpt.save_data_state(int(state.step), {
            "epoch": epoch, "next_batch": next_batch, "consumed": consumed})

    shutdown = GracefulShutdown.install()
    best_recon = float("inf")
    usage = torch.zeros((config.codebook_size,), dtype=torch.float32,
                        device=device)
    step = step0
    prev_loss = None
    for epoch, i, batch, st, load_time in image_batches(
            train_loader, device, start_epoch, skip0, args.epochs):
        if vq is not None:
            with torch.no_grad():
                codes = vq.encode(batch)
        else:
            codes = batch
        is_log = step % args.log_every == 0
        rebased = is_log and prev_loss is not None
        if rebased:
            # wait for the queued steps before the clock starts
            prev_loss.item()
            st = time.time()
        state, usage, metrics, _ = train_step(state, codes, usage)
        prev_loss = metrics["train/loss"]
        if is_log:
            host, step_now = log_metrics(logger, metrics, state)
            step_time = time.time() - st - (0.0 if rebased else load_time)
            host.update({"train/epoch": epoch,
                         "benchmark/load_time": load_time,
                         "benchmark/step_time": step_time})
            logger.log(host, step=step_now)
            print(f"e={epoch} s={step} loss={host['train/loss']:.3f} "
                  f"recon={host['train/recon_loss']:.3f} "
                  f"usage={host['train/codebook_usage']:.3f} "
                  f"step_time={step_time:.3f}", flush=True)
            if host["train/recon_loss"] < best_recon:
                best_recon = host["train/recon_loss"]
                ckpt.save_if_best(state, best_recon, config=config)
                save_last(epoch, i + 1, step + 1)
        if step % args.image_every == 0 and vq is not None:
            with torch.no_grad():
                pred = model(codes[:4])[0].argmax(-1)
                logger.log_images(
                    {"reconstructions": vq.decode_indices(codes[:4])
                     .float().cpu().numpy(),
                     "ce_reconstructions": vq.decode_indices(pred)
                     .float().cpu().numpy()},
                    step=int(state.step))
            usage.zero_()
        step += 1
        if shutdown.requested:
            # SIGTERM: save the exact step and return, so --resume
            # continues from here
            print(f"PREEMPTED: saving 'last' at step {int(state.step)} "
                  "and exiting", flush=True)
            save_last(epoch, i + 1, step)
            break
    else:
        save_last(args.epochs, 0, step)
    ckpt.finalize()
    logger.close()
    shutdown.uninstall()
    return state


if __name__ == "__main__":
    main()
