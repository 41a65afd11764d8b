"""TATiTok training on one GPU (the port's counterpart of
``train_tatitok.py``): the Bytedance-blocks TiTok with its L2-normalised
vector quantizer.

    python -m vit_tpu_torch.train_tatitok --dataset synthetic --no_wandb \\
        [--perceptual_weights random] [--device cpu]

It takes ``train_tatitok.py``'s flags with the same defaults: TATiTok-S
(``--transformer small``: 8 layers, 8 heads, width 512), patch 16, 256
latent tokens, codebook 16384 × 12 with ``--use_l2_norm true``, bs 32, bf16
compute (``--mixed``), AdamW at lr 1e-4 (bf16 first moment), weight decay
1e-4 on the parameters ``wd_exclude_mask`` marks (none of the norms,
biases, embeddings, latent or mask tokens), clip 1.0, 10,000 warmup steps
into a cosine over 1,000,000 to lr / 10, perceptual weight 1.1. The image
size follows ``--dataset`` (imagenet 256, dmlab 64, minecraft 128,
synthetic 64) unless ``--image_size`` is given. ``--micro_steps k``
accumulates k batches of bs / k into one update (``train/optim.py:
MultiSteps``); ``--clustering_vq`` reseeds the codebook from the EMA of its
usage, whose statistics ride the checkpoints as their ``extra`` tree.
``--device`` (default ``cuda``) picks the card or, with ``cpu``, the
kernels' plain versions; ``--mixed false`` computes in fp32 through the
kernels' fp32 forms, with TF32 off.

The loop (``train_tatitok.py:255-355``, built from ``train/loop.py``'s
pieces): every ``--log_every`` micro-steps it logs to
``<run_dir>/titok-single-<dataset>/<run>.jsonl`` and prints ``e=.. s=..
loss=.. recon=.. quant=.. usage=.. step_time=..``; at each such step whose
recon loss improves it saves "best" and "last" under ``--ckpt_dir`` with
the stream position; every ``--image_every`` steps it logs the inputs and
reconstructions and resets the usage bitmap. SIGTERM saves "last" and
exits 0; ``--resume`` continues from it, stream and clustering statistics
included. ``--watch`` adds gradient and parameter histograms on log steps.

As in the JAX entry, ``--ema_decay`` and ``--ckpt_every`` are parsed and
not used (a warning says so for ``--ema_decay``; ROADMAP Queue C #9).
Refused, each with a message naming its ROADMAP item: ``--attn_impl xla``,
``--scan_layers``, ``--mesh`` / ``--pp_microbatches``. ``--no_wandb`` is
accepted; the port logs to files only.
"""

from __future__ import annotations

import argparse
import time

import torch

from vit_tpu_torch.data import decoders
from vit_tpu_torch.data.synthetic import SyntheticImageLoader
from vit_tpu_torch.data.video import _require_dir
from vit_tpu_torch.kernels.vq import out_of_reach
from vit_tpu_torch.models.tatitok import TATiTok, TATiTokConfig
from vit_tpu_torch.train.checkpoint import Checkpointer
from vit_tpu_torch.train.loop import (build_perceptual, image_batches,
                                      log_metrics, resume_position)
from vit_tpu_torch.train.optim import (MultiSteps, make_optimizer,
                                       wd_exclude_mask)
from vit_tpu_torch.train.preempt import GracefulShutdown
from vit_tpu_torch.train.state import TrainState, params_str
from vit_tpu_torch.train.step import make_tatitok_train_step
from vit_tpu_torch.utils.config import str2bool
from vit_tpu_torch.utils.init import init_tatitok_
from vit_tpu_torch.utils.logging import MetricsLogger
from vit_tpu_torch.utils.precision import disable_tf32

# the image size each dataset sets (train_tatitok.py:100-102)
IMAGE_SIZES = {"imagenet": 256, "dmlab": 64, "minecraft": 128}


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    # train_tatitok.py's flags, with its defaults
    parser.add_argument("--patch_size", type=int, default=16)
    parser.add_argument("--latent_tokens", type=int, default=256)
    parser.add_argument("--codebook_size", type=int, default=16384)
    parser.add_argument("--latent_dim", type=int, default=12)
    parser.add_argument("--transformer", type=str, default="small",
                        choices=["small", "base", "large"])
    parser.add_argument("--bs", type=int, default=32)
    parser.add_argument("--micro_steps", type=int, default=1)
    parser.add_argument("--mixed", type=str2bool, default=True)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--perceptual_weight", type=float, default=1.1)
    parser.add_argument("--weight_decay", type=float, default=1e-4)
    parser.add_argument("--warmup_steps", type=int, default=10000)
    parser.add_argument("--train_steps", type=int, default=1_000_000)
    parser.add_argument("--dataset", type=str, default="imagenet",
                        choices=["imagenet", "dmlab", "minecraft",
                                 "synthetic"])
    parser.add_argument("--epochs", type=int, default=100000)
    parser.add_argument("--data_dir", type=str, default=None)
    parser.add_argument("--image_size", type=int, default=None,
                        help="set by --dataset; override for synthetic")
    parser.add_argument("--steps_per_epoch", type=int, default=100)
    parser.add_argument("--max_epoch_steps", type=int, default=0,
                        help="cap batches per epoch (0 = the whole epoch)")
    parser.add_argument("--perceptual_weights", type=str, default=None,
                        help='"random" or a converted ConvNeXt-S .npz; '
                             "omit to disable the term")
    parser.add_argument("--perceptual_quant", type=str, default=None,
                        choices=[None, "int8"])
    parser.add_argument("--use_l2_norm", type=str2bool, default=True)
    parser.add_argument("--clustering_vq", action="store_true")
    parser.add_argument("--attn_impl", type=str, default=None,
                        choices=[None, "pallas", "xla"])
    parser.add_argument("--scan_layers", type=str2bool, default=False)
    parser.add_argument("--ckpt_dir", type=str, default="titok_models/tatitok")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--ema_decay", type=float, default=0.0,
                        help="parsed and not used, as in train_tatitok.py")
    parser.add_argument("--log_every", type=int, default=100)
    parser.add_argument("--ckpt_every", type=int, default=250,
                        help="parsed and not used, as in train_tatitok.py")
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
    args = parser.parse_args(argv)
    args.min_lr = args.lr / 10.0
    if args.image_size is None:
        args.image_size = IMAGE_SIZES.get(args.dataset, 64)
    return args


def check_ported(args: argparse.Namespace) -> None:
    """Raise on every flag whose path the port does not have, on a dataset
    whose package this machine lacks and on a dataset whose --data_dir is
    not given or not a directory."""
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
        (args.device != "cpu" and bool(out_of_reach(args.latent_dim)),
         f"--latent_dim {args.latent_dim}: {out_of_reach(args.latent_dim)}"),
        (bool(missing), missing),
    ]
    for bad, why in refused:
        if bad:
            raise NotImplementedError(why)
    if args.dataset != "synthetic":
        _require_dir(args.data_dir, f"--dataset {args.dataset}")


def get_loader(args):
    """The training stream of ``--dataset`` (``train_tatitok.py:
    get_loader``) at bs / micro_steps a batch, one process's."""
    bs = args.bs // args.micro_steps
    if args.dataset == "synthetic":
        return SyntheticImageLoader(args.image_size, bs,
                                    steps_per_epoch=args.steps_per_epoch,
                                    seed=args.seed, mode="shapes")
    if args.dataset == "imagenet":
        from vit_tpu_torch.data.imagenet import get_imagenet_loaders

        print(f"DECODER: {decoders.jpeg_decoder()}", flush=True)
        return get_imagenet_loaders(args.image_size, bs,
                                    data_dir=args.data_dir)[0]
    from vit_tpu_torch.data.video import (get_dmlab_image_loaders,
                                          get_minecraft_image_loaders)

    fn = (get_dmlab_image_loaders if args.dataset == "dmlab"
          else get_minecraft_image_loaders)
    return fn(bs, dataset_path=args.data_dir)[0]


def main(argv=None) -> TrainState:
    """Train as the flags say; returns the final train state."""
    args = parse_args(argv)
    check_ported(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_tatitok: no CUDA device (pass --device cpu "
                         "for the plain versions)")
    if not args.mixed and device.type == "cuda":
        disable_tf32()
    if args.ema_decay > 0:
        print(f"WARNING: --ema_decay {args.ema_decay} keeps no average: "
              f"train_tatitok.py parses the flag and builds its state "
              f"without one (ROADMAP Queue C #9)", flush=True)
    dtype = torch.bfloat16 if args.mixed else torch.float32
    config = TATiTokConfig(args.image_size, args.patch_size,
                           args.latent_tokens, args.codebook_size,
                           args.latent_dim, args.transformer,
                           use_l2_norm=args.use_l2_norm,
                           clustering_vq=args.clustering_vq, dtype=dtype)
    logger = MetricsLogger(
        f"titok-single-{args.dataset}",
        f"{args.transformer}_{args.latent_tokens}_{args.codebook_size}",
        config=vars(args), out_dir=args.run_dir, device=device)
    train_loader = get_loader(args)

    model = TATiTok(config)
    init_tatitok_(model, torch.Generator().manual_seed(args.seed))
    model.to(device).train().requires_grad_(True)
    vq_stats = ({"embed_prob": model.quantize.embed_prob}
                if args.clustering_vq else {})
    extra = {"vq_stats": vq_stats} if vq_stats else None
    perceptual = build_perceptual(args, dtype, device)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    tx = make_optimizer(args.lr, args.warmup_steps, args.train_steps,
                        args.min_lr, args.weight_decay, clip_norm=1.0,
                        weight_decay_mask=wd_exclude_mask(named))
    if args.micro_steps > 1:
        tx = MultiSteps(tx, args.micro_steps)
    state = TrainState.create(model, tx)

    ckpt = Checkpointer(args.ckpt_dir, mode="min")
    start_epoch, skip0, step0 = 0, 0, 0
    if args.resume:
        start_epoch, skip0, step0 = resume_position(ckpt, state,
                                                    train_loader, extra)
    step_kwargs = dict(perceptual_loss_fn=perceptual,
                       perceptual_weight=args.perceptual_weight)
    train_step = make_tatitok_train_step(model, **step_kwargs)
    train_step_watch = (make_tatitok_train_step(model, watch=True,
                                                **step_kwargs)
                        if args.watch else None)
    print(f"STATS: enc_params={params_str(state.params)}", flush=True)

    def save_last(epoch: int, next_batch: int, consumed: int) -> None:
        ckpt.save(state, config=config, tag="last", extra=extra)
        ckpt.save_data_state(int(state.step), {
            "epoch": epoch, "next_batch": next_batch, "consumed": consumed})

    shutdown = GracefulShutdown.install()
    best_recon = float("inf")
    usage = torch.zeros((config.codebook_size,), dtype=torch.float32,
                        device=device)
    step = step0
    prev_loss = None
    for epoch, i, images, st, load_time in image_batches(
            train_loader, device, start_epoch, skip0, args.epochs,
            args.max_epoch_steps):
        is_log = step % args.log_every == 0
        rebased = is_log and prev_loss is not None
        if rebased:
            # wait for the queued steps before the clock starts
            prev_loss.item()
            st = time.time()
        step_fn = (train_step_watch if is_log and train_step_watch
                   else train_step)
        state, usage, metrics, recon = step_fn(state, images, usage)
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
                  f"quant={host['train/quant_loss']:.3f} "
                  f"usage={host['train/codebook_usage']:.3f} "
                  f"step_time={step_time:.3f}", flush=True)
            if host["train/recon_loss"] < best_recon:
                best_recon = host["train/recon_loss"]
                ckpt.save_if_best(state, best_recon, config=config,
                                  extra=extra)
                save_last(epoch, i + 1, step + 1)
        if step % args.image_every == 0:
            logger.log_images(
                {"images": images[:4].float().cpu().numpy(),
                 "reconstructions": recon[:4].float().cpu().numpy()},
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
