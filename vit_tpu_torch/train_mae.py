"""MAE self-supervised pretraining on one GPU (the port's counterpart of
``train_mae.py``).

    python -m vit_tpu_torch.train_mae --dataset synthetic --no_wandb \\
        --epochs 1 --steps_per_epoch 5 --log_every 1 [--device cpu]

It takes ``train_mae.py``'s flags with the same defaults: image 256, patch
16, the B encoder, mask ratio 0.75, a decoder of 8 layers × 16 heads × 512
(head_dim 32: the attention kernels' 32-wide instantiations), per-patch
normalised targets (``--norm_pix``), bs 64, bf16 compute (``--mixed``), AdamW
at lr 1.5e-4 with weight decay 0.05, 5,000 warmup steps into a cosine over
500,000 to lr / 10, and no gradient clip. ``--device`` (default ``cuda``)
picks the card or, with ``cpu``, the kernels' plain versions; ``--mixed
false`` computes in fp32 through the kernels' fp32 forms.

Each step's mask noise (and dropout) comes from a generator seeded by
``--seed`` and the step, so masks differ per step and a resumed run draws
the masks the uninterrupted run draws; the validation pass gives every
batch the same generator state (``--seed`` + 7), as the JAX entry reuses
one key. The loop logs to ``<run_dir>/mae/<run>.jsonl``, keeps the
checkpoint of the lowest validation loss ("best") and a "last" one under
``--ckpt_dir``, resumes with the stream position (``--resume``) and saves
"last" on SIGTERM. Fine-tune the encoder with ``python -m
vit_tpu_torch.train_vit --init_from <ckpt_dir>``.

The data: ``--dataset imagenet`` (``--data_dir``), ``wds``
(``--wds_shards``) and ``synthetic``, through the classifier's loaders
(``train_vit.get_loaders``); the labels are ignored. The device meshes, the
scanned stack and ``--attn_impl xla`` are refused with a message naming
their ROADMAP item, as ``train_vit`` refuses them.

``python -m vit_tpu_torch.train_puzzle`` runs the same loop over Puzzle.
"""

from __future__ import annotations

import argparse
import time

import torch

from vit_tpu_torch import train_vit
from vit_tpu_torch.data.prefetch import ToDevice, device_prefetch
from vit_tpu_torch.data.resume import resume_stream, set_stream_epoch
from vit_tpu_torch.data.synthetic import SyntheticImageLoader
from vit_tpu_torch.models.mae import MAE, MAEConfig
from vit_tpu_torch.train.checkpoint import Checkpointer
from vit_tpu_torch.train.optim import make_optimizer
from vit_tpu_torch.train.preempt import GracefulShutdown
from vit_tpu_torch.train.state import TrainState, params_str
from vit_tpu_torch.train.step import make_mae_eval_step, make_mae_train_step
from vit_tpu_torch.utils.config import str2bool
from vit_tpu_torch.utils.init import init_params_
from vit_tpu_torch.utils.logging import MetricsLogger
from vit_tpu_torch.utils.precision import disable_tf32


def add_common_args(parser: argparse.ArgumentParser, ckpt_dir: str) -> None:
    """The flags ``train_mae.py`` and ``train_puzzle.py`` share, with their
    defaults (the mask ratio, dropout and the optimizer's included)."""
    parser.add_argument("--data_dir", type=str, default=None)
    parser.add_argument("--image_size", type=int, default=256)
    parser.add_argument("--in_channels", type=int, default=3)
    parser.add_argument("--patch_size", type=int, default=16)
    parser.add_argument("--transformer", type=str, default="B")
    parser.add_argument("--mask_ratio", type=float, default=0.75)
    parser.add_argument("--dropout", type=float, default=0.0)
    parser.add_argument("--bs", type=int, default=64)
    parser.add_argument("--mixed", type=str2bool, default=True)
    parser.add_argument("--lr", type=float, default=1.5e-4)
    parser.add_argument("--weight_decay", type=float, default=0.05)
    parser.add_argument("--warmup_steps", type=int, default=5000)
    parser.add_argument("--train_steps", type=int, default=500000)
    parser.add_argument("--epochs", type=int, default=10**9)
    parser.add_argument("--dataset", type=str, default="imagenet",
                        choices=["imagenet", "synthetic", "wds"])
    parser.add_argument("--wds_shards", type=str, default=None)
    parser.add_argument("--wds_streaming", type=str2bool, default=False)
    parser.add_argument("--shuffle_buffer", type=int, default=1000)
    parser.add_argument("--steps_per_epoch", type=int, default=50)
    parser.add_argument("--ckpt_dir", type=str, default=ckpt_dir)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--attn_impl", type=str, default=None,
                        choices=[None, "pallas", "xla"])
    parser.add_argument("--scan_layers", type=str2bool, default=False)
    parser.add_argument("--log_every", type=int, default=100)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--no_wandb", action="store_true")
    parser.add_argument("--run_dir", type=str, default=None)
    parser.add_argument("--mesh", type=str, default=None)
    parser.add_argument("--pp_microbatches", type=int, default=0)
    parser.add_argument("--loader_backend", type=str, default="threads",
                        choices=["threads", "grain"])
    parser.add_argument("--loader_processes", type=int, default=0)
    # the port's own
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the kernels) or cpu (their plain versions)")


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_common_args(parser, "ckpt/mae")
    parser.add_argument("--decoder_layers", type=int, default=8)
    parser.add_argument("--decoder_heads", type=int, default=16)
    parser.add_argument("--decoder_embd", type=int, default=512)
    parser.add_argument("--norm_pix", type=str2bool, default=True)
    args = parser.parse_args(argv)
    args.min_lr = args.lr / 10
    return args


def get_loaders(args):
    """The train and validation image streams (``train_mae.py:get_loaders``,
    which ``train_puzzle.py`` imports): the synthetic noise stream with the
    loader's default classes, or the classifier's imagenet and wds
    streams. Batches are (images, labels); the steps take the images."""
    if args.dataset == "synthetic":
        train = SyntheticImageLoader(
            args.image_size, args.bs, in_channels=args.in_channels,
            steps_per_epoch=args.steps_per_epoch, seed=args.seed)
        valid = SyntheticImageLoader(
            args.image_size, 2 * args.bs, in_channels=args.in_channels,
            steps_per_epoch=max(1, args.steps_per_epoch // 10),
            seed=args.seed + 1)
        return train, valid
    return train_vit.get_loaders(args)


def pick_device(args, entry: str) -> torch.device:
    """``--device``, refused when it is a card this machine lacks; TF32 off
    under ``--mixed false`` on the card."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{entry}: no CUDA device (pass --device cpu for "
                         "the plain versions)")
    if not args.mixed and device.type == "cuda":
        disable_tf32()
    return device


def _as_tuple(batch) -> tuple:
    """A loader's batch, (images, labels) or images alone, as a tuple whose
    first array is the images."""
    return tuple(batch) if isinstance(batch, (tuple, list)) else (batch,)


def pretrain(args, model, config, train_step, eval_step, *, project: str,
             run_name: str, best_key: str, mode: str) -> dict:
    """The pretraining loop of ``train_mae.py`` and ``train_puzzle.py``:
    train ``--steps_per_epoch`` steps an epoch, logging the step's metrics
    every ``--log_every``, then validate and keep the best checkpoint by
    ``valid/<best_key>`` (``mode`` "min" or "max"). Returns the logged
    train and eval metrics."""
    device = next(model.parameters()).device
    logger = MetricsLogger(project, run_name, config=vars(args),
                           out_dir=args.run_dir, device=device)
    tx = make_optimizer(args.lr, args.warmup_steps, args.train_steps,
                        args.min_lr, args.weight_decay, clip_norm=None)
    state = TrainState.create(model, tx)
    train_loader, valid_loader = get_loaders(args)

    ckpt = Checkpointer(args.ckpt_dir, mode=mode)
    start_epoch, skip0 = 0, 0
    if args.resume and ckpt.can_restore():
        state = ckpt.restore(state)
        print(f"RESUMED at step {int(state.step)}", flush=True)
        data_rs = ckpt.load_data_state(int(state.step))
        if data_rs:
            start_epoch = int(data_rs["epoch"])
            skip0 = int(data_rs["next_batch"])
            set_stream_epoch(train_loader, start_epoch)
            print(f"RESUMED data stream at epoch {start_epoch}, "
                  f"batch {skip0}", flush=True)
    print(f"STATS: params={params_str(state.params)}, device={device}",
          flush=True)
    print(f"PARAMS: {config}", flush=True)

    gen = torch.Generator(device=device)
    to_device = ToDevice(device)
    shutdown = GracefulShutdown.install()
    step = int(state.step)   # the host's count, so no step waits to read it
    logs = {"train": [], "valid": []}
    best = float("inf") if mode == "min" else -1.0
    for epoch in range(start_epoch, args.epochs):
        skip = skip0 if epoch == start_epoch else 0
        st = time.time()
        prev_loss = None
        for i, (images, *_) in enumerate(device_prefetch(
                map(_as_tuple, resume_stream(train_loader, skip)),
                to_device), start=skip):
            load_time = time.time() - st
            is_log = i % args.log_every == 0
            rebased = is_log and prev_loss is not None
            if rebased:   # time one step, not the queue of earlier ones
                prev_loss.item()
                st = time.time()
            # the JAX step folds its key with the step: masks replay on resume
            gen.manual_seed((args.seed << 32) + step)
            _, metrics = train_step(state, images, gen)
            step += 1
            prev_loss = metrics["train/loss"]
            if is_log:
                names = sorted(metrics)
                values = dict(zip(names, torch.stack(
                    [metrics[k].float() for k in names]).tolist()))
                step_time = time.time() - st - (0.0 if rebased else load_time)
                logs["train"].append(dict(
                    epoch=epoch, i=i, step_time=step_time, load_time=load_time,
                    **{k.split("/")[1]: v for k, v in values.items()}))
                logger.log({**values, "train/epoch": epoch,
                            "benchmark/load_time": load_time,
                            "benchmark/step_time": step_time}, step=step)
                shown = " ".join(f"{k.split('/')[1]}={v:.4f}"
                                 for k, v in values.items())
                print(f"e={epoch} i={i} {shown} load_time={load_time:.3f} "
                      f"step_time={step_time:.3f}", flush=True)
            st = time.time()
            if shutdown.requested:
                print(f"PREEMPTED: saving 'last' at step {step} and exiting",
                      flush=True)
                ckpt.save(state, config=config, tag="last")
                ckpt.save_data_state(step, {"epoch": epoch,
                                            "next_batch": i + 1})
                ckpt.finalize()
                logger.close()
                shutdown.uninstall()
                return logs
        sums, n = {}, 0
        for images, *_ in device_prefetch(map(_as_tuple, valid_loader),
                                          to_device):
            gen.manual_seed(args.seed + 7)   # one mask key for every batch
            m = eval_step(images, gen)
            for k, v in zip(sorted(m), torch.stack(
                    [m[k].float() for k in sorted(m)]).tolist()):
                sums[k] = sums.get(k, 0.0) + v
            n += 1
        valid = {k: v / max(n, 1) for k, v in sums.items()}
        logs["valid"].append(dict(epoch=epoch, **{
            k.split("/")[1]: v for k, v in valid.items()}))
        print(f"epoch {epoch}: " + ", ".join(
            f"{k.split('/')[1]}={v:.4f}" for k, v in valid.items()),
            flush=True)
        logger.log(valid, step=step)
        metric = valid.get(f"valid/{best_key}", best)
        if (metric < best) if mode == "min" else (metric > best):
            best = metric
            ckpt.save_if_best(state, metric, config=config)
    # a rolling "last", so --resume has a target when "best" is older
    ckpt.save(state, config=config, tag="last")
    ckpt.save_data_state(step, {"epoch": args.epochs, "next_batch": 0})
    ckpt.finalize()
    logger.close()
    shutdown.uninstall()
    return logs


def main(argv=None) -> dict:
    """Pretrain MAE as the flags say; returns the logged metrics."""
    args = parse_args(argv)
    # train_vit's refusals, in its words: the meshes (ROADMAP Queue A #9),
    # the scanned stack and --attn_impl xla (#10), missing data or decoders
    train_vit.check_ported(args)
    device = pick_device(args, "train_mae")
    config = MAEConfig(args.image_size, args.in_channels, args.patch_size,
                       args.transformer, args.mask_ratio, args.decoder_layers,
                       args.decoder_heads, args.decoder_embd, args.dropout,
                       args.norm_pix,
                       dtype=torch.bfloat16 if args.mixed else torch.float32)
    model = MAE(config, device=device)
    init_params_(model, torch.Generator(device=device).manual_seed(args.seed))
    run_name = (f"mae_{args.patch_size}px_{args.image_size}px_"
                f"{args.transformer}_{args.mask_ratio}mr_{args.bs}bs_"
                f"{args.lr}lr")
    return pretrain(args, model, config, make_mae_train_step(model),
                    make_mae_eval_step(model), project="mae",
                    run_name=run_name, best_key="loss", mode="min")


if __name__ == "__main__":
    main()
