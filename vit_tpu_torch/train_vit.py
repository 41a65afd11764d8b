"""Supervised ViT classification training on one GPU (the port's counterpart
of ``train_vit.py``).

    python -m vit_tpu_torch.train_vit --dataset synthetic --no_wandb \\
        --epochs 1 --steps_per_epoch 5 --log_every 1 [--device cpu]

It takes ``train_vit.py``'s flags with the same defaults: ViT-L/16 at image
256, one extra (class) token, dropout 0.15, bs 64, bf16 compute
(``--mixed``), AdamW at lr 1e-4 with weight decay 1e-2, 5,000 warmup steps
into a cosine over 500,000 to lr / 10, and no gradient clip. ``--device``
(default ``cuda``) picks the card or, with ``cpu``, the kernels' plain
versions; ``--mixed false`` computes in fp32 through the kernels' fp32
forms, with TF32 off in cuBLAS and cuDNN. Each epoch trains ``--steps_per_epoch`` steps, printing loss,
accuracy and step time every ``--log_every`` steps, then runs the eval step
over the validation stream and prints its loss and accuracy.

Ported so far: ``--dataset synthetic`` (the JAX loader's noise stream). The
rest of the flag set is refused with a message until it is ported: the
ImageNet and webdataset loaders, checkpoints (``--ckpt_dir``,
``--resume``), ``--init_from``, the scanned and pipelined stacks, device
meshes, the loader backends and the metrics logger's ``--run_dir``.
``--no_wandb`` is accepted: the port logs to standard output only.
"""

from __future__ import annotations

import argparse
import time

import torch

from vit_tpu_torch.data.synthetic import SyntheticImageLoader
from vit_tpu_torch.models.vit import ViTClassifier, ViTConfig
from vit_tpu_torch.train.optim import make_optimizer
from vit_tpu_torch.train.state import TrainState
from vit_tpu_torch.train.step import (make_classifier_eval_step,
                                      make_classifier_train_step)
from vit_tpu_torch.utils.init import init_params_
from vit_tpu_torch.utils.precision import disable_tf32


def str2bool(value) -> bool:
    """``train_vit.py``'s boolean flag parser: the usual spellings only."""
    if isinstance(value, bool):
        return value
    v = str(value).strip().lower()
    if v in ("true", "t", "yes", "y", "1"):
        return True
    if v in ("false", "f", "no", "n", "0"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {value!r}")


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    # train_vit.py's flags, with its defaults
    parser.add_argument("--data_dir", type=str,
                        default="/mnt/data/Public_datasets/imagenet/imagenet_pytorch")
    parser.add_argument("--image_size", type=int, default=256)
    parser.add_argument("--in_channels", type=int, default=3)
    parser.add_argument("--patch_size", type=int, default=16)
    parser.add_argument("--extra_tokens", type=int, default=1)
    parser.add_argument("--transformer", type=str, default="L")
    parser.add_argument("--dropout", type=float, default=0.15)
    parser.add_argument("--bs", type=int, default=64)
    parser.add_argument("--mixed", type=str2bool, default=True)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--weight_decay", type=float, default=1e-2)
    parser.add_argument("--warmup_steps", type=int, default=5000)
    parser.add_argument("--train_steps", type=int, default=500000)
    parser.add_argument("--epochs", type=int, default=10**9)
    parser.add_argument("--dataset", type=str, default="imagenet",
                        choices=["imagenet", "synthetic", "wds"])
    parser.add_argument("--wds_shards", type=str, default=None)
    parser.add_argument("--wds_streaming", type=str2bool, default=False)
    parser.add_argument("--shuffle_buffer", type=int, default=1000)
    parser.add_argument("--num_classes", type=int, default=1000)
    parser.add_argument("--steps_per_epoch", type=int, default=50)
    parser.add_argument("--ckpt_dir", type=str, default=None)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--init_from", type=str, default=None)
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
    args = parser.parse_args(argv)
    args.min_lr = args.lr / 10  # reference train_vit.py:72
    return args


def check_ported(args: argparse.Namespace) -> None:
    """Raise on every flag whose path the port does not have yet."""
    later = "comes with the training loop's port (ROADMAP Queue A #3)"
    refused = [
        (args.dataset != "synthetic",
         f"--dataset {args.dataset}: only the synthetic stream is ported; "
         f"the ImageNet and webdataset loaders {later}"),
        (args.ckpt_dir is not None or args.resume,
         f"--ckpt_dir/--resume: checkpointing {later}"),
        (args.init_from is not None,
         f"--init_from: the MAE/Puzzle hand-off {later}"),
        (args.scan_layers, "--scan_layers: the port runs the unrolled stack"),
        (args.mesh is not None or args.pp_microbatches,
         "--mesh/--pp_microbatches: the port trains on one GPU"),
        (args.loader_backend != "threads" or args.loader_processes,
         f"--loader_backend/--loader_processes: the loader backends {later}"),
        (args.run_dir is not None,
         f"--run_dir: the metrics logger {later}; the port prints its logs"),
        (args.attn_impl == "xla",
         "--attn_impl xla: the port's attention is its kernels"),
    ]
    for bad, why in refused:
        if bad:
            raise NotImplementedError(why)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    """Train as the flags say; returns the logged train and eval metrics."""
    args = parse_args(argv)
    check_ported(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_vit: no CUDA device (pass --device cpu for "
                         "the plain versions)")
    dtype = torch.bfloat16 if args.mixed else torch.float32
    if not args.mixed and device.type == "cuda":
        disable_tf32()
    cfg = ViTConfig(args.image_size, args.in_channels, args.patch_size,
                    args.transformer, args.extra_tokens, args.dropout,
                    dtype=dtype)
    model = ViTClassifier(cfg, num_classes=args.num_classes, device=device)
    init_params_(model, torch.Generator(device=device).manual_seed(args.seed))
    dropout_gen = torch.Generator(device=device).manual_seed(args.seed)
    tx = make_optimizer(args.lr, args.warmup_steps, args.train_steps,
                        args.min_lr, args.weight_decay, clip_norm=None)
    state = TrainState.create(model, tx)
    train_step = make_classifier_train_step(model)
    eval_step = make_classifier_eval_step(model)
    train_loader = SyntheticImageLoader(
        args.image_size, args.bs, num_classes=args.num_classes,
        in_channels=args.in_channels, steps_per_epoch=args.steps_per_epoch,
        seed=args.seed)
    valid_loader = SyntheticImageLoader(
        args.image_size, 2 * args.bs, num_classes=args.num_classes,
        in_channels=args.in_channels,
        steps_per_epoch=max(1, args.steps_per_epoch // 10), seed=args.seed + 1)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"STATS: params={n_params / 1e6:.2f}M, trn_len={len(train_loader)}, "
          f"val_len={len(valid_loader)}, device={device}", flush=True)
    print(f"PARAMS: {cfg.trans_config}", flush=True)

    def put(batch):
        images, labels = batch
        return (torch.from_numpy(images).to(device, non_blocking=True),
                torch.from_numpy(labels).to(device, non_blocking=True))

    logs = {"train": [], "valid": []}
    for epoch in range(args.epochs):
        st = time.perf_counter()
        for i, batch in enumerate(train_loader):
            images, labels = put(batch)
            load_time = time.perf_counter() - st
            is_log = i % args.log_every == 0
            if is_log:   # time one step, not the queue of earlier ones
                _sync(device)
                st = time.perf_counter()
            _, metrics = train_step(state, images, labels, dropout_gen)
            if is_log:
                loss = metrics["train/loss"].item()
                acc = metrics["train/acc"].item()
                step_time = time.perf_counter() - st
                logs["train"].append(dict(epoch=epoch, i=i, loss=loss,
                                          acc=acc, step_time=step_time,
                                          load_time=load_time))
                print(f"e={epoch} i={i} loss={loss:.3f} acc={acc:.3f} "
                      f"load_time={load_time:.3f} step_time={step_time:.3f}",
                      flush=True)
            st = time.perf_counter()
        val_loss = acc = 0.0
        n = 0
        for batch in valid_loader:
            m = eval_step(*put(batch))
            val_loss += m["valid/loss"].item()
            acc += m["valid/acc"].item()
            n += 1
        val_loss, acc = val_loss / max(n, 1), acc / max(n, 1)
        logs["valid"].append(dict(epoch=epoch, loss=val_loss, acc=acc))
        print(f"epoch {epoch}: val_loss={val_loss:.3f}, acc={acc:.3f}",
              flush=True)
    return logs


if __name__ == "__main__":
    main()
