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

The loop logs to ``<run_dir>/vit-classifier/<run>.jsonl``, keeps the
checkpoint of the best validation accuracy ("best") and a "last" one under
``--ckpt_dir``, resumes with the stream position (``--resume``) and saves
"last" on SIGTERM, as the JAX entry does. Each step's dropout is drawn from
a generator seeded by ``--seed`` and the step, so a resumed run draws the
masks the uninterrupted run draws.

The data: ``--dataset imagenet`` (the default; ``--data_dir`` holds
``train/`` and ``val/`` class folders; ``--loader_backend grain`` and
``--loader_processes`` read them through Grain), ``wds`` (the jpg + cls tar
shards of the ``--wds_shards`` glob, held in memory, or streamed through a
``--shuffle_buffer`` with ``--wds_streaming true``) and ``synthetic`` (the
JAX loader's noise stream). JPEGs are decoded by the native libjpeg
pipeline when it builds, else by Pillow (the entry prints which); a
dataset or backend whose package this machine lacks is refused before the
first batch, with a message naming the package.

Ported too: checkpoints and resume, the metrics log, and ``--init_from
<ckpt_dir>``, the fine-tuning hand-off from a ``vit_tpu_torch.train_mae``
or ``train_puzzle`` checkpoint ("best", else "last"): the source is told
apart as the JAX entry tells it (an MAE's parameters sit under
``encoder.``, a Puzzle's are ViT-shaped), and its patch projection and stack
(plus MAE's cls token, or Puzzle's ``pos_emb``) replace the fresh ones. The
rest of the flag set is refused with a message naming its ROADMAP item: the
scanned and pipelined stacks and device meshes. ``--no_wandb`` is
accepted; the port logs to files only.
"""

from __future__ import annotations

import argparse
import time

import torch

from vit_tpu_torch.data import decoders
from vit_tpu_torch.data.prefetch import ToDevice, device_prefetch
from vit_tpu_torch.data.resume import resume_stream, set_stream_epoch
from vit_tpu_torch.data.synthetic import SyntheticImageLoader
from vit_tpu_torch.data.video import _require_dir
from vit_tpu_torch.models.vit import ViTClassifier, ViTConfig
from vit_tpu_torch.train.checkpoint import Checkpointer
from vit_tpu_torch.train.optim import make_optimizer
from vit_tpu_torch.train.preempt import GracefulShutdown
from vit_tpu_torch.train.state import TrainState, params_str
from vit_tpu_torch.train.step import (make_classifier_eval_step,
                                      make_classifier_train_step)
from vit_tpu_torch.utils.config import str2bool
from vit_tpu_torch.utils.init import init_params_
from vit_tpu_torch.utils.logging import MetricsLogger
from vit_tpu_torch.utils.precision import disable_tf32


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    # train_vit.py's flags, with its defaults
    parser.add_argument("--data_dir", type=str, default=None)
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
    parser.add_argument("--ckpt_dir", type=str, default="ckpt/vit")
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
    """Raise on every flag whose path the port does not have yet, on a
    dataset or backend whose package this machine lacks, and on a dataset
    whose --data_dir is not given or not a directory."""
    refused = [
        (args.scan_layers,
         "--scan_layers: the port runs the unrolled stack (ROADMAP Queue A "
         "#10, no port needed)"),
        (args.mesh is not None or args.pp_microbatches,
         "--mesh/--pp_microbatches: the port trains on one GPU (ROADMAP "
         "Queue A #9, multi-GPU)"),
        (args.attn_impl == "xla",
         "--attn_impl xla: the port's attention is its kernels (ROADMAP "
         "Queue A #10, no port needed)"),
        (args.dataset == "wds" and not args.wds_shards,
         "--dataset wds needs --wds_shards, a glob of tar shards"),
    ]
    for bad, why in refused:
        if bad:
            raise NotImplementedError(why)
    why = decoders.missing(args.dataset, backend=args.loader_backend,
                           streaming=args.wds_streaming)
    if why:
        raise NotImplementedError(why)
    if args.dataset == "imagenet":
        _require_dir(args.data_dir, "--dataset imagenet")


def get_loaders(args):
    """The train and validation streams of ``--dataset``
    (``train_vit.py:get_loaders``), one process's: shard 0 of 1."""
    if args.dataset == "synthetic":
        train = SyntheticImageLoader(
            args.image_size, args.bs, num_classes=args.num_classes,
            in_channels=args.in_channels,
            steps_per_epoch=args.steps_per_epoch, seed=args.seed)
        valid = SyntheticImageLoader(
            args.image_size, 2 * args.bs, num_classes=args.num_classes,
            in_channels=args.in_channels,
            steps_per_epoch=max(1, args.steps_per_epoch // 10),
            seed=args.seed + 1)
        return train, valid
    if args.dataset == "wds":
        import glob

        from vit_tpu_torch.data.loader import DataLoader
        from vit_tpu_torch.data.wds import (WdsImageClassification,
                                            streaming_image_loader)

        shards = sorted(glob.glob(args.wds_shards))
        if not shards:
            raise FileNotFoundError(f"no shards match {args.wds_shards}")
        if args.wds_streaming:
            print(f"DECODER: {decoders.jpeg_decoder()}", flush=True)
            train = streaming_image_loader(
                shards, args.image_size, args.bs, train=True,
                shuffle_buffer=args.shuffle_buffer, seed=args.seed,
                shard_id=0, num_shards=1)
            valid = streaming_image_loader(shards, args.image_size,
                                           2 * args.bs, train=False,
                                           shard_id=0, num_shards=1)
            return train, valid
        print("DECODER: Pillow", flush=True)
        train_set = WdsImageClassification(shards, args.image_size,
                                           train=True)
        valid_set = WdsImageClassification(shards, args.image_size,
                                           train=False)
        return (DataLoader(train_set, args.bs, shuffle=True, drop_last=True,
                           shard_id=0, num_shards=1),
                DataLoader(valid_set, 2 * args.bs, shuffle=False,
                           drop_last=False, shard_id=0, num_shards=1))
    from vit_tpu_torch.data.imagenet import get_imagenet_loaders

    print(f"DECODER: {decoders.jpeg_decoder()}", flush=True)
    return get_imagenet_loaders(args.image_size, args.bs,
                                data_dir=args.data_dir,
                                backend=args.loader_backend,
                                processes=args.loader_processes,
                                shard_id=0, num_shards=1)


def init_from(model: ViTClassifier, directory: str) -> str:
    """Load a pretrained encoder from the checkpoint under ``directory``
    into ``model`` (``train_vit.py``'s ``--init_from``): an MAE's parameters
    sit under ``encoder.``, a Puzzle's are ViT-shaped. Returns the source's
    name, "MAE" or "Puzzle"."""
    from vit_tpu_torch.models.mae import load_encoder_into_vit
    from vit_tpu_torch.models.puzzle import load_puzzle_into_vit
    from vit_tpu_torch.train.checkpoint import load_params

    pre = load_params(directory)
    if any(k.startswith("encoder.") for k in pre):
        source, new = "MAE", load_encoder_into_vit(pre, model.state_dict())
    else:
        source, new = "Puzzle", load_puzzle_into_vit(pre, model.state_dict())
    model.load_state_dict(new)
    print(f"INIT encoder from {source} checkpoint {directory}", flush=True)
    return source


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
    run_name = (f"{args.patch_size}px_{args.image_size}px_{args.transformer}_"
                f"{args.bs}bs_{args.lr}lr_{args.dropout}drp")
    logger = MetricsLogger("vit-classifier", run_name, config=vars(args),
                           out_dir=args.run_dir, device=device)
    model = ViTClassifier(cfg, num_classes=args.num_classes, device=device)
    init_params_(model, torch.Generator(device=device).manual_seed(args.seed))
    if args.init_from:
        init_from(model, args.init_from)
    dropout_gen = torch.Generator(device=device)
    tx = make_optimizer(args.lr, args.warmup_steps, args.train_steps,
                        args.min_lr, args.weight_decay, clip_norm=None)
    state = TrainState.create(model, tx)
    train_step = make_classifier_train_step(model)
    eval_step = make_classifier_eval_step(model)
    train_loader, valid_loader = get_loaders(args)

    ckpt = Checkpointer(args.ckpt_dir, mode="max")
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

    # a streamed shard set has no length
    print(f"STATS: params={params_str(state.params)}, "
          f"trn_len={getattr(train_loader, '__len__', lambda: '?')()}, "
          f"val_len={getattr(valid_loader, '__len__', lambda: '?')()}, "
          f"device={device}", flush=True)
    print(f"PARAMS: {cfg.trans_config}", flush=True)

    to_device = ToDevice(device)
    shutdown = GracefulShutdown.install()
    step = int(state.step)   # the host's count, so no step waits to read it
    logs = {"train": [], "valid": []}
    best_acc = 0.0
    for epoch in range(start_epoch, args.epochs):
        skip = skip0 if epoch == start_epoch else 0
        st = time.time()
        prev_loss = None
        for i, (images, labels) in enumerate(device_prefetch(
                resume_stream(train_loader, skip), to_device), start=skip):
            load_time = time.time() - st
            is_log = i % args.log_every == 0
            rebased = is_log and prev_loss is not None
            if rebased:   # time one step, not the queue of earlier ones
                prev_loss.item()
                st = time.time()
            # the JAX step folds its dropout key with the step
            dropout_gen.manual_seed((args.seed << 32) + step)
            _, metrics = train_step(state, images, labels, dropout_gen)
            step += 1
            prev_loss = metrics["train/loss"]
            if is_log:
                loss, acc = torch.stack([metrics["train/loss"],
                                         metrics["train/acc"]]).tolist()
                step_time = time.time() - st - (0.0 if rebased else load_time)
                logs["train"].append(dict(epoch=epoch, i=i, loss=loss,
                                          acc=acc, step_time=step_time,
                                          load_time=load_time))
                logger.log({"train/loss": loss, "train/acc": acc,
                            "train/epoch": epoch,
                            "benchmark/load_time": load_time,
                            "benchmark/step_time": step_time}, step=step)
                print(f"e={epoch} i={i} loss={loss:.3f} acc={acc:.3f} "
                      f"load_time={load_time:.3f} step_time={step_time:.3f}",
                      flush=True)
            st = time.time()
            if shutdown.requested:
                # SIGTERM: save the exact step and return, so --resume
                # continues from here
                print(f"PREEMPTED: saving 'last' at step {step} and exiting",
                      flush=True)
                ckpt.save(state, config=cfg, tag="last")
                ckpt.save_data_state(step, {"epoch": epoch,
                                            "next_batch": i + 1})
                ckpt.finalize()
                logger.close()
                shutdown.uninstall()
                return logs
        val_loss = acc = 0.0
        n = 0
        for images, labels in device_prefetch(valid_loader, to_device):
            m = eval_step(images, labels)
            loss_i, acc_i = torch.stack([m["valid/loss"],
                                         m["valid/acc"]]).tolist()
            val_loss += loss_i
            acc += acc_i
            n += 1
        val_loss, acc = val_loss / max(n, 1), acc / max(n, 1)
        logs["valid"].append(dict(epoch=epoch, loss=val_loss, acc=acc))
        print(f"epoch {epoch}: val_loss={val_loss:.3f}, acc={acc:.3f}",
              flush=True)
        logger.log({"valid/loss": val_loss, "valid/acc": acc}, step=step)
        if acc > best_acc:
            best_acc = acc
            ckpt.save_if_best(state, acc, config=cfg)
    # a rolling "last", so --resume has a target when "best" is older
    ckpt.save(state, config=cfg, tag="last")
    ckpt.save_data_state(step, {"epoch": args.epochs, "next_batch": 0})
    ckpt.finalize()
    logger.close()
    shutdown.uninstall()
    return logs


if __name__ == "__main__":
    main()
