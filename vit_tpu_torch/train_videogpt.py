"""VideoGPT training on one GPU: a frozen TiTok tokenizer codes each frame,
and the causal AR prior learns the codes (the port's counterpart of
``train_videogpt.py``).

    python -m vit_tpu_torch.train_videogpt --dataset synthetic \\
        --tokenizer_ckpt random --no_wandb [--device cpu]

It takes ``train_videogpt.py``'s flags with the same defaults: VideoGPT-B
over 16 frames of 64 codes (S 1024), codebook 1024, bs 32, bf16 compute
(``--mixed``), AdamW at lr 1e-4 (bf16 first moment), weight decay 1e-4, no
gradient clip, 5,000 warmup steps into a cosine over 500,000 to lr / 10.
``--tokenizer_ckpt`` is "random" (a TiTok-S at ``--image_size``, patch 8,
``--frame_size`` tokens, ``--codebook_size`` codes, weights from a fixed
seed), a checkpoint directory the port's ``train_titok`` or
``train_tatitok`` wrote (its "best" weights) or a Bytedance TATiTok folder
(``config.yaml`` and ``pytorch_model.bin``, converted on load:
``models/pretrained.py``); the tokenizer's token count, codebook and image
size then set
``--frame_size``, ``--codebook_size`` and ``--image_size``. ``--device``
(default ``cuda``) picks the card or, with ``cpu``, the kernels' plain
versions; ``--mixed false`` computes in fp32 through the kernels' fp32
forms, with TF32 off.

Each batch of the synthetic stream (``--max_frames`` × 2 uint8 frames) is
cut to ``--max_frames`` from an offset drawn from
``default_rng((seed, 0xC407, n))`` for the n-th batch of the run, divided
by 255 and copied to the card on a side stream one batch ahead. A resumed
run reads n from the checkpoint's stream position (``"consumed"``), so it
cuts the crops the uninterrupted run cuts. The tokenizer's codes of the
clip feed the prior's step. Every ``--log_every`` steps the loop prints
``e=.. s=.. loss=.. step_time=..`` and logs to
``<run_dir>/videogpt-<dataset>/<run>.jsonl``; at the first log step and
then every ``--ckpt_every`` steps it saves "best" (by loss) and "last"
under ``--ckpt_dir``; every ``--gen_every`` steps (step 0 included) it
rolls out ``--max_frames`` − ``--condition_frames`` frames greedily from
the first two clips' leading ``--condition_frames`` frames and logs the
real and generated frames, decoded by the tokenizer, as PNG strips.
SIGTERM saves "last" and exits 0; ``--resume`` continues from "last".

``--dropout`` trains the prior with dropout (the attention kernels' hash,
the MLP's mask) from a generator seeded by ``--seed`` and the step, so a
resumed run draws the masks the uninterrupted run draws. (The JAX entry's
step calls the model in its deterministic mode, so there ``--dropout``
changes nothing, and the port prints a warning when it starts; ROADMAP
Queue C #7.)

The data: ``--dataset dmlab`` (the default: ``--data_dir`` holds
``<folder>/<video>.npz`` clips, ``video`` (T, H, W, 3) uint8 and
``actions``, read whole by ``np.load``, bs clips a batch, reshuffled each
epoch) or ``synthetic`` (random uint8 clips). Each batch's crop is cut on
the host before the float conversion, as ``train_videogpt.py`` cuts it.

Refused, each with a message naming its ROADMAP item: ``--attn_impl
xla``, ``--scan_layers``, ``--mesh`` / ``--pp_microbatches`` and FSQ
tokenizers. ``--no_wandb`` is accepted; the port logs to files only.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from einops import rearrange

from vit_tpu_torch.data.prefetch import ToDevice, device_prefetch
from vit_tpu_torch.data.resume import resume_stream, set_stream_epoch
from vit_tpu_torch.data.synthetic import SyntheticVideoLoader
from vit_tpu_torch.data.video import _require_dir, get_dmlab_video_loaders
from vit_tpu_torch.models.pretrained import load_tokenizer
from vit_tpu_torch.models.videogpt import (VideoGPT, VideoGPTConfig,
                                           generate_frames)
from vit_tpu_torch.train.checkpoint import Checkpointer
from vit_tpu_torch.train.loop import init_weights
from vit_tpu_torch.train.optim import make_optimizer
from vit_tpu_torch.train.preempt import GracefulShutdown
from vit_tpu_torch.train.state import TrainState, params_str
from vit_tpu_torch.train.step import make_videogpt_train_step
from vit_tpu_torch.utils.config import str2bool
from vit_tpu_torch.utils.logging import MetricsLogger
from vit_tpu_torch.utils.precision import disable_tf32

# the temporal crop's stream: default_rng((seed, CROP_STREAM, batch number))
CROP_STREAM = 0xC407


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    # train_videogpt.py's flags, with its defaults
    parser.add_argument("--frame_size", type=int, default=64)
    parser.add_argument("--codebook_size", type=int, default=1024)
    parser.add_argument("--transformer", type=str, default="B")
    parser.add_argument("--max_frames", type=int, default=16)
    parser.add_argument("--condition_frames", type=int, default=8)
    parser.add_argument("--dropout", type=float, default=0.0)
    parser.add_argument("--bs", type=int, default=32)
    parser.add_argument("--mixed", type=str2bool, default=True)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--weight_decay", type=float, default=1e-4)
    parser.add_argument("--warmup_steps", type=int, default=5000)
    parser.add_argument("--train_steps", type=int, default=500000)
    parser.add_argument("--dataset", type=str, default="dmlab",
                        choices=["dmlab", "synthetic"])
    parser.add_argument("--epochs", type=int, default=100000)
    parser.add_argument("--data_dir", type=str, default=None)
    parser.add_argument("--tokenizer_ckpt", type=str, default="random",
                        help='a checkpoint directory of the port\'s '
                             'train_titok or train_tatitok, a Bytedance '
                             'TATiTok folder, or "random"')
    parser.add_argument("--image_size", type=int, default=64)
    parser.add_argument("--steps_per_epoch", type=int, default=50)
    parser.add_argument("--attn_impl", type=str, default=None,
                        choices=[None, "pallas", "xla"])
    parser.add_argument("--scan_layers", type=str2bool, default=False)
    parser.add_argument("--ckpt_dir", type=str, default="ckpt/videogpt")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--log_every", type=int, default=100)
    parser.add_argument("--ckpt_every", type=int, default=250,
                        help="min steps between checkpoint saves")
    parser.add_argument("--gen_every", type=int, default=1000)
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
    if args.condition_frames >= args.max_frames:   # train_videogpt.py:87
        parser.error("--condition_frames must be below --max_frames")
    return args


def check_ported(args: argparse.Namespace) -> None:
    """Raise on every flag whose path the port does not have yet, and on
    ``--dataset dmlab`` without a --data_dir that is a directory."""
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
    ]
    for bad, why in refused:
        if bad:
            raise NotImplementedError(why)
    if args.dataset == "dmlab":
        _require_dir(args.data_dir, "--dataset dmlab")


class ClipToDevice:
    """``prepare`` for ``device_prefetch``: a (videos uint8, actions) batch
    → the (B, max_frames, H, W, 3) fp32 clip in [0, 1] on the device. The
    n-th batch prepared takes the crop of ``default_rng((seed,
    CROP_STREAM, n))``, n counted from ``start``."""

    def __init__(self, device, seed: int, max_frames: int, start: int):
        self.to_device = ToDevice(device)
        self.seed, self.max_frames, self.n = seed, max_frames, start

    def __call__(self, batch):
        videos = np.asarray(batch[0])
        rng = np.random.default_rng((self.seed, CROP_STREAM, self.n))
        self.n += 1
        offset = int(rng.integers(0, max(videos.shape[1] - self.max_frames,
                                         1)))
        clip = np.asarray(videos[:, offset:offset + self.max_frames],
                          np.float32) / 255.0
        return self.to_device((clip,))

    def wait(self, prepared):
        return self.to_device.wait(prepared)[0]


@torch.no_grad()
def generation_images(model: VideoGPT, tokenizer, tokens: torch.Tensor,
                      clip: torch.Tensor, condition_frames: int) -> dict:
    """The conditional generation eval (``train_videogpt.py:304-320``): the
    first two clips' leading ``condition_frames`` frames of codes, rolled
    out greedily to the model's ``max_frames``, decoded by the tokenizer;
    the real and generated frames side by side as (2, H, T·W, 3) strips in
    [0, 1] on the host."""
    cfg = model.config
    gen = generate_frames(model, tokens[:2, :condition_frames],
                          cfg.max_frames - condition_frames)
    frames = tokenizer.decode_indices(
        rearrange(gen, "b (t n) -> (b t) n", n=cfg.frame_size))
    gen_video = rearrange(frames.float().clamp(0.0, 1.0),
                          "(b t) h w c -> b h (t w) c", b=2)
    real = rearrange(clip[:2].float(), "b t h w c -> b h (t w) c")
    return {"video": real.cpu().numpy(), "gen_video": gen_video.cpu().numpy()}


def main(argv=None) -> TrainState:
    """Train as the flags say; returns the final train state."""
    args = parse_args(argv)
    check_ported(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_videogpt: no CUDA device (pass --device cpu "
                         "for the plain versions)")
    if not args.mixed and device.type == "cuda":
        disable_tf32()
    dtype = torch.bfloat16 if args.mixed else torch.float32

    tokenizer = load_tokenizer(args.tokenizer_ckpt, dtype, device,
                               image_size=args.image_size,
                               frame_size=args.frame_size,
                               codebook_size=args.codebook_size)
    args.frame_size = tokenizer.latent_tokens
    args.codebook_size = tokenizer.codebook_size
    args.image_size = tokenizer.image_size

    config = VideoGPTConfig(args.frame_size, args.codebook_size,
                            args.transformer, args.max_frames, args.dropout,
                            dtype=dtype)
    model = VideoGPT(config)
    project_name = f"videogpt-{args.dataset}"
    run_name = (f"{args.frame_size}_{args.transformer}_{args.codebook_size}_"
                f"{args.max_frames}frames")
    logger = MetricsLogger(project_name, run_name, config=vars(args),
                           out_dir=args.run_dir, device=device)
    if args.dataset == "synthetic":
        train_loader = SyntheticVideoLoader(
            args.bs, frames=args.max_frames * 2, image_size=args.image_size,
            steps_per_epoch=args.steps_per_epoch, seed=args.seed)
    else:
        train_loader = get_dmlab_video_loaders(args.bs,
                                               dataset_path=args.data_dir,
                                               shard_id=0, num_shards=1)[0]

    init_weights(model, args.seed)
    model.to(device).train().requires_grad_(True)
    tx = make_optimizer(args.lr, args.warmup_steps, args.train_steps,
                        args.min_lr, args.weight_decay, clip_norm=None)
    state = TrainState.create(model, tx)

    ckpt = Checkpointer(args.ckpt_dir, mode="min")
    start_epoch, skip0, steps0 = 0, 0, 0
    if args.resume and ckpt.can_restore():
        state = ckpt.restore(state)
        print(f"RESUMED at step {int(state.step)}", flush=True)
        data_rs = ckpt.load_data_state(int(state.step))
        if data_rs:
            start_epoch = int(data_rs["epoch"])
            skip0 = int(data_rs["next_batch"])
            steps0 = int(data_rs.get("consumed", 0))
            set_stream_epoch(train_loader, start_epoch)
            print(f"RESUMED data stream at epoch {start_epoch}, "
                  f"batch {skip0}", flush=True)

    train_step = make_videogpt_train_step(model)
    dropout_gen = (torch.Generator(device=device) if args.dropout > 0
                   else None)
    if dropout_gen is not None:
        print(f"WARNING: --dropout {args.dropout} trains the prior with "
              f"dropout; train_videogpt.py's step runs deterministic and "
              f"ignores the flag (ROADMAP Queue C #7)", flush=True)
    print(f"STATS: titok_params="
          f"{params_str(list(tokenizer.model.parameters()))}, "
          f"video_gpt_params={params_str(state.params)}", flush=True)

    steps = steps0
    prev_loss = None
    ckpt_every = args.ckpt_every or 250
    last_ckpt_step = None
    prepare = ClipToDevice(device, args.seed, args.max_frames, steps0)
    shutdown = GracefulShutdown.install()

    def save_last(epoch: int, next_batch: int, consumed: int) -> None:
        step_now = int(state.step)
        ckpt.save(state, config=config, tag="last")
        ckpt.save_data_state(step_now, {"epoch": epoch,
                                        "next_batch": next_batch,
                                        "consumed": consumed})

    for epoch in range(start_epoch, args.epochs):
        skip = skip0 if epoch == start_epoch else 0
        st = time.time()
        for i, clip in enumerate(
                device_prefetch(resume_stream(train_loader, skip), prepare),
                start=skip):
            load_time = time.time() - st
            is_log = steps % args.log_every == 0
            rebased = is_log and prev_loss is not None
            if rebased:
                # wait for the queued steps before the clock starts
                prev_loss.item()
                st = time.time()
            if dropout_gen is not None:
                dropout_gen.manual_seed((args.seed << 32) + steps)
            state, tokens, metrics = train_step(state, tokenizer, clip,
                                                dropout_gen)
            prev_loss = metrics["train/loss"]
            if is_log:
                loss, step_now = torch.stack(
                    [metrics["train/loss"].double(),
                     state.step.double()]).tolist()
                step_now = int(step_now)
                step_time = time.time() - st - (0.0 if rebased else load_time)
                logger.log({"train/loss": loss, "train/epoch": epoch,
                            "train/steps": steps,
                            "benchmark/load_time": load_time,
                            "benchmark/step_time": step_time},
                           step=step_now)
                print(f"e={epoch} s={steps} loss={loss:.3f} "
                      f"step_time={step_time:.3f}", flush=True)
                if (last_ckpt_step is None
                        or steps - last_ckpt_step >= ckpt_every):
                    ckpt.save_if_best(state, loss, config=config)
                    save_last(epoch, i + 1, steps + 1)
                    last_ckpt_step = steps
            if steps % args.gen_every == 0:
                logger.log_images(
                    generation_images(model, tokenizer, tokens, clip,
                                      args.condition_frames),
                    step=int(state.step))
            steps += 1
            st = time.time()
            if shutdown.requested:
                # SIGTERM: save the exact step and return, so --resume
                # continues from here
                print(f"PREEMPTED: saving 'last' at step {int(state.step)} "
                      "and exiting", flush=True)
                save_last(epoch, i + 1, steps)
                ckpt.finalize()
                logger.close()
                shutdown.uninstall()
                return state

    save_last(args.epochs, 0, steps)
    ckpt.finalize()
    logger.close()
    shutdown.uninstall()
    return state


if __name__ == "__main__":
    main()
