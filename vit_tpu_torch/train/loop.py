"""The tokenizer training loop (counterpart of
``vit_tpu/train/loop.py:27-275``).

One loop for the tokenizer entry points. Each step runs the port's
``make_tokenizer_train_step``, with the codebook-usage bitmap on the device.
Every ``log_every`` steps the loop fetches the step's metrics in one
device → host copy, logs and prints them; at the first log step and then
every ``ckpt_every`` steps it saves "best" (gated on train/recon_loss) and a
rolling "last" with the input-stream position. Every ``image_every`` steps
it logs input and reconstruction images, their SSIM and the per-parameter
norms, and resets the usage bitmap. SIGTERM saves "last" and returns;
``--resume`` restores the state and the stream position. ``--ema_decay``
keeps the weight average in the state (and its checkpoints); ``--watch``
runs the step variant with gradient and parameter histograms on log steps
only, and they come back in the log step's one copy.

Steps that do not log never wait for the device: the host queues them, and
at a log step the previous step's loss is read first, so that the step time
covers one step and not the queue.

``resume_position``, ``image_batches`` and ``log_metrics`` are the loop's
pieces that ``train_tatitok``'s loop, which saves on its own schedule,
shares with it.
"""

from __future__ import annotations

import itertools
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from vit_tpu_torch.data.prefetch import ToDevice, device_prefetch
from vit_tpu_torch.data.resume import resume_stream, set_stream_epoch
from vit_tpu_torch.train.checkpoint import Checkpointer
from vit_tpu_torch.train.optim import make_optimizer
from vit_tpu_torch.train.preempt import GracefulShutdown
from vit_tpu_torch.train.state import TrainState, params_str
from vit_tpu_torch.train.step import make_tokenizer_train_step
from vit_tpu_torch.utils.init import init_params_
from vit_tpu_torch.utils.logging import MetricsLogger
from vit_tpu_torch.utils.metrics import ssim, tree_norms


def init_weights(model: torch.nn.Module, seed: int) -> None:
    """The model's initial weights, drawn on the host from ``seed``."""
    init_params_(model, torch.Generator().manual_seed(seed))


def build_perceptual(args, dtype: torch.dtype, device):
    """The frozen ConvNeXt-S perceptual loss of ``--perceptual_weights``
    (None without it): "random" for the flax initialisers from seed 0, else
    the JAX package's ``.npz``. ``--perceptual_quant int8`` runs its
    pointwise products in int8; the loss is the same function."""
    spec = getattr(args, "perceptual_weights", None)
    if not spec:
        return None
    from vit_tpu_torch.losses.perceptual import ConvNeXt, PerceptualLoss

    quant = getattr(args, "perceptual_quant", None) or "none"
    if spec == "random":
        from vit_tpu_torch.utils.init import init_convnext_

        net = ConvNeXt(dtype=dtype, quant=quant)
        init_convnext_(net, torch.Generator().manual_seed(0))
        loss = PerceptualLoss(net)
    else:
        loss = PerceptualLoss.from_params(PerceptualLoss.load_params(spec),
                                          dtype=dtype, quant=quant)
    return loss.to(device)


def _fetch(tensors) -> list:
    """Tensors on the device → host values in one copy: a float for each
    0-d tensor, a float64 array for any other."""
    flat = torch.cat([t.detach().double().reshape(-1) for t in tensors])
    parts = np.split(flat.cpu().numpy(),
                     np.cumsum([t.numel() for t in tensors])[:-1])
    return [float(p[0]) if t.ndim == 0 else p.reshape(t.shape)
            for p, t in zip(parts, tensors)]


def resume_position(ckpt: Checkpointer, state: TrainState, train_loader,
                    extra: Optional[dict] = None) -> "tuple[int, int, int]":
    """``--resume``: restore "last" into ``state`` (and ``extra``, the
    clustering statistics, when the checkpoint has them) and the input
    stream's epoch; returns (start epoch, batches to skip in it, steps
    consumed), (0, 0, 0) when there is nothing to resume."""
    if not ckpt.can_restore():
        return 0, 0, 0
    ckpt.restore(state, extra=extra)
    print(f"RESUMED at step {int(state.step)}", flush=True)
    data_rs = ckpt.load_data_state(int(state.step))
    if not data_rs:
        return 0, 0, 0
    start_epoch, skip = int(data_rs["epoch"]), int(data_rs["next_batch"])
    set_stream_epoch(train_loader, start_epoch)
    print(f"RESUMED data stream at epoch {start_epoch}, batch {skip}",
          flush=True)
    return start_epoch, skip, int(data_rs.get("consumed", 0))


def image_batches(train_loader, device, start_epoch: int, skip0: int,
                  epochs: int, cap: int = 0):
    """The training stream from the resumed position, on ``device`` one
    batch ahead: (epoch, batch index, images, when the wait began, the wait
    in s). A wait begins at the epoch's start or when the consumer asks for
    the next batch. ``cap`` > 0 bounds each epoch, so a resumed epoch that
    skipped ``skip0`` batches takes cap − skip0 more."""
    to_device = ToDevice(device)
    for epoch in range(start_epoch, epochs):
        skip = skip0 if epoch == start_epoch else 0
        st = time.time()
        stream = resume_stream(train_loader, skip)
        if cap:
            stream = itertools.islice(stream, max(0, cap - skip))
        stream = ((images,) for images, _ in stream)
        for i, (images,) in enumerate(device_prefetch(stream, to_device),
                                      start=skip):
            yield epoch, i, images, st, time.time() - st
            st = time.time()


def log_metrics(logger: MetricsLogger, metrics: dict, state: TrainState
                ) -> "tuple[dict, int]":
    """A log step's metrics (and ``--watch``'s histograms) in one device →
    host copy with the step; histograms are logged here. Returns (the
    scalars by name, the step)."""
    hists = metrics.pop("_hists", {})
    keys = list(metrics)
    flat = [metrics[k] for k in keys] + [state.step]
    for counts, edges in hists.values():
        flat += [counts, edges]
    values = _fetch(flat)
    step_now = int(values[len(keys)])
    if hists:
        pairs = values[len(keys) + 1:]
        logger.log_histograms(dict(zip(hists, zip(pairs[::2], pairs[1::2]))),
                              step=step_now)
    return dict(zip(keys, values)), step_now


def run_tokenizer_training(args, model, model_config, train_loader, *,
                           project_name: str, run_name: str,
                           codebook_size: int, pixel_loss: str,
                           perceptual_weight: Optional[float] = None,
                           init: Optional[Callable] = None):
    """Train ``model`` (built on the host, weights drawn here by
    ``init_weights``, or by ``init(model, generator)`` for a model with an
    initialiser of its own) on ``args.device``. ``args`` carries the
    entry's flags (lr, warmup_steps, train_steps, min_lr, weight_decay,
    epochs, ...). Returns the state."""
    device = torch.device(args.device)
    dtype = torch.bfloat16 if args.mixed else torch.float32
    logger = MetricsLogger(project_name, run_name, config=vars(args),
                           out_dir=getattr(args, "run_dir", None),
                           device=device)

    if init is None:
        init_weights(model, args.seed)
    else:
        init(model, torch.Generator().manual_seed(args.seed))
    model.to(device).train().requires_grad_(True)
    perceptual = build_perceptual(args, dtype, device)
    tx = make_optimizer(args.lr, args.warmup_steps, args.train_steps,
                        args.min_lr, args.weight_decay, clip_norm=1.0,
                        mu_dtype=getattr(args, "adam_mu_dtype", None)
                        or "bfloat16")
    state = TrainState.create(model, tx,
                              ema_decay=getattr(args, "ema_decay", 0.0))

    ckpt = Checkpointer(args.ckpt_dir, mode="min")
    start_epoch, skip0 = 0, 0
    if getattr(args, "resume", False):
        start_epoch, skip0, _ = resume_position(ckpt, state, train_loader)

    step_kwargs = dict(
        perceptual_loss_fn=perceptual,
        perceptual_weight=(perceptual_weight if perceptual_weight is not None
                           else getattr(args, "perceptual_weight", 1.0)),
        pixel_loss=pixel_loss)
    train_step = make_tokenizer_train_step(model, **step_kwargs)
    # --watch: the histogram variant runs on log steps only
    train_step_watch = (make_tokenizer_train_step(model, watch=True,
                                                  **step_kwargs)
                        if getattr(args, "watch", False) else None)

    print(f"STATS: enc_params={params_str(state.params)}", flush=True)

    # a torch.profiler trace of steps 10-15 (Chrome trace format)
    profile_dir = (getattr(args, "profile_dir", None)
                   or os.environ.get("VIT_TPU_PROFILE_DIR"))
    profiler = None

    # Saves copy the whole state to the host (1.7 GB at TiTok-B), so their
    # cadence is apart from the log's; "best" is gated at save points only.
    ckpt_every = getattr(args, "ckpt_every", None) or 250
    last_ckpt_step = None

    usage = torch.zeros((codebook_size,), dtype=torch.float32, device=device)
    global_i = 0
    prev_loss = None
    shutdown = GracefulShutdown.install()

    for epoch, i, images, st, load_time in image_batches(
            train_loader, device, start_epoch, skip0, args.epochs,
            getattr(args, "max_epoch_steps", 0) or 0):
        if profile_dir and global_i == 10:
            profiler = torch.profiler.profile(activities=(
                [torch.profiler.ProfilerActivity.CPU]
                + ([torch.profiler.ProfilerActivity.CUDA]
                   if device.type == "cuda" else [])))
            profiler.start()
        is_log = i % args.log_every == 0
        rebased = is_log and prev_loss is not None
        if rebased:
            # wait for the queued steps before the clock starts
            prev_loss.item()
            st = time.time()
        step_fn = (train_step_watch if is_log and train_step_watch
                   else train_step)
        state, usage, metrics, recon = step_fn(state, images, usage)
        prev_loss = metrics["train/loss"]
        if profiler is not None and global_i == 15:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            profiler.stop()
            os.makedirs(profile_dir, exist_ok=True)
            profiler.export_chrome_trace(
                os.path.join(profile_dir, "trace.json"))
            profiler = None
            print(f"PROFILE: trace for steps 10-15 written to "
                  f"{profile_dir}", flush=True)
        global_i += 1
        if is_log:
            host, step_now = log_metrics(logger, metrics, state)
            step_time = time.time() - st - (0.0 if rebased else load_time)
            host.update({"train/epoch": epoch,
                         "benchmark/load_time": load_time,
                         "benchmark/step_time": step_time})
            logger.log(host, step=step_now)
            print(f"e={epoch} i={i} loss={host['train/loss']:.3f} "
                  f"recon={host['train/recon_loss']:.3f} "
                  f"quant={host['train/quant_loss']:.3f} "
                  f"usage={host['train/codebook_usage']:.3f} "
                  f"step_time={step_time:.3f}", flush=True)
            # the first log point, then every ckpt_every steps
            if (last_ckpt_step is None
                    or global_i - last_ckpt_step >= ckpt_every):
                ckpt.save_if_best(state, host["train/recon_loss"],
                                  config=model_config)
                # rolling "last": crash recovery via --resume
                ckpt.save(state, config=model_config, tag="last")
                ckpt.save_data_state(step_now,
                                     {"epoch": epoch, "next_batch": i + 1})
                last_ckpt_step = global_i
        if i % args.image_every == 0:
            with torch.no_grad():
                img4 = images[:4].float().clamp(0.0, 1.0)
                rec4 = recon[:4].float().clamp(0.0, 1.0)
                norms = tree_norms(dict(zip(state.names, state.params)),
                                   "param_norm")
                scalars = [state.step, *norms.values()]
                if min(img4.shape[1:3]) >= 11:   # SSIM's 11 × 11 window
                    scalars.append(ssim(rec4, img4).mean())
                values = _fetch(scalars)
            step_now = int(values[0])
            logger.log_images({"images": img4.cpu().numpy(),
                               "reconstructions": rec4.cpu().numpy()},
                              step=step_now)
            if len(values) > len(norms) + 1:
                logger.log({"train/ssim": values[-1]}, step=step_now)
            logger.log(dict(zip(norms, values[1:len(norms) + 1])),
                       step=step_now)
            usage.zero_()
        if shutdown.requested:
            # SIGTERM: save the exact step and return, so --resume
            # continues from here
            step_final = int(state.step)
            print(f"PREEMPTED: saving 'last' at step {step_final} "
                  "and exiting", flush=True)
            ckpt.save(state, config=model_config, tag="last")
            ckpt.save_data_state(step_final,
                                 {"epoch": epoch, "next_batch": i + 1})
            ckpt.finalize()
            logger.close()
            shutdown.uninstall()
            return state

    # the final state is recoverable wherever the interval fell
    ckpt.save(state, config=model_config, tag="last")
    ckpt.save_data_state(int(state.step),
                         {"epoch": args.epochs, "next_batch": 0})
    ckpt.finalize()
    logger.close()
    shutdown.uninstall()
    return state
