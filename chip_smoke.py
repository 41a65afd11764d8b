"""End-to-end smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths at full width with random weights from a seed:
the TiTok-B tokenizer served over HTTP (images → /encode → indices →
/decode → images; image 128, patch 16, 256 latent tokens, codebook 2048 ×
12, ViT-B encoder and decoder, S = 320), the flagship TiTok-B training step
at bs 64 with the frozen ConvNeXt-S perceptual loss, unfused and with the
fused LayerNorm → matmul and dW + db kernels switched on, and the VideoGPT-B AR
prior (16 frames × 64 codes, S = 1024, over a frozen random TiTok-S at
image 64): its training step at bs 32 and its greedy KV-cache rollout served
over HTTP; then the flagship step with the int8 perceptual loss
(``--perceptual_quant int8``) and the perceptual loss alone under both of its
switches (``dw_impl``, ``quant``); then the ViT classifier at
``bench_extra.py``'s two configs, ViT-B/16 @224 and ViT-L/16 @256 at
dropout 0.15 (the attention kernels' dropout branch); the fp32 paths
(``--mixed false``): the flagship step and the VideoGPT-B step at dtype
float32 through the kernels' fp32 forms; and ``python -m
vit_tpu_torch.train_vit`` at its defaults, in bf16 and with ``--mixed
false``. Phases, one JSON line each:

  1. device   — fails without CUDA; card name and power limit; TF32 off;
                the line ``decoders: {"PIL", "cv2", "grain", "native"}``
                (which decoding packages the machine has; native: whether
                the libjpeg pipeline builds);
  2. build    — compiles the CUDA kernels from ``vit_tpu_torch/csrc``, one
                nvcc per source in parallel; registers and spills per kernel;
  2b. fma_probe — P, the FMA-rate probe (``scripts/bench_vpu.py``'s
                ``_fma_kernel``): bit for bit against its plain version at
                (64, 128), fp32 and bf16, chains 1-6, 4096 steps, and in
                bf16 at c = 1 + 2⁻⁷, d = 2⁻¹⁰ (256 steps), where each step
                changes the value (at the script's constants a bf16 step
                returns a, so that parity cannot see the loop); the rate
                sweep over the card-filling shape (132 SMs × 2,048 threads)
                against the CUDA cores' FMA bound; ``python -m
                vit_tpu_torch.bench_vpu`` as a subprocess. Its best fp32
                rate becomes the rate of every fp32 bound of the run;
  3. kernels  — each kernel against its plain PyTorch version on the card,
                at the paths' shapes and a few edge shapes, with timings, the
                bound the card's peaks set for the same work, and the time of
                one PyTorch library call computing the same function (or,
                as named, the product inside it) where there is one
                (``F.scaled_dot_product_attention`` for the attention
                kernels, with the backend it picked; ``F.linear`` for K9a,
                ``torch.mm`` for K10, ``F.conv2d`` and its backward for
                K11a/K11b, ``torch._int_mm`` for K12a/K12b); K1/K2 also at
                the ViT shapes (4, 197, 12 heads) and (4, 257, 16 heads),
                with the ptxas figures of their kernels (the kBias forms of
                K6's and K7/K8's); K5's runtime-D form at D 5, 6, 24,
                64, 101, 200, 256 and 1024 against N 16384 × C 2048 and
                16384, and at D 2048 and 4096 against C 2048, held to
                fp64 scores as its tuned forms are, with the
                lowest-index ties (also across slices) at D 6 too, timed
                beside its bound; the wgmma backwards (K2, K7/K8 and their
                dropout arms) within ``WGMMA_BWD_MEAN_REL`` of mean |plain|,
                which a control (ph rounded to bf16 early) must fail, and
                the wgmma forwards (K1, K6 and their dropout arms) within
                ``WGMMA_FWD_MEAN_REL``, which a control (p normalised
                before its bf16 cast) must fail; K3/K4
                at ConvNeXt-S's three fused stages and ragged N within
                ``TAIL_MEAN_REL`` of mean |plain|, which a control (z, or
                da, rounded to bf16 early) must fail, with the ptxas
                figures, shared memory and blocks per SM of their kernels;
                K9a and K9c within ``LN_MEAN_REL`` of mean |plain|, which a
                control (the LayerNorm statistics rounded to bf16) must
                fail (K9c timed single, 20 back to back and on the card
                alone beside the library's LayerNorm backward), and K12a
                and K12b within ``Q8_MEAN_REL``, which a control (one
                per-tensor activation scale for the per-row ones) must
                fail, timed at the three fused stages with their ptxas
                figures, shared memory and blocks per SM, K12a also on rows
                where GELU is flat and K12b on rows whose dz levels lie at
                near-half quotients; K11a and K11b (its dx-only form and its
                full one) at ConvNeXt-S's four stages at bs 64 and a ragged
                shape, fp32 and bf16: within one bf16 ulp, fp32 within
                ``K11_MEAN_REL``, dw and db within ``K11_DW_MEAN_REL``
                (controls: operands and partial sums rounded to bf16), the
                dx-only dx equal to the full form's, timed single and 20
                back to back beside cuDNN's calls, with the plans'
                occupancy; K7 at
                its own shape (2, 12, 513); the dropout arms of K1/K2 at
                ViT-L's (64, 257, 16 heads, rate 0.15), K6/K8 at (32, 12,
                1024) causal and K7 at (2, 12, 513) causal (rate 0.1), each
                against its plain version with the same seed vector, the
                dropped fraction within 5σ of the rate, their times with
                and without dropout beside SDPA's with ``dropout_p`` (its
                own Philox mask), and mask probes (q = k = 0, one-hot v and
                dO) whose outputs and dv equal the plain versions' bit for
                bit at S 257, 513 and 1024, causal and not;
  3b. fp32_kernels — every fp32 form (K1, K2, K3, K4, K6, K7/K8, K9a, K9b,
                K9c, K10, K12a, K12b on fp32 operands) against its fp32
                plain version within 1e-5 of max and mean |plain| (K12's
                max within K12_REL: int8 levels), at the fp32 paths' shapes,
                the dropout arms included; K9a, K9c and K12 within their
                mean limits as in the kernel phase; the fp32 attention
                (K1, K6 forward and K2, K7/K8 backward), K3, K4, K9a and
                K10 (products of three bf16 parts on the tensor cores) also
                within ``F32_FWD_MEAN_REL`` of the float64 forward's mean
                |o|, |m| and |l|, ``F32_BWD_MEAN_REL`` of the plain
                backward's mean |plain|, ``F32_TAIL_MEAN_REL`` of the
                float64 tail's mean |y|, ``F32_TAIL_BWD_MEAN_REL`` of
                the float64 tail gradient's mean |dh| at each fused width,
                ``F32_LNMM_MEAN_REL`` of the float64 K9a and
                ``F32_FCGRAD_MEAN_REL`` of the float64 dW (K10 at fc2, fc1
                and N 20481, deterministic), which controls (the operands
                rounded to two parts) must fail; K12b's fp32 rows at each
                fused width, the pre-splits (three operands forward, four
                backward, K3's weights) bit for bit and timed alone, the
                ptxas figures and the bounds at the split products' rate
                (six bf16 products an fp32 one) beside the fp32 rate's; a TF32 control
                (the plain version with TF32 on in the form's place) that
                must fail that limit for K1, K2, K3, K4, K6, K9a and K10;
                each form that was SIMT fp32 (K3, K4, K9a, K10 and the fp32
                rows of K9b, K9c, K12a, K12b) also within its own
                ``SIMT_F32_MEAN_REL``,
                which its control (TF32, or operands rounded to bf16) must
                fail;
                times, bounds over the published fp32 rate (P's measured
                rate reported beside it) and library times (SDPA on
                fp32 tensors, ``F.linear``, fp32 ``torch.mm``,
                ``aten.native_layer_norm_backward``); mask probes whose kept counts, recovered from
                the fp32 forms' outputs and dv, equal the bf16 forms' and the
                mask's, integer for integer;
  3c. pretrain — the MAE and Puzzle pretraining paths (``python -m
                vit_tpu_torch.train_mae``, ``train_puzzle``) and the
                fine-tuning hand-off (``train_vit --init_from``). K1/K2 at
                head_dim 32, the MAE-B decoder's (64, 257, 16 heads × 32):
                bf16 without and with a bias and with dropout 0.15, and
                the fp32 forms, each within the 64-wide forms' limits with
                the controls that must fail them, the dropout mask bit for
                bit (``mask_probe`` at d 32); K6 and K7/K8 at head_dim 32
                at MAE-B @512's (8, 16, 1025), a causal S 800 and S 513, a
                dropout arm, and the fp32 forms; times, bounds and SDPA's.
                Then one step each of MAE-B (bs 64, image 256: K1/K2 12 +
                12 at d 64, S 65, and 8 + 8 at d 32, S 257), Puzzle-B (12
                + 12 at d 64, S 256), MAE-B @512 at bs 8 (the decoder's
                S 1025 on K6 and K7/K8 at d 32) and MAE-B at fp32 (bs 16,
                ``--mixed false``: every launch an fp32 form), the launches
                by head width, the loss and gradient norm against the
                plain versions from one noise draw, step times on CUDA
                events; ``train_mae`` and ``train_puzzle`` at their
                defaults for 3 steps and a validation pass (MAE's writes
                "best"), each with its K1/K2 widths launched, and
                ``train_vit --init_from`` that checkpoint at ViT-B/16
                @256, whose logits right after the hand-off equal a
                classifier's that ``load_encoder_into_vit`` built from it;
  3d. tatitok — the Bytedance stack at ``train_tatitok.py``'s defaults
                (TATiTok-S at image 256: S 513, 8 heads; codebook 16384 ×
                12 with L2): K5 at (8192, 16384, 12) against fp64 scores,
                K1/K2 at (32, 513, 8 heads × 64) with a bias within
                ``packed_kernels``' limits, with times, bounds and SDPA's;
                one step at bs 32 with the ConvNeXt-S perceptual loss (K1
                16, K2 16, K3 66, K4 33, K5 1) against the plain versions
                from the same weights within ``STEP_LOSS_REL`` and
                ``STEP_GRAD_NORM_REL``, its CUDA-event median and peak
                memory; the same step under remat ("everything", "dots":
                K1 32, the same limits against the plain remat-off step, a
                lower peak); an fp32 step at bs 8 (cut from 32) within
                ``FP32_STEP_REL``; ``python -m vit_tpu_torch.train_tatitok``
                at image 256 with ``--micro_steps 2 --clustering_vq``: a
                SIGTERM inside an accumulation, then ``--resume`` with the
                usage EMA restored; a TATiTok-S at image 64 with 64 codes
                and ``train_videogpt`` over it (VideoGPT-B, S 1024, codebook
                16384) for 2 steps; a Bytedance folder written from it,
                whose ``load_tokenizer`` codes equal a direct fp32 encode
                (without PyYAML, the refusal naming it);
  3e. families — the other tokenizer families: K1/K2 at (32, 64, 12 heads)
                with a bias and without (the enhancing QKV) and at (32,
                512, 8 heads), K5 at (8192, 16384, 8) with L2 against fp64
                scores, with times, bounds and SDPA's; a ViT-VQGAN-B and an
                enhancing ViT-VQGAN step (image 128, bs 32, L1 pixel loss,
                ConvNeXt-S perceptual loss: K1 24, K2 24, K3 66, K4 33, K5
                1) against the plain versions within ``STEP_LOSS_REL`` and
                ``STEP_GRAD_NORM_REL``, with CUDA-event medians and peaks;
                ``python -m vit_tpu_torch.train_vit_vqgan`` at its defaults
                on the JPEG fixtures (--dataset imagenet), writing "best";
                ``python -m vit_tpu_torch.train_llamagen_titok`` at its
                defaults (LlamaGen-TiTok-S) over synthetic codes across a
                SIGTERM and ``--resume``, over that ViT-VQGAN checkpoint
                and over a LlamaGen VQ-16 ``.pt`` in LlamaGen's layout from
                random weights; VQ-16's codes through K5 against the plain
                version on the same latents;
  4. slice    — export → load → HTTP server; concurrent /encode requests,
                /decode of the indices; checks shapes, ranges, a 400, that
                every kernel launched during those requests, that the served
                codes equal a direct call of the kernels, and that the same
                weights run through the plain versions agree: latents and
                images within bf16 noise, every differing code a near-tie;
  5. timing   — the live model's encode and decode at bs 8 and 64, with
                the kernels and through the plain versions (HTTP latencies
                are phase 20's);
  6. train    — the flagship step (TiTok-B, bs 64, perceptual loss, clip,
                AdamW with a bf16 first moment): the launches of one step
                (K1 24, K2 24, K3 66, K4 33, K5 1); the same first step from
                a deep copy through the plain versions, loss, perceptual loss
                and gradient norm within bf16 noise; 20 steps on one batch
                with a short warmup lower the recon loss; images/s and peak
                memory with the kernels and with the plain versions;
  7. train_fused — the same step on the same weights and batch with
                VIT_TPU_FUSED_LN=1 VIT_TPU_FUSED_FC=1 set for the phase: the
                launches of one step (K9a 48, K9b 24, K9c 48, K10 24 besides
                the unfused step's); its first step against the plain
                versions and against the unfused kernels' step; 20 steps
                lower the recon loss; step time, images/s and peak memory
                unfused, fused, with fused FC alone and fused through the
                plain versions, in turns; a profile of one fused step; one
                step with VIT_TPU_FUSED_LN=0 VIT_TPU_FUSED_FC=1 (K10 48)
                against the plain versions; a bs-64 encode and decode with
                fused LN (K9a without a gradient) against the unfused
                kernels', every differing code a near-tie, and their times;
                every K9a and K9c launch of the first fused step and of
                that encode and decode within ``LN_MEAN_REL`` of its plain
                version on the same inputs;
  8. videogpt_train — the VideoGPT-B step at bs 32 (tokenize 512 frames,
                next-token CE, AdamW): the launches of one step (K6 12,
                K7/K8 12, K1 6, K5 1); the tokenizer's codes against the
                plain versions' (every differing code a near-tie); loss and
                gradient norm of the first step against the plain versions,
                on the same codes; 20 steps on one batch lower
                the loss; step time, tokens/s and peak memory of the full
                step and of the AR step alone on random tokens; a profile of
                one step; then 3 steps at ``--dropout 0.1`` on the same
                weights (K6 12 and K8 12 dropout launches a step), the
                first's loss and gradient norm against the plain versions
                from the same generator state;
  9. videogpt_rollout — export → load → HTTP /generate at bs 8 (bs 1: phase
                20, through the export CLI): 512
                conditioning codes in, 128 generated (two frames: cut from
                eight to keep the run in its time), the prefix intact, every
                code in range, equal to a direct generate call, 12 K6
                launches per rollout (the prefill); the prefill's logits
                against the plain versions and the first generated code equal
                or a near-tie; generated tokens/s per request; the device's
                busy time in one rollout against the host's;
 10. train_int8 — the flagship step on the same weights and batch with
                ``PerceptualLoss(quant="int8")`` (``bench.py
                --perceptual_quant int8``): the launches of one step (K12a
                66, K12b 33 in place of K3/K4); its first step against the
                plain versions; every K12a and K12b launch of that step
                within ``Q8_MEAN_REL`` of its plain version on the same
                inputs; the int8 perceptual loss's gap from the bf16
                one; 20 steps lower the recon loss; step time, images/s and
                peak memory in turns with the bf16 step; a profile of one
                int8 step;
 11. perceptual — ``scripts/bench_perceptual.py``'s measurement: the loss and
                its image gradient at bs 64, image 128, under ``dw_impl`` ∈
                {lax, pallas} × ``quant`` ∈ {none, int8}: launches per call
                (K11a 72, K11b 36 under pallas, all 36 in K11b's dx-only
                form: the trunk is frozen), each kernel arm against its
                plain versions, under int8 every K12a and K12b launch of
                the first call within ``Q8_MEAN_REL`` of its plain version,
                ms per call and a profile of one call;
 12. vit      — ``make_classifier_train_step`` at bs 64 for ViT-B/16 @224
                (S 197, no dropout: K1 12, K2 12 a step) and ViT-L/16 @256
                at dropout 0.15 (S 257: K1 24, K2 24, all with dropout):
                the first step's logits, loss and gradient norm against the
                plain versions from the same generator state, 10 steps on
                one batch at lr 1e-5 lower the loss, images/s and peak
                memory, and a profile of one ViT-L step;
 13. fp32     — the flagship step at dtype float32 (bs 64, ConvNeXt-S at
                fp32) unfused, with VIT_TPU_FUSED_LN=1 VIT_TPU_FUSED_FC=1
                and with ``quant="int8"``, the VideoGPT-B step at float32
                (bs 32) and ViT-L/16 @256 at dropout 0.15 at float32 (bs
                64, ``train_vit.py --mixed false``'s step: K1 24 and K2 24,
                all fp32 with dropout): the launches of one step, all of
                them fp32 forms; the first step's loss (and perceptual loss)
                and gradient norm against the plain versions within 1e-5
                (ViT-L's logits too, from the same generator state); one
                warm-up and two timed steps; peak memory;
 14. train_vit_entry — ``python -m vit_tpu_torch.train_vit --dataset
                synthetic --no_wandb --epochs 1 --steps_per_epoch 5
                --log_every 1`` (ViT-L/16 @256, dropout 0.15, bs 64) as a
                subprocess, then the same with ``--mixed false``: exit code
                0, five finite losses and the eval line; checkpoints and
                logs in a temporary directory;
 15. train_titok_entry — ``python -m vit_tpu_torch.train_titok`` at the
                flagship defaults with ``--dataset synthetic --bs 64
                --perceptual_weights random``: a subprocess sent SIGTERM
                after step 5 exits 0 with PREEMPTED and a "last" at step 5
                or later; ``--resume`` continues from it for 3 steps; 3
                steps each under ``--mixed false`` and
                ``--perceptual_quant int8``, the first with ``--latent_dim
                6`` (K5's runtime-D form), the second with ``--watch``
                (each histogram counts its tensor's elements; the step time
                beside the plain run's); ``--quantizer fsq`` (K1-K4, no
                K5; the usage finite) with ``--ema_decay 0.999`` (the
                "last" average apart from the parameters, then one
                ``--resume`` step that continues it: e·d + p·(1 − d) of the
                saved one); these
                call the entry's ``main`` in this process with the
                launches counted (K1-K5, their fp32 forms, K12a/K12b); step
                times; a TiTok-B
                checkpoint (fp32 parameters, bf16 μ, fp32 ν) saved as
                "best" and "last" and restored bit for bit, with the seconds
                of each save;
 16. train_titok_converge — the committed S-scale TPU run
                (``runs/titok-synthetic/8px_64px_S_32_1024.jsonl``: TiTok-S
                at image 64, bs 64, 25 epochs of 100 steps on the shapes
                stream) with its ``_config`` through the entry's ``main``,
                for its first 4 epochs (``--converge_epochs 25``: the whole
                run): the median recon loss of the logs at steps 226-376
                within twice the TPU run's and below a tenth of step 1's
                (the whole run: also the last four logs' median); the curve
                beside the TPU run's; the run's "best" weights encode 128
                held-out shapes images through the kernels and the plain
                versions: code agreement, every differing code a near-tie,
                the reconstructions' PSNR;
 17. train_videogpt_entry — ``python -m vit_tpu_torch.train_videogpt``
                through its ``main`` in this process: (a) at the reference
                defaults (VideoGPT-B, 16 frames × 64 codes = S 1024, bs 32,
                codebook 1024) over ``--tokenizer_ckpt random``, SIGTERM
                during its fourth step (PREEMPTED, "last" and the crop
                count saved), then ``--resume`` to the end of the epoch
                from the saved step and crop; its first step's loss again
                through the kernels and through the plain versions (codes
                every flip a near-tie); a VideoGPT-B state saved and
                restored bit for bit, with the seconds; (b) over phase
                16's "best" TiTok-S (32 codes: S 512) for 3 steps, the
                step-0 generation eval's codes in range and equal to a
                direct ``generate_frames`` call; each run's launches and
                step times.

 18. data     — the data layer on fixtures the phase writes (96 DMLab
                clips, ``np.savez`` uncompressed, ``video`` (300, 64, 64, 3)
                uint8 and ``actions`` (300,); npy/cls/json tar shards):
                ``train_videogpt`` at its defaults (``--dataset dmlab``,
                VideoGPT-B, bs 32, S 1024: K1, K5, K6, K8) and
                ``train_titok --dataset dmlab --image_size 64`` at TiTok-B
                (bs 64, perceptual loss: K1-K5) for 3 steps each through
                their ``main``, the first batch on the card against the
                numpy batch of the same clips bit for bit (the tokenizer's
                frames each a frame of its clip), each loader's batches a
                second alone, the step times and batch waits beside the same
                entry on its synthetic stream; the shards through
                ``StreamingWebDataset`` and ``StreamingBatcher`` against
                ``iterate_shard``; where Pillow is here, ``train_vit
                --dataset imagenet``, ``--dataset wds --wds_streaming
                true`` and ``train_titok --dataset imagenet`` on JPEGs it
                writes; for each missing decoder, the refusal naming it;
 19. repro    — two 2-step ``train_titok`` runs at TiTok-B from one seed:
                every gradient and parameter bit for bit after every step.
 20. serve_export — ``python -m vit_tpu_torch.export_tokenizer``'s ``main``
                from "best" checkpoints of random weights that the phase
                writes with ``Checkpointer.save``, each export served over
                HTTP: TiTok-B at the flagship width fp and int8 (``--bs 0``:
                requests of 8 and 64 images as they come; /encode and
                /decode equal to a direct call of the live model or its
                int8 twin, then timed fp, int8, int8, fp), ViT-L/16 @256
                int8 (/predict; its logits against the live fp model's, top-1
                agreement above 0.5), VideoGPT-B's greedy rollout at bs 1
                (512 codes in, 128 out; fp then int8, each equal to a direct
                generate; generated tokens/s), ViT-VQGAN-B, TATiTok-S (image
                64) and LlamaGen-TiTok-S int8 and the enhancing ViT-VQGAN fp
                at their entries' defaults (equal to direct calls); every
                int8 tokenizer's fidelity fields within the JAX test's bounds
                (agreement > 0.5, PSNR > 20 dB); K1 and K5 launched by every
                tokenizer request, K1 24 by the ViT-L predict, K6 12 by a
                rollout; the sizes of ``weights.npz``.

``--entries_only`` runs the device, build and the last five phases alone,
``--pretrain_only`` the device, build and pretrain phases,
``--tatitok_only`` the device, build and tatitok phases, and
``--families_only`` the device, build and families phases, and
``--serve_only`` the device, build and serve_export phases (no kernels
line, no closing line).

Then the kernels' summary line (each attention kernel with its dropout
arm's numbers and its dropout launches, and again at head_dim 32 as
``*_d32`` with the pretrain phase's numbers and launches; each kernel with an fp32 form with
its ``fp32`` numbers and ``fp32_launches``; K1, K2 and K5 with the
families phase's numbers as ``families``; P as ``fma_probe``), the card's
name and power limit,
and as the last line ``{"ok": true, "device": {...}}``. Any failure raises, so the
script exits non-zero without that line. It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import math
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
if not (ROOT / "vit_tpu_torch" / "__init__.py").exists():
    raise SystemExit(f"chip_smoke.py: no vit_tpu_torch package beside it in {ROOT}")
sys.path.insert(0, str(ROOT))

from vit_tpu_torch.bench_kernels import batched_ms  # noqa: E402
from vit_tpu_torch.bench_kernels import device_ms  # noqa: E402
from vit_tpu_torch.bench_kernels import exact_attention_fwd  # noqa: E402
from vit_tpu_torch.bench_kernels import exact_fc_grad  # noqa: E402
from vit_tpu_torch.bench_kernels import exact_ln_matmul_fwd  # noqa: E402
from vit_tpu_torch.bench_kernels import exact_tail_bwd  # noqa: E402
from vit_tpu_torch.bench_kernels import exact_tail_fwd  # noqa: E402
from vit_tpu_torch.bench_kernels import fc_grad_reduction_ms  # noqa: E402
from vit_tpu_torch.bench_kernels import mean_rel  # noqa: E402
from vit_tpu_torch.bench_kernels import two_part_fc_grad  # noqa: E402
from vit_tpu_torch.bench_kernels import two_part_ln_matmul_fwd  # noqa: E402
from vit_tpu_torch.bench_kernels import two_part_tail_bwd  # noqa: E402
from vit_tpu_torch.bench_kernels import two_part_tail_fwd  # noqa: E402
from vit_tpu_torch.bench_kernels import two_parts  # noqa: E402
from vit_tpu_torch.kernels import _build  # noqa: E402
from vit_tpu_torch.kernels import attention as k_attn  # noqa: E402
from vit_tpu_torch.kernels import convnext_block as k_cnx  # noqa: E402
from vit_tpu_torch.kernels import depthwise as k_dw  # noqa: E402
from vit_tpu_torch.kernels import fc_grad as k_fc  # noqa: E402
from vit_tpu_torch.kernels import fma_probe as k_fma  # noqa: E402
from vit_tpu_torch.kernels import ln_matmul as k_lnmm  # noqa: E402
from vit_tpu_torch.kernels import vq as k_vq  # noqa: E402
from vit_tpu_torch.data import decoders  # noqa: E402
from vit_tpu_torch.data.synthetic import SyntheticVideoLoader  # noqa: E402
from vit_tpu_torch.losses.perceptual import ConvNeXt, PerceptualLoss  # noqa: E402
from vit_tpu_torch.models.pretrained import FrozenTokenizer  # noqa: E402
from vit_tpu_torch.models.titok import TiTok, TiTokConfig  # noqa: E402
from vit_tpu_torch.models.videogpt import (VideoGPT,  # noqa: E402
                                           VideoGPTConfig, generate,
                                           generate_frames, init_cache)
from vit_tpu_torch.models.vit import ViTClassifier, ViTConfig  # noqa: E402
from vit_tpu_torch.ops.gelu import gelu_grad, tanh_erf_gelu  # noqa: E402
from vit_tpu_torch.serve.export import (export_tokenizer,  # noqa: E402
                                        export_videogpt)
from vit_tpu_torch.serve.server import make_server  # noqa: E402
from vit_tpu_torch.data.synthetic import SyntheticImageLoader  # noqa: E402
from vit_tpu_torch.train.checkpoint import Checkpointer  # noqa: E402
from vit_tpu_torch.train.checkpoint import load_params  # noqa: E402
from vit_tpu_torch.train.optim import make_optimizer  # noqa: E402
from vit_tpu_torch.train.state import TrainState  # noqa: E402
from vit_tpu_torch.train.step import (make_classifier_train_step,  # noqa: E402
                                      make_tokenizer_train_step,
                                      make_videogpt_train_step)
from vit_tpu_torch.utils.init import init_convnext_, init_params_  # noqa: E402
from vit_tpu_torch.utils.metrics import psnr  # noqa: E402

FLAGSHIP = dict(image_size=128, patch_size=16, latent_tokens=256,
                codebook_size=2048, latent_dim=12, transformer="B")
K1_MAX_ABS, K1_MEAN_ABS = 2e-2, 2e-3   # bf16 p is rounded at other places
K1_STATS_REL = 1e-4   # fp32 m and l: the same products summed in another order
# bf16 outputs of K2, K3, K4 against their plain versions, relative to the
# largest |plain| value (max) and to the mean |plain| value (mean): the
# kernels round the same fp32 values to bf16 at the same points, but an fp32
# value one ulp apart rounds one bf16 ulp (2^-8 relative) the other way, and
# that difference travels through the next product.
BWD_MAX_REL, BWD_MEAN_REL = 2e-2, 1e-2
# The wgmma backwards (K2, K7/K8 and their dropout arms) keep the plain
# versions' rounding points, so their outputs differ from the plain
# versions' only where an fp32 value one ulp apart rounds the other way.
# Mean readings on an H100: 1.6e-7 to 4.0e-6 for dq, dk, dv (dqkv), up to
# 8.0e-6 for K2's fp32 dbias (its dropout arm). The limit is 10× the
# largest; rounded_ph_control, ph rounded to bf16 before Δ and ds take it,
# reads 2.5e-3 to 3.1e-3 and must fail it.
WGMMA_BWD_MEAN_REL = 8e-5
# The wgmma forwards (K1, K6 and their dropout arms) keep the plain
# versions' rounding points as well: mean readings on an H100 7.7e-8 to
# 4.3e-6 of mean |plain| (K1 up to 1.3e-6; K6 at (2, 777) unmasked the
# largest). The limit is 10× the largest; normalised_p_control, p
# normalised before its bf16 cast (bf16(p/l)·v), reads 3.8e-4 to 2.3e-3
# and must fail it.
WGMMA_FWD_MEAN_REL = 4.3e-5
# K3 and K4 keep the plain versions' rounding points too, so their means
# against the plain versions are ulp flips of the bf16 output: 8.9e-7 to
# 1.36e-5 here on an H100 (K4 at C 384 the largest) for the wgmma kernels,
# as for the mma.sync ones before them. The limit is 10x the largest;
# rounded_tail_control, z rounded to bf16 before b1 and GELU (K3) and da
# rounded before gelu' (K4), reads 1.36e-3 and 2.83e-3 and must fail it.
TAIL_MEAN_REL = 1.36e-4
K5_TIE_GAP = 1e-6   # the kernel's fp32 scores of order 1e-3 against fp64
K5_PLAIN_ULPS = 8   # the plain version's fp32 distance, in ulps of its terms
# K5's runtime-D form: odd and wide latent widths, at C 2048 and 16384
K5_ANY_DIMS = (5, 6, 24, 64, 101, 200, 256, 1024)
# and wider than 1024 (ROADMAP Queue C #4), at C 2048: held to fp64 scores
# within K5_TIE_GAP as the narrower ones (the kernel read a regret of 0.0 at
# N 16384 × C 2048, with and without L2, on an H100)
K5_WIDE_DIMS = (2048, 4096)
# Kernels vs plain versions through the whole bf16 model: one ulp of
# difference in attention spreads through the residual stream's bf16
# roundings. Measured on an H100 with these random weights: latents 0.7%
# apart, 98.2% of codes equal; two plain attention variants (p normalised
# before or after the bf16 cast) agree on 98.3% of codes.
MAX_REL_ERR = 2e-2
MIN_INDEX_AGREEMENT = 0.95
# The first training step with the kernels and through the plain versions,
# from the same weights and batch: the bf16 forward differs at ulp level
# (above), so codes may flip and move the quantizer's loss and the
# codebook's gradient. Measured on an H100 with these weights: losses 1.8e-5
# and the gradient norm 7.4e-6 apart; the bounds leave room for code flips.
STEP_LOSS_REL, STEP_GRAD_NORM_REL = 1e-3, 1e-2
TRAIN_BS = 64
# (stage, blocks, rows at bs 64, C) of ConvNeXt-S at 224: the fused tails
CNX_STAGES = ((0, 3, TRAIN_BS * 56 * 56, 96), (1, 3, TRAIN_BS * 28 * 28, 192),
              (2, 27, TRAIN_BS * 14 * 14, 384))
# The kernels that only a switch launches (fused LN and FC, dw_impl, int8)
SWITCHED_OFF = dict(ln_matmul_fwd=0, ln_matmul_dgelu=0, ln_bwd=0, fc_grad=0,
                    depthwise_fwd=0, depthwise_bwd=0, depthwise_bwd_dx_only=0,
                    convnext_tail_fwd_q8=0, convnext_tail_bwd_q8=0)
STEP_LAUNCHES = dict(attention_packed_fwd=24, attention_packed_bwd=24,
                     convnext_tail_fwd=66, convnext_tail_bwd=33, vq_nearest=1,
                     attention_fwd=0, attention_bwd=0, **SWITCHED_OFF)
# The same step under VIT_TPU_FUSED_LN=1 VIT_TPU_FUSED_FC=1: K9a at the qkv
# and fc1 sites of the 24 layers (encoder and decoder), K9b at fc1, K9c in
# both sites' backward, K10 at fc2 (fc1's gradient comes from K9a's
# backward); and under VIT_TPU_FUSED_LN=0 VIT_TPU_FUSED_FC=1: K10 at fc1
# and fc2.
FUSED_STEP_LAUNCHES = dict(STEP_LAUNCHES, ln_matmul_fwd=48, ln_matmul_dgelu=24,
                           ln_bwd=48, fc_grad=24)
FC_STEP_LAUNCHES = dict(STEP_LAUNCHES, fc_grad=48)
# The same step with PerceptualLoss(quant="int8"): K12a at the 33 fused
# blocks of both images, K12b at the reconstruction's, no K3/K4.
INT8_STEP_LAUNCHES = dict(STEP_LAUNCHES, convnext_tail_fwd=0,
                          convnext_tail_bwd=0, convnext_tail_fwd_q8=66,
                          convnext_tail_bwd_q8=33)
# The perceptual loss and its image gradient alone (36 blocks, both images
# forward, x backward), per call and arm; the kernels of the other arms 0.
PERCEPTUAL_BS = 64
PERCEPTUAL_ARMS = (("lax", "none"), ("pallas", "none"), ("lax", "int8"),
                   ("pallas", "int8"))
# The perceptual phase's net has γ around 0.5 (the init's 1e-6 would hide
# every tail under the residual), so the kernels' bf16 roundings, and the
# int8 levels they flip, travel through 36 blocks and back: loss within 1e-2
# of the plain versions', the image gradient within 1e-1 of max |plain| and
# of mean |plain|. Measured on an H100: the default arm, whose only kernels
# are K3 and K4, loss 1.6e-4 and gradient 2.6e-2 (max) / 2.7e-2 (mean); the
# int8 arms 5.6e-4 and 4.7e-2 / 5.1e-2. Each kernel alone is held far
# tighter in the kernel phase.
PERCEPTUAL_LOSS_REL = 1e-2
PERCEPTUAL_GRAD_MAX_REL = PERCEPTUAL_GRAD_MEAN_REL = 1e-1
# The int8 perceptual loss against the bf16 one on the same batch: the JAX
# package's own bound (tests/test_convnext_block.py:207).
INT8_LOSS_GAP = 0.2
# K11 against its plain version: fp32 within 2e-5 of max |plain| (the same
# sums, fused multiply-adds), bf16 within one bf16 ulp; dw and db, sums over
# the batch in another order, within 1e-4 of max |plain|. K12 within 1e-2 of
# max |plain| (an int8 level flips where the fp32 values round apart).
K11_REL, K11_DW_REL, K12_REL = 2e-5, 1e-4, 1e-2
# K11's means against its plain version, mean |Δ| over mean |plain|: fp32 y
# and dx (the same fp32 sums, contracted into fused multiply-adds) and dw and
# db in both dtypes (sums over the batch in another order). Each limit is
# 10× the largest reading of the kernels this design replaced (rounded up),
# read on an H100 at every shape of K11_SHAPES in fp32 and bf16 (y and dx
# 5.95e-8 to 8.29e-8; dw and db 7.3e-9 to 3.62e-7, fp32 db at stage 0 the
# largest; bench_kernels.py's "k11_mean_rel" reads them on that commit).
# Their controls must fail them: the fp32 plain version on operands rounded
# to bf16 (y, dx: 1.9e-3 to 2.3e-3), and dw and db summed from per-image
# partial sums rounded to bf16 (1.3e-3 to 1.9e-3).
K11_MEAN_REL = 8.29e-7
K11_DW_MEAN_REL = 3.63e-6
# (N, H, W, C) of ConvNeXt-S's four stages at bs 64 (3, 3, 27 and 3 blocks
# of the perceptual loss), and a ragged shape: W past two 14-column tiles,
# H past one, C not a multiple of the kernels' 32-channel groups
K11_STAGES = ((TRAIN_BS, 56, 56, 96), (TRAIN_BS, 28, 28, 192),
              (TRAIN_BS, 14, 14, 384), (TRAIN_BS, 7, 7, 768))
K11_SHAPES = K11_STAGES + ((3, 13, 37, 40),)
N_ROWS = TRAIN_BS * 320   # rows of every transformer layer of the step
# VideoGPT-B (train_videogpt.py's defaults): 16 frames of 64 codes from a
# random TiTok-S at image 64, patch 8 (its encoder at S = 128), bs 32.
VIDEOGPT = dict(frame_size=64, codebook_size=1024, transformer="B",
                max_frames=16)
VIDEO_TOKENIZER = dict(image_size=64, patch_size=8, latent_tokens=64,
                       codebook_size=1024, latent_dim=12, transformer="S")
VIDEO_BS = 32
# One step: 12 layers of K6 and K7/K8 (S 1024), 6 encoder layers of K1
# without statistics (the frozen tokenizer, S 128), one K5 over 32·16·64 codes
VIDEO_STEP_LAUNCHES = dict(attention_packed_fwd=6, attention_packed_bwd=0,
                           convnext_tail_fwd=0, convnext_tail_bwd=0,
                           vq_nearest=1, attention_fwd=12, attention_bwd=12,
                           **SWITCHED_OFF)
# The prefill's last-position logits with the kernels and through the plain
# versions: bf16 noise through 12 layers, as the TiTok-B slice's latents.
PREFILL_MAX_REL = 2e-2
ROLLOUT_COND, ROLLOUT_GEN = 8, 2    # frames in, frames out (cut from 8 out)
# Published peaks of one H100 SXM (NVIDIA's data sheet; dense, at 700 W):
# the bound of a kernel is the larger of its operations over the peak rate
# for their type and its bytes (each input read once, each output written
# once) over the memory rate.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_FP32_FLOPS = 67e12
# The fp32-accurate products of three bf16 parts: six bf16 products for
# each fp32 one on the tensor cores (the TPU's Precision.HIGHEST)
PEAK_SPLIT_FLOPS = PEAK_BF16_FLOPS / 6
PEAK_BYTES_PER_S = 3.35e12
# The dropout hash (csrc/dropout.cuh) runs on the CUDA cores: 64 INT32
# operations per clock per SM, 132 SMs at the 1.98 GHz boost clock; about 13
# integer operations per hashed score element, once in a forward and in each
# of a backward's three passes over the scores.
PEAK_INT32_OPS = 64 * 132 * 1.98e9
HASH_INT_OPS = 13
# The attention kernels' dropout arms: ViT-L/16 @256's K1/K2 at rate 0.15
# (train_vit.py's default), VideoGPT-B's K6/K8 and K7's shape at 0.1. The
# dropped fraction of a mask must lie within 5σ of the rate.
VIT_DROPOUT, GPT_DROPOUT = 0.15, 0.1
DROP_SIGMAS = 5.0
# bench_extra.py's two classifier configs (:29-54, :79-104): (image, patch,
# preset, dropout) at bs 64, 1000 classes, one class token, and
# make_optimizer(1e-4, 5000, 500000, 1e-5, 1e-2, clip_norm=None).
VIT_BS, VIT_CLASSES = 64, 1000
VIT_CELLS = {"vit_b16_224": (224, 16, "B", 0.0),
             "vit_l16_256_drop0.15": (256, 16, "L", VIT_DROPOUT)}
# P, the FMA-rate probe, at scripts/bench_vpu.py's defaults. Its bound: the
# CUDA cores' FMA issue rate, 128 FP32 lanes per SM on 132 SMs at the 1.98
# GHz boost clock (bf16: two elements per lane, packed).
FMA_ITERS, FMA_STEPS = 4096, 20
# P's bf16 parity at constants where each step changes a: (c, d), steps
FMA_GROWTH, FMA_GROWTH_ITERS = (1 + 2.0 ** -7, 2.0 ** -10), 256
FMA_LANES, BOOST_HZ = 128 * 132, 1.98e9
# P's best fp32 rate once the fma_probe phase has measured it (2 FLOP a
# multiply-add), reported beside the bounds; every fp32 bound takes the
# published PEAK_FP32_FLOPS.
measured = {"fp32_flops": PEAK_FP32_FLOPS}
# The fp32 forms against their fp32 plain versions, relative to the largest
# and the mean |plain| value: the same sums in another order, measured at
# 1e-7 to 2e-6 on an H100. 1e-5, a hundredth of the BASELINE.md golden
# contract's 1e-3, so that a form multiplying in TF32 (10 mantissa bits)
# fails: the TF32 control in fp32_kernels must. K12's fp32-row form stays
# at K12_REL on the max (an int8 level flips where two fp32 values round
# apart), FP32_REL on the mean.
FP32_REL = 1e-5
# The fp32 backward (K2, K7/K8 on fp32 operands, split into three bf16
# parts): 10× the largest mean of the SIMT fp32 kernels it replaced, held
# against the same plain versions on an H100 by this script at the parent
# commit, dropout arms included (dq, dk 4.0e-8 to 6.6e-8, dv equal, K2's
# dqkv 1.1e-7 to 1.2e-7 and dbias 3.4e-7 to 3.5e-7). A split that lost its
# third part, two_part_control (the plain backward on q, k, v and dO
# rounded to 16-bit significands), reads 4.4e-6 to 6.1e-6 and must fail
# it; FP32_REL's TF32 control fails both.
F32_BWD_MEAN_REL = 3.5e-6
# The fp32 forward (K1, K6 on fp32 operands, split into three bf16 parts):
# 10× the largest mean of the SIMT fp32 forward it replaced against the
# plain fp32 version, read on an H100 by bench_kernels.py at the parent
# commit (o, m and l of K1, K6, their dropout arms and K6 at K7's shape:
# 0 for m, 3.0e-8 to 3.33e-8 for o and l). That limit lies below the plain
# fp32 version's own mean distance from the same math in float64 (o
# 2.2e-7 to 3.7e-7, m 9.6e-8, l 2.6e-7 to 2.8e-7 there): the SIMT kernel
# summed q·kᵀ and P·V in cuBLAS's FMA order (its m equal to the plain
# version's to the bit), which no tensor-core product repeats, and against
# the plain version the split kernel reads 2.4e-7 to 4.0e-7. So the fp32
# forms are held to it against the float64 forward
# (bench_kernels.exact_attention_fwd), where they read 6.7e-8 to 1.7e-7,
# closer than the plain version; a split that lost its third part,
# two_part_fwd_control (the plain forward on q, k and v rounded to 16-bit
# significands), reads 1.1e-6 to 4.1e-6 there and must fail it.
F32_FWD_MEAN_REL = 3.33e-7
# K3's fp32 form (three bf16 parts, six wgmma products an fp32 product)
# against the float64 tail (bench_kernels.exact_tail_fwd), mean |Δ| over
# mean |exact|, read on an H100 by this script's fp32 phase at ConvNeXt-S's
# three fused stages: 5.10e-8 (C 96) to 5.65e-8 (C 384). 10× the largest.
# Against the plain fp32 tail it is held to SIMT_F32_MEAN_REL["K3"] as
# well, but that limit cannot tell a split that lost its third part: the
# two-part control (bench_kernels.two_part_tail_fwd: u, a and the weights
# rounded to x0 + x1) reads below it against the plain tail
# ("two_part_control_plain" in this script's fp32 phase). Against float64
# it reads 1.21e-6 to 1.23e-6 and must fail this limit.
F32_TAIL_MEAN_REL = 5.65e-7
# K4's fp32 form likewise against the float64 tail gradient
# (bench_kernels.exact_tail_bwd), mean |Δ| over mean |exact|, read on an
# H100 at ConvNeXt-S's three fused stages and N 777: 1.94e-7 (C 96) to
# 2.21e-7 (C 384), where the plain fp32 backward reads 2.8e-7 to 7.6e-7.
# 10× the largest; the two-part control (bench_kernels.two_part_tail_bwd:
# u, do, dz and the weights rounded to x0 + x1) reads 5.58e-6 to 5.65e-6
# and must fail it.
F32_TAIL_BWD_MEAN_REL = 2.21e-6
# K9a's fp32 form (six bf16 wgmma products an fp32 product, each 64-wide
# atom of C in a fresh accumulator) against the float64 K9a
# (bench_kernels.exact_ln_matmul_fwd), mean |Δ| over mean |exact|, read on
# an H100 by this script's fp32 phase at qkv and fc1 (20480, 768 → 2304 /
# 3072) and the edge shapes (77, 512 → 2048), (77, 1024 → 4096), (130, 768
# → 384): z 1.03e-7 to 1.30e-7, zpre 9.7e-8 to 1.10e-7, where the plain
# fp32 K9a reads 2.6e-7 to 3.5e-7 on the CPU. 10× the largest; the
# two-part control (bench_kernels.two_part_ln_matmul_fwd: x̂ and W rounded
# to x0 + x1) reads 3.31e-6 to 3.63e-6 and must fail it.
F32_LNMM_MEAN_REL = 1.30e-6
# K10's fp32 form (six bf16 wgmma products of three bf16 parts an fp32
# product, each 32-row atom of N in a fresh accumulator, split partials
# added in a fixed order) against the float64 dW
# (bench_kernels.exact_fc_grad), mean |Δ| over mean |exact|, read on an
# H100 at fc2 (20480, 768 ← 3072), fc1 and N 20481: 1.619e-7 to 1.626e-7,
# where the plain fp32 product (cuBLAS) reads 8.40e-7 to 8.41e-7. 10× the
# largest; the two-part control
# (bench_kernels.two_part_fc_grad: g and x rounded to x0 + x1) reads
# 3.573e-6 to 3.578e-6 and must fail it.
F32_FCGRAD_MEAN_REL = 1.63e-6
# K9a and K9c against their plain versions, mean |Δ| over mean |plain|:
# ulp flips of the bf16 outputs (the fp32 forms: sums in another order),
# read on an H100 by this script at 0 to 2.52e-6 (K9a's z at (130, 768 →
# 384) the largest; K9c up to 7.7e-8; the fp32 forms 4.2e-8 to 1.5e-7; the
# fused step's and the fused encode's launches up to 1.32e-6). 10× the
# largest; ln_stats_control (the LayerNorm statistics rounded to bf16)
# reads 1.46e-3 and 2.94e-3 and must fail it.
LN_MEAN_REL = 2.5e-5
# The bf16 K10's fp32 dW and db against its plain version (an fp32 product
# of the bf16 operands), mean |Δ| over mean |plain|: sums over N in another
# order, read on an H100 by this script at fc2 (20480, 768 ← 3072), fc1
# and N 20481 in two runs: dW 5.553e-6 to 5.565e-6, db 7.93e-8 to
# 8.34e-8. 10× the largest of each, beside the max limits (1e-3, 1e-4);
# k10_control (dW and db summed from four per-split partial sums rounded
# to bf16) reads 1.57e-3 to 1.71e-3 and must fail them.
K10_DW_MEAN_REL = 5.57e-5
K10_DB_MEAN_REL = 8.34e-7
# K12a and K12b likewise: int8 levels that flip where two fp32 values round
# apart, read at 1.6e-8 to 3.64e-6 (bf16) and 1.07e-6 and 3.86e-6 (fp32
# rows, K12b the largest). 10× the largest; per_tensor_scale_control (one
# scale for each activation operand in place of per-row scales) reads
# 6.77e-3 and 4.35e-2 and must fail it.
Q8_MEAN_REL = 3.86e-5
# The SIMT fp32 forms (K3, K4, K9a, K10 on fp32 operands; K9b, K9c, K12a
# and K12b on fp32 rows) against their fp32 plain versions, mean |Δ| over
# mean |plain|: the same sums in another order (K12: int8 levels that flip
# where two fp32 values round apart), read on an H100 by this script's fp32
# phase (seed 7) at each form's shapes, the largest of its outputs and
# widths: K3 1.75e-7 (C 384), K4 2.99e-7, K9a 1.53e-7 (z), K9b 1.2e-8, K9c
# 2.97e-8, K10 1.35e-6 (dW), K12a 1.07e-6, K12b 3.86e-6. Each limit is 10×
# its form's reading, held beside FP32_REL (tighter for K10 and K12a); its
# control must fail it: the plain version with TF32 on in the form's place
# for K3, K4, K9a and K10 (their products: 1.1e-4 to 4.7e-4), on operands
# rounded to bf16 for K9b, K9c, K12a and K12b (no fp32 product to round:
# 1.4e-3 to 1.9e-2).
SIMT_F32_MEAN_REL = {"K3": 1.75e-6, "K4": 3.0e-6, "K9a": 1.54e-6,
                     "K9b": 1.2e-7, "K9c": 2.97e-7, "K10": 1.35e-5,
                     "K12a": 1.07e-5, "K12b": 3.86e-5}
# The fp32 paths' first steps against the plain versions' (loss, perceptual
# loss, gradient norm; ViT-L's logits), relative: measured at 0 to 1e-7.
FP32_STEP_REL = 1e-5
# The flagship step at float32 under its three settings:
# (VIT_TPU_FUSED_LN, VIT_TPU_FUSED_FC, the perceptual loss's quant)
FP32_SETTINGS = {"unfused": ("0", "0", "none"), "fused": ("1", "1", "none"),
                 "int8": ("0", "0", "int8")}
FP32_STEP_LAUNCHES = {"unfused": STEP_LAUNCHES, "fused": FUSED_STEP_LAUNCHES,
                      "int8": INT8_STEP_LAUNCHES}
# The kernels with an fp32 form, whose fp32 launches the kernels line
# carries (K5 is fp32 by design, K11 takes either dtype)
FP32_FORMS = ("attention_packed_fwd", "attention_packed_bwd",
              "convnext_tail_fwd", "convnext_tail_bwd", "attention_fwd",
              "attention_bwd", "ln_matmul_fwd", "ln_matmul_dgelu", "ln_bwd",
              "fc_grad", "convnext_tail_fwd_q8", "convnext_tail_bwd_q8")


T0 = time.perf_counter()


def emit(phase: str, **kw) -> None:
    """One JSON line for a phase, with the seconds since the script began."""
    print(json.dumps({"phase": phase, "elapsed_s": round(
        time.perf_counter() - T0, 1), **kw}), flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def median_ms(fn, reps: int = 20) -> float:
    """CUDA-event median of ``fn`` after warm-up."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def host_median_ms(fn, reps: int = 10) -> float:
    """Host-clock median of ``fn``, which must end synchronised."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def reset_launches() -> None:
    k_attn.reset_head_dim_launches()
    k_attn.launches = k_attn.bwd_launches = 0
    k_attn.unpacked_launches = k_attn.unpacked_bwd_launches = 0
    k_attn.dropout_launches = k_attn.dropout_bwd_launches = 0
    k_attn.unpacked_dropout_launches = k_attn.unpacked_dropout_bwd_launches = 0
    k_cnx.launches = k_cnx.bwd_launches = 0
    k_vq.launches = 0
    k_lnmm.launches = k_lnmm.dgelu_launches = k_lnmm.ln_bwd_launches = 0
    k_fc.launches = 0
    k_dw.launches = k_dw.bwd_launches = k_dw.dx_only_launches = 0
    k_cnx.q8_launches = k_cnx.q8_bwd_launches = 0
    k_attn.fp32_launches = k_attn.fp32_bwd_launches = 0
    k_attn.unpacked_fp32_launches = k_attn.unpacked_fp32_bwd_launches = 0
    k_cnx.fp32_launches = k_cnx.fp32_bwd_launches = 0
    k_cnx.q8_fp32_launches = k_cnx.q8_fp32_bwd_launches = 0
    k_lnmm.fp32_launches = k_lnmm.fp32_dgelu_launches = 0
    k_lnmm.fp32_ln_bwd_launches = k_fc.fp32_launches = 0
    k_fma.launches = 0


def read_launches() -> dict:
    return dict(attention_packed_fwd=k_attn.launches,
                attention_packed_bwd=k_attn.bwd_launches,
                convnext_tail_fwd=k_cnx.launches,
                convnext_tail_bwd=k_cnx.bwd_launches,
                vq_nearest=k_vq.launches,
                attention_fwd=k_attn.unpacked_launches,
                attention_bwd=k_attn.unpacked_bwd_launches,
                ln_matmul_fwd=k_lnmm.launches,
                ln_matmul_dgelu=k_lnmm.dgelu_launches,
                ln_bwd=k_lnmm.ln_bwd_launches, fc_grad=k_fc.launches,
                depthwise_fwd=k_dw.launches, depthwise_bwd=k_dw.bwd_launches,
                depthwise_bwd_dx_only=k_dw.dx_only_launches,
                convnext_tail_fwd_q8=k_cnx.q8_launches,
                convnext_tail_bwd_q8=k_cnx.q8_bwd_launches)


def read_fp32_launches() -> dict:
    """The wrappers' launches of their fp32 forms; K5's, fp32 by design."""
    return dict(attention_packed_fwd=k_attn.fp32_launches,
                attention_packed_bwd=k_attn.fp32_bwd_launches,
                convnext_tail_fwd=k_cnx.fp32_launches,
                convnext_tail_bwd=k_cnx.fp32_bwd_launches,
                vq_nearest=k_vq.launches,
                attention_fwd=k_attn.unpacked_fp32_launches,
                attention_bwd=k_attn.unpacked_fp32_bwd_launches,
                ln_matmul_fwd=k_lnmm.fp32_launches,
                ln_matmul_dgelu=k_lnmm.fp32_dgelu_launches,
                ln_bwd=k_lnmm.fp32_ln_bwd_launches, fc_grad=k_fc.fp32_launches,
                convnext_tail_fwd_q8=k_cnx.q8_fp32_launches,
                convnext_tail_bwd_q8=k_cnx.q8_fp32_bwd_launches)


def read_head_dim_launches() -> dict:
    """The attention wrappers' launches by head width: {name: {d: n}}."""
    return copy.deepcopy(k_attn.head_dim_launches)


def read_dropout_launches() -> dict:
    """The attention wrappers' launches with dropout (a seed vector)."""
    return dict(attention_packed_fwd=k_attn.dropout_launches,
                attention_packed_bwd=k_attn.dropout_bwd_launches,
                attention_fwd=k_attn.unpacked_dropout_launches,
                attention_bwd=k_attn.unpacked_dropout_bwd_launches)


def bound(flop: float, nbytes: float, peak: float = PEAK_BF16_FLOPS,
          int_ops: float = 0.0) -> dict:
    """The least time the card could take: operations over the peak rate
    for their type (with ``int_ops``, also integer operations over the CUDA
    cores' INT32 rate), or bytes over the memory rate, whichever is
    larger."""
    ops_ms = max(flop / peak, int_ops / PEAK_INT32_OPS) * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    out = dict(bound_ms=max(ops_ms, bytes_ms),
               bound_by="operations" if ops_ms >= bytes_ms else "bytes",
               flop=flop, bytes=nbytes)
    if int_ops:
        out.update(int_ops=int_ops, products_ms=flop / peak * 1e3,
                   hash_ms=int_ops / PEAK_INT32_OPS * 1e3, bytes_ms=bytes_ms)
    return out


def attention_bound(b: int, h: int, s: int, causal: bool, backward: bool,
                    extra_bytes: float = 0.0, dropout: bool = False,
                    elem: int = 2, peak: float = PEAK_BF16_FLOPS,
                    d: int = 64) -> dict:
    """Attention over (b, h, s, d) operands of ``elem`` bytes (bf16; 4 for
    the fp32 forms, at ``peak`` = the published fp32 rate): 2 products of 2·d FLOP
    per unmasked (query, key) pair forward, 5 backward; q, k, v (and dO)
    read and out (dq, dk, dv) written once, m and l in fp32. With dropout,
    the hash's integer operations once on every unmasked pair, forward and
    backward alike: the least work needs the mask once (the kernels'
    two-kernel backward hashes it three times)."""
    pairs = s * (s + 1) // 2 if causal else s * s
    tile = b * h * s * d * elem
    stats = 2 * b * h * s * 4
    int_ops = HASH_INT_OPS * pairs * b * h if dropout else 0.0
    if backward:
        return bound(10 * d * pairs * b * h,
                     4 * tile + stats + 3 * tile + extra_bytes,
                     peak=peak, int_ops=int_ops)
    return bound(4 * d * pairs * b * h, 3 * tile + tile + stats + extra_bytes,
                 peak=peak, int_ops=int_ops)


def sdpa_backend(q, k, v, causal: bool) -> str:
    """The backend ``F.scaled_dot_product_attention`` picks for these
    inputs (torch's own dispatch choice)."""
    from torch.nn.attention import SDPBackend

    return SDPBackend(torch._fused_sdp_choice(q, k, v, is_causal=causal)).name


def profile_window(fn) -> dict:
    """``torch.profiler`` over one call of ``fn`` (which ends synchronised):
    the device's busy time (union of its kernels' intervals) against the
    host's wall time, and the ops with the most self device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    busy_ms = busy / 1e3

    def self_ms(a):
        return getattr(a, "self_device_time_total",
                       getattr(a, "self_cuda_time_total", 0.0)) / 1e3

    top = sorted(prof.key_averages(), key=self_ms, reverse=True)[:15]
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_idle_share=1.0 - busy_ms / wall_ms,
                device_kernels=len(spans),
                top_self_device_ms=[dict(op=a.key[:80], ms=self_ms(a),
                                         calls=a.count) for a in top])


@contextlib.contextmanager
def plain_versions():
    """Route every kernel call site to the kernel's plain version, on
    whatever device the tensors are: the reference run. The autograd
    Functions look the kernels up in their modules when they run, so the
    forward, the backward and inference all follow."""
    import vit_tpu_torch.quantize.bytedance_vq as quant_bvq
    import vit_tpu_torch.quantize.vq as quant_vq

    routes = [(quant_bvq, "nearest_code", k_vq.nearest_code_ref),
              (k_attn, "attention_packed_fwd", k_attn.attention_packed_fwd_ref),
              (k_attn, "attention_packed_bwd", k_attn.attention_packed_bwd_ref),
              (k_attn, "attention_fwd", k_attn.attention_fwd_ref),
              (k_attn, "attention_bwd", k_attn.attention_bwd_ref),
              (k_cnx, "convnext_tail_fwd", k_cnx.convnext_tail_fwd_ref),
              (k_cnx, "convnext_tail_bwd", k_cnx.convnext_tail_bwd_ref),
              (quant_vq, "nearest_code", k_vq.nearest_code_ref),
              (k_lnmm, "ln_matmul_fwd", k_lnmm.ln_matmul_fwd_ref),
              (k_lnmm, "ln_matmul_dgelu", k_lnmm.ln_matmul_dgelu_ref),
              (k_lnmm, "ln_bwd", k_lnmm.ln_bwd_ref),
              (k_fc, "matmul_dw_db", k_fc.matmul_dw_db_ref),
              (k_cnx, "convnext_tail_fwd_q8", k_cnx.convnext_tail_fwd_q8_ref),
              (k_cnx, "convnext_tail_bwd_q8", k_cnx.convnext_tail_bwd_q8_ref),
              (k_dw, "depthwise_fwd", k_dw.depthwise_fwd_ref),
              (k_dw, "depthwise_bwd", k_dw.depthwise_bwd_ref)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in routes]
    for mod, name, plain in routes:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def rel_errors(out: torch.Tensor, ref: torch.Tensor) -> dict:
    """max |Δ| / max |ref| and mean |Δ| / mean |ref|, in fp32."""
    diff = (out.float() - ref.float()).abs()
    mag = ref.float().abs()
    return dict(max_abs=diff.max().item(),
                max_rel=(diff.max() / mag.max().clamp_min(1e-30)).item(),
                mean_rel=(diff.mean() / mag.mean().clamp_min(1e-30)).item())


def code_flips(kernel_lat: torch.Tensor, plain_lat: torch.Tensor,
               codebook: torch.Tensor, ik: torch.Tensor,
               ip: torch.Tensor) -> dict:
    """The tokenizer's codes with the kernels (ik) and through the plain
    versions (ip), from their latents. Any ulp of difference in attention
    flips bf16 roundings of the residual stream, so latents differ at bf16
    level and codes whose two best scores lie closer than that flip. Each
    disagreement must be such a near-tie: with unit latents zk (kernels) and
    zp (plain), the plain scores of the two codes differ by at most
    2·|zk − zp|."""
    dim = codebook.shape[-1]
    zk = F.normalize(kernel_lat.double().reshape(-1, dim), dim=-1)
    zp = F.normalize(plain_lat.double().reshape(-1, dim), dim=-1)
    e = F.normalize(codebook.double(), dim=-1)
    ik, ip = ik.reshape(-1).long(), ip.reshape(-1).long()
    bad = (ik != ip).nonzero().flatten()
    gap = (zp[bad] * e[ip[bad]]).sum(-1) - (zp[bad] * e[ik[bad]]).sum(-1)
    slack = 2 * (zk[bad] - zp[bad]).norm(dim=-1) + 1e-6
    return dict(index_agreement=(ik == ip).double().mean().item(),
                disagreeing_codes=len(bad),
                unexplained_disagreements=int((gap > slack).sum()),
                latent_max_rel_err=((kernel_lat - plain_lat).abs().max()
                                    / plain_lat.abs().max()).item())


def post(url: str, arr: np.ndarray) -> np.ndarray:
    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=300) as resp:
        return np.load(io.BytesIO(resp.read()))


@contextlib.contextmanager
def serving(export_dir: str, batch_window_ms: float):
    httpd = make_server(export_dir, port=0, warmup=True,
                        batch_window_ms=batch_window_ms, device="cuda")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is false")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=card,
         torch=torch.__version__, cuda=torch.version.cuda,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    # which decoders the data phase can use (native: whether the libjpeg
    # pipeline builds here)
    measured["decoders"] = decoders.found()
    print("decoders: " + json.dumps(measured["decoders"]), flush=True)
    return card


def kernel_name(mangled: str) -> str:
    """The kernel's own name in a mangled entry name, with its template
    arguments: the first length-prefixed identifier that ends in
    ``_kernel``, e.g. ``convnext_tail_fwd_q8_kernel<384, bf16>``."""
    types = {"f": "float", "13__nv_bfloat16": "bf16"}
    i = 0
    while i < len(mangled):
        digits = re.match(r"\d+", mangled[i:])
        if not digits:
            i += 1
            continue
        start = i + len(digits.group())
        end = start + int(digits.group())
        name = mangled[start:end]
        if name.endswith("_kernel"):
            args, j = [], end + 1
            while mangled[end:end + 1] == "I" and j < len(mangled):
                arg = re.match(r"Li(\d+)E|Lb([01])E|f|13__nv_bfloat16",
                               mangled[j:])
                if not arg:
                    break
                args.append(arg.group(1) or (arg.group(2) and ("false", "true")[
                    int(arg.group(2))]) or types[arg.group(0)])
                j += arg.end()
            return f"{name}<{', '.join(args)}>" if args else name
        i = end
    return mangled


def phase_build() -> None:
    t0 = time.perf_counter()
    lib = _build.load()
    seconds = time.perf_counter() - t0
    log = Path(lib._name + ".log")
    # ptxas's report per kernel, the mangled name cut to the kernel's own
    # name and its template argument: registers, shared memory, spills
    ptxas, name = {}, None
    for line in (log.read_text().splitlines() if log.exists() else []):
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name = kernel_name(entry.group(1))
        elif name and ("registers" in line or "spill" in line):
            ptxas[name] = (ptxas.get(name, "") + " "
                           + line.split(":", 1)[-1].strip()).strip()
    measured["ptxas"] = ptxas
    emit("build", seconds=seconds, library=Path(lib._name).name, ptxas=ptxas)


def hopper_attention_ptxas() -> dict:
    """ptxas's report (registers, spills) and the dynamic shared memory of
    the Hopper attention kernels (K6, K7/K8's dq and dk/dv kernels, their
    kBias instantiations, K1 and K2, and their fp32 forms)."""
    lib = _build.load()

    def smem(name):
        base = name.split("<")[0]
        if base == "attention_fwd_kernel":
            return lib.attention_fwd_smem(int(fp32_form(name)),
                                          head_width(name))
        return lib.attention_bwd_smem(int(base == "unpacked_bwd_dkdv_kernel"),
                                      int(fp32_form(name)), head_width(name))

    return {name: dict(ptxas=report, dynamic_smem_bytes=smem(name))
            for name, report in measured.get("ptxas", {}).items()
            if name.split("<")[0] in ("attention_fwd_kernel",
                                      "unpacked_bwd_dq_kernel",
                                      "unpacked_bwd_dkdv_kernel")}


def k1_row(b: int, s: int, h: int, causal: bool, gen,
           biased: bool = True) -> dict:
    """K1 with a bias (``biased``; else ``qkv_bias=None``, which the entry
    turns into zeros) at (b, s, h heads × 64), bf16, against its plain
    version: the output within ``K1_MAX_ABS``, ``K1_MEAN_ABS`` and
    ``WGMMA_FWD_MEAN_REL``; with statistics the same bits, m and l within
    ``K1_STATS_REL``."""
    width = h * 64
    qkv = torch.randn(b, s, 3 * width, device="cuda",
                      generator=gen).bfloat16()
    bias = (0.3 * torch.randn(3 * width, device="cuda", generator=gen)
            if biased else torch.zeros(3 * width, device="cuda"))
    out = k_attn.flash_attention_packed(qkv, h, causal=causal,
                                        qkv_bias=bias if biased else None)
    out_s, m, l = k_attn.attention_packed_fwd(qkv, bias, h, causal,
                                              emit_stats=True)
    torch.cuda.synchronize()
    ref, m_ref, l_ref = k_attn.attention_packed_fwd_ref(
        qkv, bias, h, causal, emit_stats=True)
    diff = (out.float() - ref.float()).abs()
    row = dict(B=b, S=s, H=h, causal=causal, biased=biased,
               max_abs=diff.max().item(),
               mean_abs=diff.mean().item(),
               mean_rel=rel_errors(out, ref)["mean_rel"],
               stats_out_identical=bool(torch.equal(out, out_s)),
               m_rel=((m - m_ref).abs().max() / m_ref.abs().max()).item(),
               l_rel=((l - l_ref).abs() / l_ref).max().item())
    require(bool(torch.isfinite(out).all()), f"K1 non-finite at {row}")
    require(row["max_abs"] <= K1_MAX_ABS and row["mean_abs"] <= K1_MEAN_ABS
            and row["mean_rel"] <= WGMMA_FWD_MEAN_REL,
            f"K1 disagrees with its plain version: {row}")
    require(row["stats_out_identical"] and row["m_rel"] <= K1_STATS_REL
            and row["l_rel"] <= K1_STATS_REL,
            f"K1's statistics disagree with the plain version: {row}")
    return row


def k2_row(b: int, s: int, h: int, causal: bool, gen,
           biased: bool = True) -> dict:
    """K2 with a bias (``biased``; else zeros, as a bias-free QKV gives it)
    at (b, s, h heads × 64), bf16, against its plain version on K1's (m,
    l): dqkv and dbias within ``BWD_MAX_REL``, ``BWD_MEAN_REL`` and
    ``WGMMA_BWD_MEAN_REL``."""
    width = h * 64
    qkv = torch.randn(b, s, 3 * width, device="cuda",
                      generator=gen).bfloat16()
    bias = (0.3 * torch.randn(3 * width, device="cuda", generator=gen)
            if biased else torch.zeros(3 * width, device="cuda"))
    dout = torch.randn(b, s, width, device="cuda", generator=gen).bfloat16()
    _, m, l = k_attn.attention_packed_fwd(qkv, bias, h, causal,
                                          emit_stats=True)
    dqkv, dbias = k_attn.attention_packed_bwd(qkv, bias, dout, m, l, h,
                                              causal)
    torch.cuda.synchronize()
    dqkv_ref, dbias_ref = k_attn.attention_packed_bwd_ref(
        qkv, bias, dout, m, l, h, causal)
    row = dict(B=b, S=s, H=h, causal=causal, biased=biased,
               dqkv=rel_errors(dqkv, dqkv_ref),
               dbias=rel_errors(dbias, dbias_ref))
    require(bool(torch.isfinite(dqkv).all() and torch.isfinite(dbias).all()),
            f"K2 non-finite at {row}")
    for key in ("dqkv", "dbias"):
        require(row[key]["max_rel"] <= BWD_MAX_REL
                and row[key]["mean_rel"] <= BWD_MEAN_REL
                and row[key]["mean_rel"] <= WGMMA_BWD_MEAN_REL,
                f"K2 disagrees with its plain version: {row}")
    return row


def packed_kernels(gen) -> dict:
    """K1 and K2 against their plain versions at the paths' shapes (TiTok-B's
    S 320 at bs 8 and 64, ViT-B/16's S 197 and ViT-L/16's S 257 with their
    ragged last tiles, VideoGPT's frozen-tokenizer encode, ragged causal
    tiles, VideoGPT-B's causal S 512 and the longest S), their times at the flagship step's shape (K1
    also at the serving bs 8), the ptxas figures of their kernels (the
    kBias instantiations of K6's and K7/K8's), and the control that the
    wgmma backwards' mean limit must reject."""
    summary = {}
    build = hopper_attention_ptxas()

    # K1: bf16 with bias; the serving and train steps' shapes, the ViT
    # shapes, a ragged causal tile, longest S, the VideoGPT step's frozen
    # TiTok-S encode (bs 32 · 16 frames, S 128, 6 heads, no stats on the
    # path), and VideoGPT-B's causal S 512 (16 frames of a 32-code
    # tokenizer, the train_videogpt entry's arm b). With stats the output
    # must be the same bits, m and l fp32-close.
    k1_rows = [k1_row(b, s, h, causal, gen) for b, s, h, causal in [
        (8, 320, 12, False), (TRAIN_BS, 320, 12, False), (3, 77, 12, True),
        (2, 768, 12, False),
        (VIDEO_BS * VIDEOGPT["max_frames"], 128, 6, False),
        (4, 197, 12, False), (4, 257, 16, False), (VIDEO_BS, 512, 12, True)]]
    k1_max = max(row["max_abs"] for row in k1_rows)
    times = {}
    for bs in (8, 64):
        qkv = torch.randn(bs, 320, 3 * 768, device="cuda",
                          generator=gen).bfloat16()
        bias = torch.randn(3 * 768, device="cuda", generator=gen)
        times[bs] = (
            median_ms(lambda: k_attn.attention_packed_fwd(qkv, bias, 12,
                                                          False)),
            median_ms(lambda: k_attn.attention_packed_fwd(
                qkv, bias, 12, False, emit_stats=True)),
            median_ms(lambda: k_attn.attention_packed_fwd_ref(
                qkv, bias, 12, False, emit_stats=True)))
    # The library yardstick: SDPA over the head views of the biased qkv
    # (the bias add and the head split, which K1 does in-kernel, untimed).
    q, k, v = k_attn.split_heads(qkv, 12, bias)
    lib_ms = median_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    k1_bound = attention_bound(64, 12, 320, False, False,
                               extra_bytes=3 * 768 * 4)
    emit("kernel", name="attention_packed_fwd", parity=k1_rows,
         tolerance=dict(max_abs=K1_MAX_ABS, mean_abs=K1_MEAN_ABS,
                        wgmma_fwd_mean_rel=WGMMA_FWD_MEAN_REL,
                        stats_rel=K1_STATS_REL),
         mean_limit_control=normalised_p_control(q, k, v, False),
         ms_bs8=times[8][0], stats_ms_bs8=times[8][1],
         plain_ms_bs8=times[8][2], ms_bs64=times[64][0],
         stats_ms_bs64=times[64][1], plain_ms_bs64=times[64][2],
         sdpa_ms_bs64=lib_ms, sdpa_backend=sdpa_backend(q, k, v, False),
         bound_bs64=k1_bound, shape="(bs, S 320, 3·768) bf16, 12 heads",
         build={n: r for n, r in build.items()
                if n.startswith("attention_fwd") and packed_form(n)
                and head_width(n) == 64})
    summary["attention_packed_fwd"] = dict(
        max_abs_err=k1_max, ms=times[64][1], plain_ms=times[64][2],
        bound_ms=k1_bound["bound_ms"], bound_by=k1_bound["bound_by"],
        library_ms=lib_ms)

    # K2: the flagship step's shape, a ragged causal one, the longest S, S
    # not a multiple of 8, the ViT shapes and VideoGPT-B's causal S 512;
    # (m, l) from K1, the same for kernel and plain.
    k2_rows = [k2_row(b, s, h, causal, gen) for b, s, h, causal in [
        (64, 320, 12, False), (3, 77, 12, True), (2, 768, 12, False),
        (2, 130, 12, True), (4, 197, 12, False), (4, 257, 16, False),
        (VIDEO_BS, 512, 12, True)]]
    k2_max = max(row["dqkv"]["max_abs"] for row in k2_rows)
    b, s = TRAIN_BS, 320
    qkv = torch.randn(b, s, 3 * 768, device="cuda", generator=gen).bfloat16()
    bias = torch.randn(3 * 768, device="cuda", generator=gen)
    dout = torch.randn(b, s, 768, device="cuda", generator=gen).bfloat16()
    _, m, l = k_attn.attention_packed_fwd(qkv, bias, 12, False, emit_stats=True)
    k2_ms = median_ms(lambda: k_attn.attention_packed_bwd(qkv, bias, dout, m,
                                                          l, 12, False))
    k2_plain = median_ms(lambda: k_attn.attention_packed_bwd_ref(
        qkv, bias, dout, m, l, 12, False))
    heads = k_attn.split_heads(qkv, 12, bias)
    dh = dout.reshape(b, s, 12, 64).transpose(1, 2)
    lib = sdpa_backward_ms(*heads, dh, False)
    control = rounded_ph_control(*heads, dh, m, l)
    k2_bound = attention_bound(b, 12, s, False, True,
                               extra_bytes=3 * 768 * (4 + 4))  # fp32 bias in, dbias out
    emit("kernel", name="attention_packed_bwd", parity=k2_rows,
         tolerance=dict(max_rel=BWD_MAX_REL, mean_rel=BWD_MEAN_REL,
                        wgmma_mean_rel=WGMMA_BWD_MEAN_REL),
         mean_limit_control=control,
         ms_bs64=k2_ms, plain_ms_bs64=k2_plain, sdpa_bs64=lib,
         bound_bs64=k2_bound, shape="(64, S 320, 3·768) bf16, 12 heads",
         build={n: r for n, r in build.items()
                if n.startswith("unpacked") and packed_form(n)
                and not fp32_form(n) and head_width(n) == 64})
    summary["attention_packed_bwd"] = dict(
        max_abs_err=k2_max, ms=k2_ms, plain_ms=k2_plain,
        bound_ms=k2_bound["bound_ms"], bound_by=k2_bound["bound_by"],
        library_ms=lib["backward_ms"])
    del qkv, bias, dout, m, l, heads, dh
    torch.cuda.empty_cache()
    return summary


def rounded_ph_control(q, k, v, dout, m, l) -> dict:
    """The control of ``WGMMA_BWD_MEAN_REL``: the plain backward
    (``kernels/attention.py:_attention_bwd_f32``, no mask, no dropout) with
    one early rounding, ph rounded to bf16 before Δ and ds take it, as a
    kernel that kept p in bf16 would. Its dq and dk, held against the plain
    version as the kernels are, must fail the limit."""
    dt = q.dtype
    ph = torch.exp(k_attn._scores(q, k, False) - m[..., None]).to(dt).float()
    linv = 1.0 / l[..., None]
    dp = dout.float() @ v.float().transpose(-1, -2)
    delta = (ph * dp).sum(-1, keepdim=True)
    ds = (ph * ((dp - delta * linv) * (q.shape[-1] ** -0.5 * linv))
          ).to(dt).float()
    got = dict(dq=ds @ k.float(), dk=ds.transpose(-1, -2) @ q.float())
    del ph, dp, ds
    refs = k_attn.attention_bwd_ref(q, k, v, dout, m, l, False)
    row = {name: rel_errors(got[name].to(dt), ref)
           for name, ref in zip(("dq", "dk"), refs)}
    require(all(r["mean_rel"] > WGMMA_BWD_MEAN_REL for r in row.values()),
            f"the rounded-ph control passes the mean limit: {row}")
    return row


def normalised_p_control(q, k, v, causal: bool) -> dict:
    """The control of ``WGMMA_FWD_MEAN_REL``: the plain forward
    (``kernels/attention.py:attention_fwd_ref``) with p normalised before its
    bf16 cast, o = bf16(p/l)·v, as a kernel that normalised inside its loop
    would round. Held against the plain version as the kernels are, it must
    fail the limit."""
    s = k_attn._scores(q, k, causal)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    out = (p.to(v.dtype).float() @ v.float()).to(q.dtype)
    del s, p
    row = rel_errors(out, k_attn.attention_fwd_ref(q, k, v, causal))
    require(row["mean_rel"] > WGMMA_FWD_MEAN_REL,
            f"the normalised-p control passes the mean limit: {row}")
    return row


def two_part_control(q, k, v, dout, m, l, causal: bool) -> dict:
    """The control of ``F32_BWD_MEAN_REL``: the plain backward
    (``kernels/attention.py:attention_bwd_ref``) on fp32 q, k, v and dO
    rounded to two bf16 parts, x0 + x1 (a 16-bit significand), as a split
    that lost its third part would read them. Its dq, dk and dv, held
    against the plain version as the kernel's are, must fail the limit."""
    got = k_attn.attention_bwd_ref(*(two_parts(t) for t in (q, k, v, dout)),
                                   m, l, causal)
    refs = k_attn.attention_bwd_ref(q, k, v, dout, m, l, causal)
    row = {name: rel_errors(a, r)
           for name, a, r in zip(("dq", "dk", "dv"), got, refs)}
    require(all(r["mean_rel"] > F32_BWD_MEAN_REL for r in row.values()),
            f"the two-part control passes the fp32 backward's mean limit: "
            f"{row}")
    return row


def two_part_fwd_control(q, k, v, causal: bool, exact, **drop) -> dict:
    """The control of ``F32_FWD_MEAN_REL``: the plain forward
    (``kernels/attention.py:attention_fwd_ref``) on fp32 q, k and v rounded
    to two bf16 parts, x0 + x1, as a split that lost its third part would
    read them. Its o, m and l, held against the float64 forward ``exact``
    as the kernel's are, must each fail the limit."""
    got = k_attn.attention_fwd_ref(*(two_parts(t) for t in (q, k, v)),
                                   causal, True, **drop)
    row = {name: rel_errors(a, r.float())["mean_rel"]
           for name, a, r in zip(("o", "m", "l"), got, exact)}
    require(all(r > F32_FWD_MEAN_REL for r in row.values()),
            f"the two-part control passes the fp32 forward's mean limit: "
            f"{row}")
    return row


def f32_fwd_check(name: str, got, plain, exact) -> dict:
    """The fp32 forward's (o, m, l) against its plain version within
    FP32_REL (max and mean) and against the float64 forward within
    F32_FWD_MEAN_REL (mean)."""
    row = {}
    for part, out, ref, ex in zip(("out", "m", "l"), got, plain, exact):
        row[part] = fp32_check(f"{name} {part}", out, ref)
        row[part]["mean_rel_exact"] = rel_errors(out, ex.float())["mean_rel"]
        require(row[part]["mean_rel_exact"] <= F32_FWD_MEAN_REL,
                f"the fp32 form of {name} {part} is off the float64 "
                f"forward: {row[part]}")
    return row


def ln_stats_control(x, w, b, g) -> dict:
    """The control of ``LN_MEAN_REL``: the plain versions of K9a (fc1: bias
    and GELU) and K9c (``kernels/ln_matmul.py``) with the LayerNorm
    statistics, the mean and 1/σ, rounded to bf16, as a kernel that kept
    them in bf16 would. Held against the plain versions as the kernels
    are, each must fail the limit."""
    def bf16_stats(x32):
        mu = x32.mean(-1, keepdim=True).bfloat16().float()
        d = x32 - mu
        rstd = torch.rsqrt((d * d).mean(-1, keepdim=True)
                           + k_lnmm.EPS).bfloat16().float()
        return d * rstd, rstd

    refs = (k_lnmm.ln_matmul_fwd_ref(x, w, b, True)[0],
            k_lnmm.ln_bwd_ref(x, g))
    saved, k_lnmm._stats = k_lnmm._stats, bf16_stats
    try:
        got = (k_lnmm.ln_matmul_fwd_ref(x, w, b, True)[0],
               k_lnmm.ln_bwd_ref(x, g))
    finally:
        k_lnmm._stats = saved
    row = {name: rel_errors(a, r) for name, a, r in zip(
        ("ln_matmul_fwd", "ln_bwd"), got, refs)}
    require(all(r["mean_rel"] > LN_MEAN_REL for r in row.values()),
            f"the LN-statistics control passes the mean limit: {row}")
    return row


def per_tensor_scale_control(fwd_args, bwd_args) -> dict:
    """The control of ``Q8_MEAN_REL``: the plain versions of K12a and K12b
    (``kernels/convnext_block.py``) with one scale for each activation
    operand in place of per-row scales (``quant_rows``), as a kernel that
    lost the per-row scales would quantize. Held against the plain versions
    as the kernels are, each must fail the limit."""
    def per_tensor(v32):
        sc = v32.abs().amax().clamp_min(1e-8).reshape(1, 1) * (1.0 / 127.0)
        return torch.round(v32 / sc).clamp(-127, 127).to(torch.int8), sc

    refs = (k_cnx.convnext_tail_fwd_q8_ref(*fwd_args),
            k_cnx.convnext_tail_bwd_q8_ref(*bwd_args))
    saved, k_cnx.quant_rows = k_cnx.quant_rows, per_tensor
    try:
        got = (k_cnx.convnext_tail_fwd_q8_ref(*fwd_args),
               k_cnx.convnext_tail_bwd_q8_ref(*bwd_args))
    finally:
        k_cnx.quant_rows = saved
    row = {name: rel_errors(a, r) for name, a, r in zip(
        ("convnext_tail_fwd_q8", "convnext_tail_bwd_q8"), got, refs)}
    require(all(r["mean_rel"] > Q8_MEAN_REL for r in row.values()),
            f"the per-tensor-scale control passes the mean limit: {row}")
    return row


# The kernels held launch by launch on the paths (held_launches): their
# module and mean limit
HELD = {"ln_matmul_fwd": (k_lnmm, LN_MEAN_REL), "ln_bwd": (k_lnmm, LN_MEAN_REL),
        "convnext_tail_fwd_q8": (k_cnx, Q8_MEAN_REL),
        "convnext_tail_bwd_q8": (k_cnx, Q8_MEAN_REL)}


@contextlib.contextmanager
def held_launches():
    """Inside the block, every call of K9a, K9c, K12a and K12b launches its
    kernel and then runs its plain version on the same inputs (which
    launches nothing); yields {kernel: the largest mean |Δ| / mean |plain|
    over its launches' outputs}. The caller holds each to its limit
    (``HELD``) with :func:`require_held`."""
    worst = {}
    saved = {name: getattr(mod, name) for name, (mod, _) in HELD.items()}

    def held(name):
        kernel, plain = saved[name], getattr(HELD[name][0], name + "_ref")

        def call(*args, **kw):
            out = kernel(*args, **kw)
            ref = plain(*args, **kw)
            pairs = zip(out, ref) if isinstance(out, tuple) else [(out, ref)]
            for o, r in pairs:
                if o is not None:
                    worst[name] = max(worst.get(name, 0.0),
                                      rel_errors(o, r)["mean_rel"])
            return out
        return call

    for name, (mod, _) in HELD.items():
        setattr(mod, name, held(name))
    try:
        yield worst
    finally:
        for name, (mod, _) in HELD.items():
            setattr(mod, name, saved[name])


def require_held(worst: dict, what: str) -> dict:
    """Every kernel in ``worst`` (from :func:`held_launches`) within its
    limit; returns the readings with their limits."""
    require(bool(worst) and all(v <= HELD[k][1] for k, v in worst.items()),
            f"{what}: a launch off its plain version past its mean limit: "
            f"{worst}")
    return {k: dict(mean_rel=v, limit=HELD[k][1]) for k, v in worst.items()}


def rounded_tail_control(fwd_args, bwd_args) -> dict:
    """The control of ``TAIL_MEAN_REL``: the plain versions of K3 and K4
    (``kernels/convnext_block.py``) with one extra rounding each, z rounded
    to bf16 before b1 and GELU take it (K3) and da rounded to bf16 before
    gelu' multiplies it (K4). Held against the plain versions as the
    kernels are, each must fail the limit."""
    h, x, lns, lnb, w1, b1, w2, b2, gamma, eps = fwd_args
    dt = h.dtype
    lns, lnb, w1, b1, w2, b2, gamma = k_cnx._prep(dt, lns, lnb, w1, b1, w2,
                                                  b2, gamma)
    uhat, rstd = k_cnx._normalize(h, eps)
    u = (uhat * lns.float() + lnb.float()).to(dt)
    z = k_cnx._mm(u, w1)
    a = tanh_erf_gelu(z.to(dt).float() + b1.float()).to(dt)
    y = (x.float() + gamma.float() * (k_cnx._mm(a, w2) + b2.float())).to(dt)
    dy = bwd_args[1]
    do = (dy.float() * gamma.float()).to(dt)
    da = (do.float() @ w2.float()).to(dt).float()
    dz = (da * gelu_grad(z + b1.float())).to(dt)
    dhat = (dz.float() @ w1.float()) * lns.float()
    c1 = dhat.mean(-1, keepdim=True)
    c2 = (dhat * uhat).mean(-1, keepdim=True)
    dh = (rstd * (dhat - c1 - uhat * c2)).to(dt)
    row = dict(convnext_tail_fwd=rel_errors(
                   y, k_cnx.convnext_tail_fwd_ref(*fwd_args)),
               convnext_tail_bwd=rel_errors(
                   dh, k_cnx.convnext_tail_bwd_ref(*bwd_args)))
    require(all(r["mean_rel"] > TAIL_MEAN_REL for r in row.values()),
            f"the rounded-tail control passes the mean limit: {row}")
    return row


def tail_build() -> dict:
    """ptxas's report, the dynamic shared memory and the blocks an SM holds
    (228 KB of shared memory an SM, 1 KB of it reserved a block) of K3's
    and K4's kernels at each width: ``convnext_tail_fwd_kernel<C, kParts>``
    and ``convnext_tail_bwd_kernel<C, kParts>`` (kParts 3: the fp32
    forms), and ``convnext_tail_gz_kernel<C>`` (K4 fp32's z pre-pass)."""
    lib = _build.load()
    kinds = {"convnext_tail_fwd_kernel": 0, "convnext_tail_bwd_kernel": 1,
             "convnext_tail_gz_kernel": 2}
    out = {}
    for name, report in measured.get("ptxas", {}).items():
        base = name.partition("<")[0]
        if base not in kinds:
            continue
        args = template_args(name)
        smem = lib.convnext_tail_smem(int(args[0]), kinds[base],
                                      int(args[1]) if len(args) > 1 else 3)
        out[name] = dict(ptxas=report, dynamic_smem_bytes=smem,
                         blocks_per_sm_by_smem=233472 // (smem + 1024))
    return out


def template_args(kernel: str) -> "list[str]":
    """The template arguments of a kernel's name as ``kernel_name`` gives
    it, e.g. ``unpacked_bwd_dq_kernel<false, true, 3, 64>``."""
    return kernel.partition("<")[2].rstrip(">").split(", ")


def packed_form(kernel: str) -> bool:
    """Whether a Hopper attention kernel's name is its kBias instantiation
    (K1, K2): ``attention_fwd_kernel<kDropout, kBias, kParts, kD>``,
    ``unpacked_bwd_dq_kernel<kDropout, kBias, kParts, kD>`` and the like."""
    return template_args(kernel)[1:2] == ["true"]


def fp32_form(kernel: str) -> bool:
    """Whether a Hopper attention kernel's name is its fp32 form (kParts =
    3)."""
    return template_args(kernel)[2:3] == ["3"]


def head_width(kernel: str) -> int:
    """The head width (kD, 32 or 64) of a Hopper attention kernel's name,
    ``attention_fwd_kernel<kDropout, kBias, kParts, kD>`` and the like."""
    return int(template_args(kernel)[3])


def phase_kernels() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    summary = packed_kernels(gen)

    # K3 / K4: the three fused stages of ConvNeXt-S at bs 64, and ragged N.
    # γ of order 1 (not the init's 1e-6) so the tail shows in y.
    tails = {"convnext_tail_fwd": dict(rows=[], max=0.0, ms={}, plain_ms={}),
             "convnext_tail_bwd": dict(rows=[], max=0.0, ms={}, plain_ms={})}
    shapes = [(n, c) for _, _, n, c in CNX_STAGES] + [(1000, 96), (777, 384)]
    for n, c in shapes:
        (h, x, dy), (lns, lnb, w1, b1, w2, b2, gamma) = random_tail(
            n, c, gen, gamma_scale=1.0)
        fwd_args = (h, x, lns, lnb, w1, b1, w2, b2, gamma, 1e-6)
        bwd_args = (h, dy, lns, lnb, w1, b1, w2, gamma, 1e-6)
        runs = {"convnext_tail_fwd": (k_cnx.convnext_tail_fwd,
                                      k_cnx.convnext_tail_fwd_ref, fwd_args),
                "convnext_tail_bwd": (k_cnx.convnext_tail_bwd,
                                      k_cnx.convnext_tail_bwd_ref, bwd_args)}
        for name, (kernel, plain, args) in runs.items():
            out = kernel(*args)
            torch.cuda.synchronize()
            row = dict(N=n, C=c, **rel_errors(out, plain(*args)))
            tails[name]["rows"].append(row)
            require(bool(torch.isfinite(out).all()),
                    f"{name} non-finite at {row}")
            require(row["max_rel"] <= BWD_MAX_REL
                    and row["mean_rel"] <= BWD_MEAN_REL
                    and row["mean_rel"] <= TAIL_MEAN_REL,
                    f"{name} disagrees with its plain version: {row}")
            tails[name]["max"] = max(tails[name]["max"], row["max_abs"])
            if (n, c) in [(n_, c_) for _, _, n_, c_ in CNX_STAGES]:
                tails[name]["ms"][c] = median_ms(lambda: kernel(*args), 10)
                tails[name]["plain_ms"][c] = median_ms(lambda: plain(*args), 10)
        if (n, c) == (CNX_STAGES[2][2], 384):
            control = rounded_tail_control(fwd_args, bwd_args)
        del h, x, dy, fwd_args, bwd_args
        torch.cuda.empty_cache()
    # At C 384, N 12544: K3 does two products of N·C·4C MACs, K4 three (it
    # recomputes the first); each reads its (N, C) bf16 rows (two for K3:
    # h and x; K4: h and dy), writes one, and reads the fp32 parameters.
    n, c = CNX_STAGES[2][2], 384
    rows, weights = n * c * 2, (8 * c * c + 8 * c) * 4
    tail_bounds = {"convnext_tail_fwd": bound(16 * n * c * c,
                                              3 * rows + weights),
                   "convnext_tail_bwd": bound(24 * n * c * c,
                                              3 * rows + weights)}
    build = {k: v for k, v in tail_build().items()
             if template_args(k)[1:2] != ["3"]}
    for name, t in tails.items():
        emit("kernel", name=name, parity=t["rows"],
             tolerance=dict(max_rel=BWD_MAX_REL, mean_rel=BWD_MEAN_REL,
                            tail_mean_rel=TAIL_MEAN_REL),
             mean_limit_control=control[name],
             ms_by_C=t["ms"], plain_ms_by_C=t["plain_ms"],
             bound_C384=tail_bounds[name],
             shape="(bs 64 · H · W, C) bf16 rows of ConvNeXt-S stages 0-2",
             summary_shape="C 384, N 12544 (27 of the 33 fused blocks)",
             build={k: v for k, v in build.items()
                    if k.startswith(name + "_kernel")})
        summary[name] = dict(max_abs_err=t["max"], ms=t["ms"][384],
                             plain_ms=t["plain_ms"][384],
                             bound_ms=tail_bounds[name]["bound_ms"],
                             bound_by=tail_bounds[name]["bound_by"],
                             library_ms=None)

    # K5: fp32, D 12; C 2048 at the encode's and the train step's N and a
    # ragged N, C 1024 at the VideoGPT step's N (32 · 16 frames · 64). Scores z·e (− ‖e‖²/2 without normalisation) in fp64 judge
    # both: the kernel's code must be the fp64 best within K5_TIE_GAP on
    # every row, and where the plain version picks another code, that code
    # must be within the plain version's own rounding of the best.
    k5_gap, k5_rows = 0.0, []
    video_codes = VIDEO_BS * VIDEOGPT["max_frames"] * VIDEOGPT["frame_size"]
    for n, c in ((2048, 2048), (TRAIN_BS * 256, 2048), (2053, 2048),
                 (video_codes, 1024)):
        for l2 in (True, False):
            row = k5_hold(n, c, 12, l2, gen)
            k5_rows.append(row)
            k5_gap = max(k5_gap, row["max_tie_gap"])
    for d in k_vq.TUNED_DIMS:  # every tuned instantiation the library ships
        z = torch.randn(333, d, device="cuda", generator=gen)
        cb = torch.randn(500, d, device="cuda", generator=gen)
        same = (k_vq.nearest_code(z, cb) == k_vq.nearest_code_ref(z, cb))
        require(bool(same.all()), f"K5 disagrees at D {d}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cross_slice_tie = k5_ties(gen, sms)
    lib = _build.load()
    require(all(lib.vq_nearest_block_rows(d) == 32 * k_vq.rows_per_lane(d)
                for d in k_vq.TUNED_DIMS),
            "K5's rows a block differ between the source and kernels/vq.py")
    # Each path's shape: serving bs 8 and 64 (the train step's N too)
    # against 2048 codes, the VideoGPT step's against 1024. N·C·D fp32
    # multiply-adds off the tensor cores; z and the codebook read, the
    # indices written.
    k5_shapes = {"bs8": (8 * 256, 2048), "bs64": (64 * 256, 2048),
                 "videogpt": (video_codes, 1024)}
    times, k5_plans, k5_bounds = {}, {}, {}
    for key, (n, c) in k5_shapes.items():
        z = torch.randn(n, 12, device="cuda", generator=gen)
        cb = (torch.rand(c, 12, device="cuda", generator=gen) * 2 - 1) / c
        times[key] = dict(ms=median_ms(lambda: k_vq.nearest_code(z, cb)),
                          dev_ms=device_ms(lambda: k_vq.nearest_code(z, cb)),
                          plain_ms=median_ms(
                              lambda: k_vq.nearest_code_ref(z, cb)))
        k5_plans[key] = k_vq.plan(n, c, 12, sms)
        k5_bounds[key] = bound(2 * n * c * 12, (n + c) * 12 * 4 + n * 4,
                               peak=PEAK_FP32_FLOPS)
    k5_bound = k5_bounds["bs8"]
    any_dim = k5_any_dims(gen, sms)
    emit("kernel", name="vq_nearest", parity=k5_rows,
         tolerance=dict(tie_gap=K5_TIE_GAP), lowest_index_ties=True,
         cross_slice_tie=cross_slice_tie,
         dims_checked=list(k_vq.TUNED_DIMS), times=times,
         any_dim=any_dim,
         plans=k5_plans, bounds=k5_bounds,
         ms_bs8=times["bs8"]["ms"], plain_ms_bs8=times["bs8"]["plain_ms"],
         ms_bs64=times["bs64"]["ms"], plain_ms_bs64=times["bs64"]["plain_ms"],
         bound_bs8=k5_bound,
         build={k: v for k, v in measured.get("ptxas", {}).items()
                if k.startswith("vq_nearest_kernel")},
         shape="(N, 12) fp32 against (C, 12): bs 8 and 64 at C 2048, "
               "VideoGPT's N 32768 at C 1024")
    summary["vq_nearest"] = dict(max_abs_err=k5_gap, ms=times["bs8"]["ms"],
                                 plain_ms=times["bs8"]["plain_ms"],
                                 bound_ms=k5_bound["bound_ms"],
                                 bound_by=k5_bound["bound_by"],
                                 library_ms=None,
                                 dev_ms=times["bs8"]["dev_ms"],
                                 blocks=k5_plans["bs8"]["blocks"],
                                 any_dim={d: {k: t[k] for k in (
                                     "ms", "dev_ms", "plain_ms", "bound_ms")}
                                     for d, t in any_dim["times"].items()},
                                 any_dim_max_regret=any_dim[
                                     "kernel_max_regret"])
    summary.update(unpacked_kernels(gen))
    for name, arm in dropout_kernels(gen).items():
        summary[name]["dropout"] = arm
    summary.update(fused_kernels(gen))
    summary.update(int8_tail_kernels(gen))
    summary.update(depthwise_kernels(gen))
    return summary

def k5_hold(n: int, c: int, d: int, l2: bool, gen) -> dict:
    """K5 at (N, C, D) on random fp32 z and codes (scaled by 1/C, as the
    train step's codebook), judged by ``k5_judge``."""
    z = torch.randn(n, d, device="cuda", generator=gen)
    cb = (torch.rand(c, d, device="cuda", generator=gen) * 2 - 1) / c
    return k5_judge(z, cb, l2)


def k5_judge(z: torch.Tensor, cb: torch.Tensor, l2: bool) -> dict:
    """K5 on fp32 z (N, D) and codes (C, D), judged by fp64 scores z·e
    (− ‖e‖²/2 without normalisation): the kernel's code must be the fp64
    best within K5_TIE_GAP on every row, and where the plain version picks
    another code, that code must be within the plain version's own rounding
    of the best."""
    (n, d), c = z.shape, cb.shape[0]
    idx = k_vq.nearest_code(z, cb, l2_normalize=l2).long()
    ref = k_vq.nearest_code_ref(z, cb, l2_normalize=l2).long()
    bad = (idx != ref).nonzero().flatten()
    z64, e64 = z.double(), cb.double()
    if l2:
        z64 = z64 * torch.rsqrt((z64 * z64).sum(-1, keepdim=True) + 1e-24)
        e64 = e64 * torch.rsqrt((e64 * e64).sum(-1, keepdim=True) + 1e-24)
    s64 = z64 @ e64.T
    if not l2:
        s64 -= 0.5 * (e64 * e64).sum(-1)
    best = s64.max(-1).values
    rows = torch.arange(n, device="cuda")
    regret = best - s64[rows, idx]
    plain_regret = (best - s64[rows, ref])[bad]
    # The plain version's fp32 distance ‖z‖² + ‖e‖² − 2z·e rounds at the
    # ulp of its largest term, (‖z‖ + ‖e‖)² at most.
    plain_bound = (K5_PLAIN_ULPS * 2.0 ** -24 * (
        z64.norm(dim=-1) + e64.norm(dim=-1).max()) ** 2)[bad]
    worst = (s64[bad, idx[bad]] - s64[bad, ref[bad]]).abs().max().item() \
        if len(bad) else 0.0
    row = dict(N=n, C=c, D=d, l2_normalize=l2, near_ties=len(bad),
               max_tie_gap=worst, kernel_max_regret=regret.max().item(),
               plain_max_regret_over_bound=(
                   (plain_regret / plain_bound).max().item() if len(bad)
                   else 0.0))
    del s64
    require(regret.max().item() <= K5_TIE_GAP,
            f"K5 misses the fp64 nearest code: {row}")
    require(bool((plain_regret <= plain_bound).all()),
            f"K5 disagrees beyond a near-tie: {row}")
    return row


def k5_ties(gen, sms: int) -> dict:
    """K5's tie rule at D 12 (the tuned form) and 6 (the runtime-D form):
    equal codes at 7, 40 and 63 in one slice give 7; and a tie across
    slices: at N 2048 the plan cuts the 2048 codes into slices, so the
    code that ends slice 0 has equal codes that start slice 1 and in two
    later slices, and every row equal to it must take it from the merged
    keys. Returns the codes tied across slices a D."""
    for d in (12, 6):
        cb = torch.randn(64, d, device="cuda", generator=gen)
        cb[40] = cb[7]
        cb[63] = cb[7]
        z = cb[7:8].repeat(33, 1).contiguous()
        for l2 in (True, False):
            require(k_vq.nearest_code(z, cb, l2_normalize=l2).unique()
                    .tolist() == [7],
                    f"K5 does not break ties toward the lowest index at D {d}")
    tied = {}
    for d in (12, 6):
        tie_plan = k_vq.plan(2048, 2048, d, sms)
        end = tie_plan["slice"] - 1
        require(tie_plan["splits"] > 2 and end + 1 < 1000,
                f"K5's plan at N 2048 has too few slices: {tie_plan}")
        cb = torch.randn(2048, d, device="cuda", generator=gen)
        tied[d] = [end, end + 1, 1000, 2047]
        for j in tied[d][1:]:
            cb[j] = cb[end]
        z = cb[end:end + 1].repeat(2048, 1).contiguous()
        for l2 in (True, False):
            require(k_vq.nearest_code(z, cb, l2_normalize=l2).unique()
                    .tolist() == [end], f"K5 does not break a tie across "
                    f"slices toward the lowest index at D {d}")
    return dict(N=2048, C=2048, codes=tied, picked="the first of each")


def k5_any_dims(gen, sms: int) -> dict:
    """K5's runtime-D form (every D but the tuned 8, 12, 16 and 32) at
    ``K5_ANY_DIMS`` against the train step's N and C 2048 and 16384, and at
    ``K5_WIDE_DIMS`` against C 2048, held by ``k5_hold``; the rows a block
    held against ``rows_per_block``; each D timed at (N, 2048) with its
    bound (N·C·D fp32 multiply-adds; z and the codes read, the indices
    written)."""
    n = TRAIN_BS * 256
    rows, times = [], {}
    lib = _build.load()
    for d in K5_ANY_DIMS + K5_WIDE_DIMS:
        require(lib.vq_nearest_block_rows(d) == k_vq.rows_per_block(d),
                f"K5's rows a block at D {d} differ from kernels/vq.py")
        for c in (2048, 16384) if d in K5_ANY_DIMS else (2048,):
            for l2 in (True, False):
                rows.append(k5_hold(n, c, d, l2, gen))
        z = torch.randn(n, d, device="cuda", generator=gen)
        cb = (torch.rand(2048, d, device="cuda", generator=gen) * 2 - 1) / 2048
        times[d] = dict(
            ms=median_ms(lambda: k_vq.nearest_code(z, cb)),
            dev_ms=device_ms(lambda: k_vq.nearest_code(z, cb)),
            plain_ms=median_ms(lambda: k_vq.nearest_code_ref(z, cb)),
            plan=k_vq.plan(n, 2048, d, sms),
            **bound(2 * n * 2048 * d, (n + 2048) * d * 4 + n * 4,
                    peak=PEAK_FP32_FLOPS))
    torch.cuda.empty_cache()
    return dict(parity=rows, times=times,
                kernel_max_regret=max(r["kernel_max_regret"] for r in rows),
                build={k: v for k, v in measured.get("ptxas", {}).items()
                       if k.startswith("vq_nearest_any_kernel")})


def head_views(b: int, h: int, s: int, gen, packed: bool = True,
               d: int = 64, dtype=torch.bfloat16):
    """q, k, v (b, h, s, d): the strided head views of one packed
    (b, s, 3·h·d) projection, as the model hands them over, or three
    contiguous tensors."""
    if packed:
        qkv = torch.randn(b, s, 3, h, d, device="cuda",
                          generator=gen).to(dtype)
        return tuple(qkv.permute(2, 0, 3, 1, 4))
    return tuple(torch.randn(b, h, s, d, device="cuda",
                             generator=gen).to(dtype) for _ in range(3))


def sdpa_backward_ms(q, k, v, dout, causal: bool,
                     dropout_p: float = 0.0) -> dict:
    """``F.scaled_dot_product_attention``'s backward alone (autograd.grad
    on a kept graph) and its forward + backward, on leaf copies of q, k, v."""
    q, k, v = (t.detach().clone().requires_grad_() for t in (q, k, v))

    def fwd():
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                              dropout_p=dropout_p)

    out = fwd()
    return dict(
        backward_ms=median_ms(lambda: torch.autograd.grad(
            out, (q, k, v), dout, retain_graph=True)),
        forward_backward_ms=median_ms(lambda: torch.autograd.grad(
            fwd(), (q, k, v), dout)),
        backend=sdpa_backend(q, k, v, causal))


def unpacked_kernels(gen) -> dict:
    """K6 and K7/K8 against their plain versions at the VideoGPT paths'
    shapes (the train step's (32, 12, 1024) causal on the packed
    projection's strided views, the prefill's 513 at bs 1 and 8) and ragged
    edges, then their times at the train step's shape."""
    summary = {}
    k6_rows, k6_max = [], 0.0
    for b, s, causal, packed in [(VIDEO_BS, 1024, True, True),
                                 (1, 513, True, True), (8, 513, True, True),
                                 (2, 777, True, False),
                                 (2, 777, False, False)]:
        q, k, v = head_views(b, 12, s, gen, packed)
        out = k_attn.flash_attention(q, k, v, causal=causal)
        out_s, m, l = k_attn.attention_fwd(q, k, v, causal, emit_stats=True)
        torch.cuda.synchronize()
        ref, m_ref, l_ref = k_attn.attention_fwd_ref(q, k, v, causal,
                                                     emit_stats=True)
        row = dict(B=b, S=s, H=12, causal=causal, strided=packed,
                   **rel_errors(out, ref),
                   stats_out_identical=bool(torch.equal(out, out_s)),
                   m_rel=((m - m_ref).abs().max() / m_ref.abs().max()).item(),
                   l_rel=((l - l_ref).abs() / l_ref).max().item())
        k6_rows.append(row)
        require(bool(torch.isfinite(out).all()), f"K6 non-finite at {row}")
        require(row["max_rel"] <= BWD_MAX_REL
                and row["mean_rel"] <= BWD_MEAN_REL
                and row["mean_rel"] <= WGMMA_FWD_MEAN_REL,
                f"K6 disagrees with its plain version: {row}")
        require(row["stats_out_identical"] and row["m_rel"] <= K1_STATS_REL
                and row["l_rel"] <= K1_STATS_REL,
                f"K6's statistics disagree with the plain version: {row}")
        k6_max = max(k6_max, row["max_abs"])
        del q, k, v, out, out_s, ref
    torch.cuda.empty_cache()

    k8_rows, k8_max = [], 0.0
    for b, s, causal in [(VIDEO_BS, 1024, True), (2, 777, False),
                         (2, 513, True)]:   # the last at S ≤ 768: K7's range
        q, k, v = head_views(b, 12, s, gen, packed=b == VIDEO_BS)
        dout = torch.randn(b, s, 12, 64, device="cuda",
                           generator=gen).bfloat16().transpose(1, 2)
        _, m, l = k_attn.attention_fwd(q, k, v, causal, emit_stats=True)
        grads = k_attn.attention_bwd(q, k, v, dout, m, l, causal)
        torch.cuda.synchronize()
        refs = k_attn.attention_bwd_ref(q, k, v, dout, m, l, causal)
        row = dict(B=b, S=s, H=12, causal=causal,
                   **{name: rel_errors(g, r)
                      for name, g, r in zip(("dq", "dk", "dv"), grads, refs)})
        k8_rows.append(row)
        for name, g in zip(("dq", "dk", "dv"), grads):
            require(bool(torch.isfinite(g).all()),
                    f"K7/K8 {name} non-finite at {row}")
            require(row[name]["max_rel"] <= BWD_MAX_REL
                    and row[name]["mean_rel"] <= BWD_MEAN_REL
                    and row[name]["mean_rel"] <= WGMMA_BWD_MEAN_REL,
                    f"K7/K8 disagrees with its plain version: {row}")
            k8_max = max(k8_max, row[name]["max_abs"])
        del q, k, v, dout, grads, refs
    torch.cuda.empty_cache()

    # Times at the train step's shape, on the strided views it passes.
    b, s = VIDEO_BS, 1024
    q, k, v = head_views(b, 12, s, gen)
    dout = torch.randn(b, s, 12, 64, device="cuda",
                       generator=gen).bfloat16().transpose(1, 2)
    k6 = dict(
        stats_ms=median_ms(lambda: k_attn.attention_fwd(q, k, v, True,
                                                        emit_stats=True)),
        ms=median_ms(lambda: k_attn.attention_fwd(q, k, v, True)),
        plain_ms=median_ms(lambda: k_attn.attention_fwd_ref(
            q, k, v, True, emit_stats=True), 5),
        sdpa_ms=median_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True)),
        sdpa_backend=sdpa_backend(q, k, v, True))
    pq, pk, pv = head_views(8, 12, 513, gen)
    k6["prefill_bs8_ms"] = median_ms(
        lambda: k_attn.attention_fwd(pq, pk, pv, True))
    k6["prefill_bs1_ms"] = median_ms(
        lambda: k_attn.attention_fwd(pq[:1], pk[:1], pv[:1], True))
    _, m, l = k_attn.attention_fwd(q, k, v, True, emit_stats=True)
    k8 = dict(ms=median_ms(lambda: k_attn.attention_bwd(q, k, v, dout, m, l,
                                                        True)),
              plain_ms=median_ms(lambda: k_attn.attention_bwd_ref(
                  q, k, v, dout, m, l, True), 5),
              sdpa=sdpa_backward_ms(q, k, v, dout, True))
    # K7's own shape (S ≤ 768: the TPU's untiled backward), held above
    k7_q, k7_k, k7_v = head_views(2, 12, 513, gen, packed=False)
    k7_dout = torch.randn(2, 513, 12, 64, device="cuda",
                          generator=gen).bfloat16().transpose(1, 2)
    _, k7_m, k7_l = k_attn.attention_fwd(k7_q, k7_k, k7_v, True,
                                         emit_stats=True)
    k7 = dict(ms=median_ms(lambda: k_attn.attention_bwd(
                  k7_q, k7_k, k7_v, k7_dout, k7_m, k7_l, True)),
              plain_ms=median_ms(lambda: k_attn.attention_bwd_ref(
                  k7_q, k7_k, k7_v, k7_dout, k7_m, k7_l, True), 5),
              sdpa=sdpa_backward_ms(k7_q, k7_k, k7_v, k7_dout, True),
              bound=attention_bound(2, 12, 513, True, True))
    emit("kernel", name="attention_bwd", what="K7's shape",
         shape="(2, 12, S 513, 64) bf16 causal", **k7)
    k6_bound = attention_bound(b, 12, s, True, False)
    k8_bound = attention_bound(b, 12, s, True, True)
    build = hopper_attention_ptxas()
    emit("kernel", name="attention_fwd", parity=k6_rows,
         tolerance=dict(max_rel=BWD_MAX_REL, mean_rel=BWD_MEAN_REL,
                        wgmma_fwd_mean_rel=WGMMA_FWD_MEAN_REL,
                        stats_rel=K1_STATS_REL),
         mean_limit_control=normalised_p_control(q, k, v, True),
         bound=k6_bound, shape="(32, 12, S 1024, 64) bf16 causal, strided",
         build={n: r for n, r in build.items()
                if n.startswith("attention") and not packed_form(n)
                and not fp32_form(n) and head_width(n) == 64},
         **k6)
    emit("kernel", name="attention_bwd", parity=k8_rows,
         tolerance=dict(max_rel=BWD_MAX_REL, mean_rel=BWD_MEAN_REL,
                        wgmma_mean_rel=WGMMA_BWD_MEAN_REL),
         bound=k8_bound, shape="(32, 12, S 1024, 64) bf16 causal, strided",
         build={n: r for n, r in build.items()
                if n.startswith("unpacked") and not packed_form(n)
                and not fp32_form(n) and head_width(n) == 64},
         **k8)
    summary["attention_fwd"] = dict(
        max_abs_err=k6_max, ms=k6["stats_ms"], plain_ms=k6["plain_ms"],
        bound_ms=k6_bound["bound_ms"], bound_by=k6_bound["bound_by"],
        library_ms=k6["sdpa_ms"])
    summary["attention_bwd"] = dict(
        max_abs_err=k8_max, ms=k8["ms"], plain_ms=k8["plain_ms"],
        bound_ms=k8_bound["bound_ms"], bound_by=k8_bound["bound_by"],
        library_ms=k8["sdpa"]["backward_ms"])
    del q, k, v, dout, pq, pk, pv, m, l
    torch.cuda.empty_cache()
    return summary


def random_seed(gen) -> torch.Tensor:
    """A (2,) [seed, 0] vector with the seed drawn on the card, as the
    model's attention draws it."""
    return k_attn.seed_vec(torch.randint(0, 2 ** 31 - 1, (1,), device="cuda",
                                         generator=gen, dtype=torch.int32))


def dropped_fraction(seed, b: int, h: int, s: int, causal: bool,
                     rate: float) -> dict:
    """The mask's dropped share over the unmasked (query, key) pairs, and
    its distance from ``rate`` in standard deviations of a binomial."""
    mask = k_attn._head_mask(seed, b, h, s, rate)
    if causal:
        mask = mask.masked_fill(
            ~torch.ones(s, s, dtype=torch.bool, device="cuda").tril(), -1.0)
    n = int((mask >= 0).sum())
    frac = (mask == 0).sum().item() / n
    sigma = (rate * (1 - rate) / n) ** 0.5
    return dict(dropped_fraction=frac, pairs=n,
                sigmas_from_rate=abs(frac - rate) / sigma)


def onehot_rows(s: int, d: int = 64) -> torch.Tensor:
    """(s, d) bf16 with row c the unit vector of c mod d: as v, each
    output column counts the kept keys of one residue class; as dO, each dv
    column counts the kept queries."""
    r = torch.arange(s, device="cuda")
    return (r[:, None] % d == torch.arange(d, device="cuda")).bfloat16()


def mask_probe(b: int, h: int, s: int, causal: bool, rate: float, gen,
               packed: bool, d: int = 64) -> dict:
    """The kernels' mask against the plain version's, bit for bit. Forward:
    q = k = 0, so p ≡ 1 and l counts the unmasked keys, and v one-hot by key
    residue: each output is (kept keys of a class) · bf16(scale) / l, exact
    in fp32 on both sides. Backward with m = 0, l = 1 given and dO one-hot
    by query residue: dv counts kept queries the same way, through the
    dk/dv kernel's transposed walk. S not a multiple of 64 covers the
    padding, causal the masked tiles; ``d`` is the head width."""
    seed = random_seed(gen)
    onehot = onehot_rows(s, d)
    stats = (torch.zeros(b, h, s, device="cuda"),
             torch.ones(b, h, s, device="cuda"))
    drop = dict(dropout_rate=rate, seed=seed)
    if packed:
        width = h * d
        qkv = torch.zeros(b, s, 3 * width, dtype=torch.bfloat16, device="cuda")
        qkv[:, :, 2 * width:] = onehot.repeat(1, h)
        bias = torch.zeros(3 * width, device="cuda")
        dout = onehot.repeat(1, h)[None].expand(b, s, width).contiguous()
        fwd = [f(qkv, bias, h, causal, **drop)
               for f in (k_attn.attention_packed_fwd,
                         k_attn.attention_packed_fwd_ref)]
        bwd = [f(qkv, bias, dout, *stats, h, causal, **drop)[0][..., 2 * width:]
               for f in (k_attn.attention_packed_bwd,
                         k_attn.attention_packed_bwd_ref)]
    else:
        q = torch.zeros(b, h, s, d, dtype=torch.bfloat16, device="cuda")
        v = onehot[None, None].expand(b, h, s, d).contiguous()
        fwd = [f(q, q, v, causal, **drop)
               for f in (k_attn.attention_fwd, k_attn.attention_fwd_ref)]
        bwd = [f(q, q, v, v, *stats, causal, **drop)[2]
               for f in (k_attn.attention_bwd, k_attn.attention_bwd_ref)]
    torch.cuda.synchronize()
    row = dict(B=b, H=h, S=s, d=d, causal=causal, rate=rate,
               out_equal=bool(torch.equal(*fwd)),
               dv_equal=bool(torch.equal(*bwd)),
               out_max_abs=(fwd[0].float() - fwd[1].float()).abs().max().item(),
               dv_max_abs=(bwd[0].float() - bwd[1].float()).abs().max().item(),
               **dropped_fraction(seed, b, h, s, causal, rate))
    require(row["out_equal"] and row["dv_equal"],
            f"the kernels' dropout mask differs from the plain version's: "
            f"{row}")
    require(row["sigmas_from_rate"] <= DROP_SIGMAS,
            f"dropped fraction off the rate: {row}")
    return row


def dropout_kernels(gen) -> dict:
    """The dropout arms of K1/K2 at ViT-L/16 @256's shape (64, 257, 16
    heads, rate 0.15), K6/K8 at VideoGPT-B's (32, 12, 1024) causal and K7's
    (2, 12, 513) causal (rate 0.1): each against its plain version with the
    same seed vector, the mask's dropped fraction, the mask probes, and the
    times with and without dropout beside SDPA's with ``dropout_p`` (which
    draws its own Philox mask, so only its time compares). Returns each
    attention entry's ``dropout`` summary."""
    summary, probes = {}, []
    for b, h, s, causal, packed in [(4, 16, 257, False, True),
                                    (4, 16, 257, True, True),
                                    (2, 12, 1024, True, False),
                                    (2, 12, 513, True, False),
                                    (2, 12, 257, False, False)]:
        probes.append(dict(kernels="K1/K2" if packed else "K6, K7/K8",
                           **mask_probe(b, h, s, causal, VIT_DROPOUT if packed
                                        else GPT_DROPOUT, gen, packed)))
    emit("kernel", name="dropout_mask_probe", rows=probes)

    # K1 / K2 at ViT-L's shape
    b, s, h, rate = VIT_BS, 257, 16, VIT_DROPOUT
    width = h * 64
    qkv = torch.randn(b, s, 3 * width, device="cuda", generator=gen).bfloat16()
    bias = 0.3 * torch.randn(3 * width, device="cuda", generator=gen)
    dout = torch.randn(b, s, width, device="cuda", generator=gen).bfloat16()
    seed = random_seed(gen)
    drop = dict(dropout_rate=rate, seed=seed)
    out, m, l = k_attn.attention_packed_fwd(qkv, bias, h, False, True, **drop)
    torch.cuda.synchronize()
    ref, m_ref, l_ref = k_attn.attention_packed_fwd_ref(qkv, bias, h, False,
                                                        True, **drop)
    diff = (out.float() - ref.float()).abs()
    k1 = dict(B=b, S=s, H=h, rate=rate, max_abs=diff.max().item(),
              mean_abs=diff.mean().item(),
              mean_rel=rel_errors(out, ref)["mean_rel"],
              m_rel=((m - m_ref).abs().max() / m_ref.abs().max()).item(),
              l_rel=((l - l_ref).abs() / l_ref).max().item(),
              **dropped_fraction(seed, b, h, s, False, rate))
    require(bool(torch.isfinite(out).all())
            and k1["max_abs"] <= K1_MAX_ABS and k1["mean_abs"] <= K1_MEAN_ABS
            and k1["mean_rel"] <= WGMMA_FWD_MEAN_REL
            and k1["m_rel"] <= K1_STATS_REL and k1["l_rel"] <= K1_STATS_REL
            and k1["sigmas_from_rate"] <= DROP_SIGMAS,
            f"K1 with dropout disagrees with its plain version: {k1}")
    del ref, m_ref, l_ref
    dqkv, dbias = k_attn.attention_packed_bwd(qkv, bias, dout, m, l, h, False,
                                              **drop)
    torch.cuda.synchronize()
    dqkv_ref, dbias_ref = k_attn.attention_packed_bwd_ref(
        qkv, bias, dout, m, l, h, False, **drop)
    k2 = dict(B=b, S=s, H=h, rate=rate, dqkv=rel_errors(dqkv, dqkv_ref),
              dbias=rel_errors(dbias, dbias_ref))
    for key in ("dqkv", "dbias"):
        require(bool(torch.isfinite(dqkv).all())
                and k2[key]["max_rel"] <= BWD_MAX_REL
                and k2[key]["mean_rel"] <= BWD_MEAN_REL
                and k2[key]["mean_rel"] <= WGMMA_BWD_MEAN_REL,
                f"K2 with dropout disagrees with its plain version: {k2}")
    del dqkv_ref, dbias_ref
    torch.cuda.empty_cache()
    qh, kh, vh = k_attn.split_heads(qkv, h, bias)
    dh = dout.reshape(b, s, h, 64).transpose(1, 2)
    k1.update(
        ms=median_ms(lambda: k_attn.attention_packed_fwd(qkv, bias, h, False,
                                                         True, **drop)),
        no_dropout_ms=median_ms(lambda: k_attn.attention_packed_fwd(
            qkv, bias, h, False, True)),
        plain_ms=median_ms(lambda: k_attn.attention_packed_fwd_ref(
            qkv, bias, h, False, True, **drop), 5),
        sdpa_ms=median_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, dropout_p=rate)),
        sdpa_backend=sdpa_backend(qh, kh, vh, False),
        bound=attention_bound(b, h, s, False, False,
                              extra_bytes=3 * width * 4, dropout=True))
    k2.update(
        ms=median_ms(lambda: k_attn.attention_packed_bwd(
            qkv, bias, dout, m, l, h, False, **drop)),
        no_dropout_ms=median_ms(lambda: k_attn.attention_packed_bwd(
            qkv, bias, dout, m, l, h, False)),
        plain_ms=median_ms(lambda: k_attn.attention_packed_bwd_ref(
            qkv, bias, dout, m, l, h, False, **drop), 5),
        sdpa=sdpa_backward_ms(qh, kh, vh, dh, False, dropout_p=rate),
        bound=attention_bound(b, h, s, False, True,
                              extra_bytes=3 * width * 8, dropout=True))
    emit("kernel", name="attention_packed_fwd", what="dropout arm",
         parity=k1, tolerance=dict(max_abs=K1_MAX_ABS, mean_abs=K1_MEAN_ABS,
                                   wgmma_fwd_mean_rel=WGMMA_FWD_MEAN_REL,
                                   stats_rel=K1_STATS_REL,
                                   dropped_sigmas=DROP_SIGMAS),
         sdpa_note="SDPA draws its own Philox mask: its time only",
         shape="(64, S 257, 3·1024) bf16, 16 heads, rate 0.15")
    emit("kernel", name="attention_packed_bwd", what="dropout arm",
         parity=k2, tolerance=dict(max_rel=BWD_MAX_REL, mean_rel=BWD_MEAN_REL,
                                   wgmma_mean_rel=WGMMA_BWD_MEAN_REL),
         sdpa_note="SDPA draws its own Philox mask: its time only",
         shape="(64, S 257, 3·1024) bf16, 16 heads, rate 0.15")
    summary["attention_packed_fwd"] = dict(
        max_abs_err=k1["max_abs"], ms=k1["ms"], no_dropout_ms=k1["no_dropout_ms"],
        plain_ms=k1["plain_ms"], bound_ms=k1["bound"]["bound_ms"],
        bound_by=k1["bound"]["bound_by"], library_ms=k1["sdpa_ms"],
        shape="(64, 257, 16 h), rate 0.15")
    summary["attention_packed_bwd"] = dict(
        max_abs_err=k2["dqkv"]["max_abs"], ms=k2["ms"],
        no_dropout_ms=k2["no_dropout_ms"], plain_ms=k2["plain_ms"],
        bound_ms=k2["bound"]["bound_ms"], bound_by=k2["bound"]["bound_by"],
        library_ms=k2["sdpa"]["backward_ms"],
        shape="(64, 257, 16 h), rate 0.15")
    del qkv, bias, dout, out, m, l, dqkv, dbias, qh, kh, vh, dh
    torch.cuda.empty_cache()

    # K6 / K7/K8: VideoGPT-B's step shape on its strided head views, and K7's
    rows = {}
    for name, (b, s, packed) in {"K8": (VIDEO_BS, 1024, True),
                                 "K7": (2, 513, False)}.items():
        rate = GPT_DROPOUT
        q, k, v = head_views(b, 12, s, gen, packed)
        dout = torch.randn(b, s, 12, 64, device="cuda",
                           generator=gen).bfloat16().transpose(1, 2)
        seed = random_seed(gen)
        drop = dict(dropout_rate=rate, seed=seed)
        out, m, l = k_attn.attention_fwd(q, k, v, True, True, **drop)
        grads = k_attn.attention_bwd(q, k, v, dout, m, l, True, **drop)
        torch.cuda.synchronize()
        ref = k_attn.attention_fwd_ref(q, k, v, True, **drop)
        row = dict(B=b, S=s, H=12, causal=True, rate=rate,
                   out=rel_errors(out, ref),
                   **dropped_fraction(seed, b, 12, s, True, rate))
        del ref
        refs = k_attn.attention_bwd_ref(q, k, v, dout, m, l, True, **drop)
        row.update({g: rel_errors(a, r)
                    for g, a, r in zip(("dq", "dk", "dv"), grads, refs)})
        del refs
        torch.cuda.empty_cache()
        for key in ("out", "dq", "dk", "dv"):
            require(row[key]["max_rel"] <= BWD_MAX_REL
                    and row[key]["mean_rel"] <= BWD_MEAN_REL
                    and row[key]["mean_rel"] <= (WGMMA_FWD_MEAN_REL
                                                 if key == "out"
                                                 else WGMMA_BWD_MEAN_REL),
                    f"{name} with dropout disagrees with its plain version: "
                    f"{row}")
        require(all(bool(torch.isfinite(t).all()) for t in (out, *grads))
                and row["sigmas_from_rate"] <= DROP_SIGMAS,
                f"{name} with dropout: non-finite output or mask off the "
                f"rate: {row}")
        row.update(
            fwd_ms=median_ms(lambda: k_attn.attention_fwd(q, k, v, True, True,
                                                          **drop)),
            fwd_no_dropout_ms=median_ms(lambda: k_attn.attention_fwd(
                q, k, v, True, True)),
            fwd_plain_ms=median_ms(lambda: k_attn.attention_fwd_ref(
                q, k, v, True, True, **drop), 3),
            sdpa_fwd_ms=median_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, dropout_p=rate)),
            bwd_ms=median_ms(lambda: k_attn.attention_bwd(
                q, k, v, dout, m, l, True, **drop)),
            bwd_no_dropout_ms=median_ms(lambda: k_attn.attention_bwd(
                q, k, v, dout, m, l, True)),
            bwd_plain_ms=median_ms(lambda: k_attn.attention_bwd_ref(
                q, k, v, dout, m, l, True, **drop), 3),
            sdpa_bwd=sdpa_backward_ms(q, k, v, dout, True, dropout_p=rate),
            fwd_bound=attention_bound(b, 12, s, True, False, dropout=True),
            bwd_bound=attention_bound(b, 12, s, True, True, dropout=True))
        rows[name] = row
        del q, k, v, dout, out, m, l, grads
        torch.cuda.empty_cache()
    emit("kernel", name="attention_fwd/attention_bwd", what="dropout arms",
         K8_shape="(32, 12, S 1024, 64) bf16 causal, strided",
         K7_shape="(2, 12, S 513, 64) bf16 causal",
         sdpa_note="SDPA draws its own Philox mask: its time only",
         tolerance=dict(max_rel=BWD_MAX_REL, mean_rel=BWD_MEAN_REL,
                        wgmma_mean_rel_dq_dk_dv=WGMMA_BWD_MEAN_REL,
                        wgmma_fwd_mean_rel_out=WGMMA_FWD_MEAN_REL,
                        dropped_sigmas=DROP_SIGMAS), **rows)
    k8 = rows["K8"]
    summary["attention_fwd"] = dict(
        max_abs_err=k8["out"]["max_abs"], ms=k8["fwd_ms"],
        no_dropout_ms=k8["fwd_no_dropout_ms"], plain_ms=k8["fwd_plain_ms"],
        bound_ms=k8["fwd_bound"]["bound_ms"],
        bound_by=k8["fwd_bound"]["bound_by"], library_ms=k8["sdpa_fwd_ms"],
        shape="(32, 12, 1024, 64) causal, rate 0.1")
    summary["attention_bwd"] = dict(
        max_abs_err=max(k8[g]["max_abs"] for g in ("dq", "dk", "dv")),
        ms=k8["bwd_ms"], no_dropout_ms=k8["bwd_no_dropout_ms"],
        plain_ms=k8["bwd_plain_ms"], bound_ms=k8["bwd_bound"]["bound_ms"],
        bound_by=k8["bwd_bound"]["bound_by"],
        library_ms=k8["sdpa_bwd"]["backward_ms"],
        k7_ms=rows["K7"]["bwd_ms"], k7_bound_ms=rows["K7"]["bwd_bound"]["bound_ms"],
        shape="(32, 12, 1024, 64) causal, rate 0.1")
    return summary


def beyond_one_ulp(out: torch.Tensor, ref: torch.Tensor) -> dict:
    """Elements of bf16 ``out`` more than one bf16 ulp (of the larger of the
    two values) from ``ref``, after a floor of 2^-17 of max |ref| for values
    that cancel in fp32: x̂ = x − mean where x lies near the mean (the mean's
    last fp32 bit depends on the summation order), gelu′ where 1 + tanh
    cancels."""
    out, ref = out.float(), ref.float()
    diff = (out - ref).abs()
    mag = torch.maximum(out.abs(), ref.abs())
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(1e-30))) - 7)
    floor = 2.0 ** -17 * ref.abs().max()
    return dict(max_abs=diff.max().item(),
                beyond_one_ulp=int((diff > ulp + floor).sum()),
                beyond_one_ulp_no_floor=int((diff > ulp).sum()))


# K9c's times beside its single call's: 20 back-to-back calls ("x20") and
# on the card alone ("dev", bench_kernels.device_ms), its own and the
# library call's
LN_BWD_TIMES = ("x20_ms", "dev_ms", "library_x20_ms", "library_dev_ms")


def ln_bwd_times(x, g, peak: float) -> dict:
    """K9c's times at (N, C) = x's shape: its single call, x20 and dev,
    the plain version's, and those of the library's LayerNorm backward
    without weight and bias, its saved mean and 1/σ made beforehand (K9c
    recomputes them); its bound (x and g read, dx written; ~10 fp32 FLOP
    an element over ``peak``)."""
    n, c = x.shape
    _, mean, rstd = torch.ops.aten.native_layer_norm(x, [c], None, None,
                                                     k_lnmm.EPS)

    def kernel():
        k_lnmm.ln_bwd(x, g)

    def library():
        torch.ops.aten.native_layer_norm_backward(
            g, x, [c], mean, rstd, None, None, [True, False, False])

    return dict(ms=median_ms(kernel), x20_ms=batched_ms(kernel),
                dev_ms=device_ms(kernel),
                plain_ms=median_ms(lambda: k_lnmm.ln_bwd_ref(x, g)),
                library_ms=median_ms(library),
                library_x20_ms=batched_ms(library),
                library_dev_ms=device_ms(library),
                bound=bound(10 * n * c, 3 * x.element_size() * n * c,
                            peak=peak))


# K9a's times beside its single call's, at each site: 20 back-to-back calls
# and on the card alone, its own, the serving form's (no gradient) and the
# library product's
K9A_TIMES = ("x20_ms", "dev_ms", "serving_dev_ms", "library_dev_ms")


def k9a_times(x, w, b, gelu: bool, xhat) -> dict:
    """K9a's times at one site on x, w, b: single call, x20 and dev, the
    serving form's single call and dev, the plain version's, and those of
    ``F.linear`` on x̂ (the product alone); its bound (each input read once,
    each output written once: x, W, b; z, zpre at fc1 and x̂)."""
    n, c = x.shape
    f = w.shape[0]
    elem = x.element_size()

    def kernel():
        k_lnmm.ln_matmul_fwd(x, w, b, gelu)

    def serving():
        k_lnmm.ln_matmul_fwd(x, w, b, gelu, residuals=False)

    def library():
        F.linear(xhat, w, b)

    fp32 = x.dtype == torch.float32
    return dict(ms=median_ms(kernel), x20_ms=batched_ms(kernel),
                dev_ms=device_ms(kernel), serving_ms=median_ms(serving),
                serving_dev_ms=device_ms(serving),
                plain_ms=median_ms(lambda: k_lnmm.ln_matmul_fwd_ref(
                    x, w, b, gelu), 5),
                library_ms=median_ms(library),
                library_dev_ms=device_ms(library),
                plan=k_lnmm.tile_plan(n, f, fp32),
                bound=bound(2 * n * c * f,
                            elem * (2 * n * c + f * c + (f if b is not None
                                                         else 0)
                                    + (2 if gelu else 1) * n * f),
                            **({"peak": PEAK_SPLIT_FLOPS} if fp32 else {})))


def ln_rows_check(x32: torch.Tensor) -> dict:
    """K9a's row pre-pass alone on x32 (N, C) fp32 and its bf16 rounding:
    bf16 x̂ within one bf16 ulp of the plain version's; fp32 x̂ within
    FP32_REL, its three parts reassembling the kernel's own fp32 x̂ bit for
    bit. Its dev time and bound (x read, x̂ written; fp32: and its parts)."""
    out = {}
    for x in (x32.bfloat16(), x32):
        xhat, parts = k_lnmm.ln_rows(x)
        torch.cuda.synchronize()
        ref, _ = k_lnmm.ln_rows_ref(x)
        n, c = x.shape
        if parts is None:
            row = beyond_one_ulp(xhat, ref)
            require(row["beyond_one_ulp"] == 0,
                    f"K9a's pre-pass is off its plain version: {row}")
            nbytes = 4 * n * c
        else:
            row = dict(fp32_check("K9a pre-pass", xhat, ref),
                       parts_reassemble=bool(torch.equal(
                           parts.float().sum(0), xhat)))
            require(row["parts_reassemble"],
                    "K9a's pre-pass parts do not reassemble its x̂")
            nbytes = (4 + 4 + 6) * n * c
        row.update(dev_ms=device_ms(lambda: k_lnmm.ln_rows(x)),
                   bound=bound(8 * n * c, nbytes))
        out["fp32" if parts is not None else "bf16"] = row
        del xhat, parts, ref
    return out


def k9a_build() -> dict:
    """ptxas's report (registers, spills) of K9a's kernels, and the dynamic
    shared memory of each instantiation of the product."""
    smem = {(1, 256): k_lnmm.tile_plan(N_ROWS, 3072)["dynamic_smem_bytes"],
            (1, 128): k_lnmm.tile_plan(N_ROWS, 384)["dynamic_smem_bytes"],
            (3, 128): k_lnmm.tile_plan(N_ROWS, 3072, True)[
                "dynamic_smem_bytes"]}
    out = {}
    for name, report in measured.get("ptxas", {}).items():
        base = name.split("<")[0]
        if base in ("ln_matmul_fwd_kernel", "ln_rows_kernel", "split_kernel"):
            args = template_args(name)
            key = (int(args[0]), int(args[1])) if base.startswith(
                "ln_matmul") else None
            out[name] = dict(ptxas=report,
                             dynamic_smem_bytes=smem.get(key, 0))
    return out


def k10_control(g, x, dw_ref, db_ref, splits: int = 4) -> dict:
    """The control of K10's mean limits: dW and db summed from ``splits``
    per-split partial sums over N, each rounded to bf16; must fail them."""
    g32, x32 = g.float(), x.float()
    dw = torch.zeros_like(dw_ref)
    db = torch.zeros_like(db_ref)
    for gp, xp in zip(g32.chunk(splits), x32.chunk(splits)):
        dw += (gp.t() @ xp).bfloat16().float()
        db += gp.sum(0).bfloat16().float()
    row = dict(dw=rel_errors(dw, dw_ref), db=rel_errors(db, db_ref))
    require(row["dw"]["mean_rel"] > K10_DW_MEAN_REL
            and row["db"]["mean_rel"] > K10_DB_MEAN_REL,
            f"K10's control passes its mean limits: {row}")
    return row


def fused_kernels(gen) -> dict:
    """K9a, K9b, K9c and K10 against their plain versions at the fused
    train step's shapes (N 20480 rows: bs 64 · S 320) and edge shapes, then
    their times, bounds and library yardsticks at the step's shapes."""
    def r(*shape, scale=1.0):
        return scale * torch.randn(*shape, device="cuda", generator=gen)

    summary = {}
    # K9a: qkv (no bias, no GELU) and fc1 (bias, GELU, zpre and x̂) of
    # ViT-B; a ragged N at TiTok-S's and ViT-L's widths; C 768 → 384 with a
    # bias and no GELU. x with an offset, as a residual stream has.
    k9a_rows, k9a_max, k9a = [], 0.0, {}
    for n, c, f, bias, gelu in [(N_ROWS, 768, 2304, False, False),
                                (N_ROWS, 768, 3072, True, True),
                                (77, 512, 2048, True, True),
                                (77, 1024, 4096, True, True),
                                (130, 768, 384, True, False)]:
        x = (3 * r(n, c) + 1).bfloat16()
        w = r(f, c, scale=c ** -0.5).bfloat16()
        b = r(f, scale=0.3).bfloat16() if bias else None
        z, zpre, xhat = k_lnmm.ln_matmul_fwd(x, w, b, gelu)
        z_only = k_lnmm.ln_matmul_fwd(x, w, b, gelu, residuals=False)[0]
        torch.cuda.synchronize()
        z_ref, zpre_ref, xhat_ref = k_lnmm.ln_matmul_fwd_ref(x, w, b, gelu)
        row = dict(N=n, C=c, F=f, bias=bias, gelu=gelu, z=rel_errors(z, z_ref),
                   xhat=dict(beyond_one_ulp(xhat, xhat_ref), mean_rel=rel_errors(
                       xhat, xhat_ref)["mean_rel"]),
                   z_same_without_residuals=bool(torch.equal(z, z_only)))
        checks = [row["z"]]
        if gelu:
            row["zpre"] = rel_errors(zpre, zpre_ref)
            checks.append(row["zpre"])
        k9a_rows.append(row)
        require(bool(torch.isfinite(z).all()), f"K9a non-finite at {row}")
        require(all(e["max_rel"] <= BWD_MAX_REL and e["mean_rel"] <= BWD_MEAN_REL
                    and e["mean_rel"] <= LN_MEAN_REL for e in checks)
                and row["xhat"]["beyond_one_ulp"] == 0
                and row["xhat"]["mean_rel"] <= LN_MEAN_REL
                and row["z_same_without_residuals"],
                f"K9a disagrees with its plain version: {row}")
        k9a_max = max(k9a_max, row["z"]["max_abs"])
        if n == N_ROWS and gelu:
            ln_control = ln_stats_control(x, w, b, r(n, c).bfloat16())
        if n == N_ROWS:
            site = "fc1" if gelu else "qkv"
            k9a[site] = k9a_times(x, w, b, gelu, xhat_ref)
        del x, w, b, z, zpre, xhat, z_only, z_ref, zpre_ref, xhat_ref
    prepass = ln_rows_check(r(N_ROWS, 768, scale=3.0) + 1)
    build = k9a_build()
    emit("kernel", name="ln_matmul_fwd", parity=k9a_rows,
         tolerance=dict(max_rel=BWD_MAX_REL, mean_rel=BWD_MEAN_REL,
                        ln_mean_rel=LN_MEAN_REL, xhat="one bf16 ulp"),
         mean_limit_control=ln_control, prepass=prepass, build=build,
         library="F.linear on a precomputed bf16 x̂: the product alone",
         shape="x (20480, 768) bf16; qkv W (2304, 768), fc1 W (3072, 768)",
         **k9a)
    summary["ln_matmul_fwd"] = dict(
        max_abs_err=k9a_max, ms=k9a["fc1"]["ms"],
        plain_ms=k9a["fc1"]["plain_ms"],
        bound_ms=k9a["fc1"]["bound"]["bound_ms"],
        bound_by=k9a["fc1"]["bound"]["bound_by"],
        library_ms=k9a["fc1"]["library_ms"], shape="fc1 (20480, 768 → 3072)",
        library="F.linear on a precomputed bf16 x̂: the product alone",
        prepass="ln_rows_kernel (csrc/ln_matmul.cu): x̂ before the product",
        **{f"{site}_{k}": k9a[site][k] for site in ("qkv", "fc1")
           for k in K9A_TIMES},
        ptxas={k: v["ptxas"] for k, v in build.items()},
        dynamic_smem_bytes={k: v["dynamic_smem_bytes"]
                            for k, v in build.items() if v["dynamic_smem_bytes"]})

    # K9b: fc1's (20480, 3072) and a ragged N; zpre N(0, 2) reaches the
    # GELU's clamp.
    k9b_rows, k9b_max = [], 0.0
    for n in (N_ROWS, 77):
        zpre = r(n, 3072, scale=2.0).bfloat16()
        dz = r(n, 3072).bfloat16()
        out = k_lnmm.ln_matmul_dgelu(zpre, dz)
        torch.cuda.synchronize()
        row = dict(N=n, F=3072, **beyond_one_ulp(
            out, k_lnmm.ln_matmul_dgelu_ref(zpre, dz)))
        k9b_rows.append(row)
        require(bool(torch.isfinite(out).all()) and row["beyond_one_ulp"] == 0,
                f"K9b disagrees with its plain version: {row}")
        k9b_max = max(k9b_max, row["max_abs"])
        if n == N_ROWS:
            k9b = dict(ms=median_ms(lambda: k_lnmm.ln_matmul_dgelu(zpre, dz)),
                       plain_ms=median_ms(lambda: k_lnmm.ln_matmul_dgelu_ref(
                           zpre, dz)),
                       # zpre and dz read, dzc written; ~30 fp32 FLOP each
                       bound=bound(30 * n * 3072, 3 * 2 * n * 3072,
                                   peak=PEAK_FP32_FLOPS))
    emit("kernel", name="ln_matmul_dgelu", parity=k9b_rows,
         tolerance=dict(per_element="one bf16 ulp"), library=None,
         shape="(20480, 3072) bf16", **k9b)
    summary["ln_matmul_dgelu"] = dict(
        max_abs_err=k9b_max, ms=k9b["ms"], plain_ms=k9b["plain_ms"],
        bound_ms=k9b["bound"]["bound_ms"], bound_by=k9b["bound"]["bound_by"],
        library_ms=None)

    # K9c: the step's (20480, 768), TiTok-S's and ViT-L's widths, ragged N.
    k9c_rows, k9c_max = [], 0.0
    for n, c in [(N_ROWS, 768), (77, 512), (77, 1024), (N_ROWS + 1, 128)]:
        x = (2 * r(n, c) + 0.5).bfloat16()
        g = r(n, c).bfloat16()
        out = k_lnmm.ln_bwd(x, g)
        torch.cuda.synchronize()
        row = dict(N=n, C=c, **rel_errors(out, k_lnmm.ln_bwd_ref(x, g)))
        k9c_rows.append(row)
        require(bool(torch.isfinite(out).all())
                and row["max_rel"] <= BWD_MAX_REL
                and row["mean_rel"] <= BWD_MEAN_REL
                and row["mean_rel"] <= LN_MEAN_REL,
                f"K9c disagrees with its plain version: {row}")
        k9c_max = max(k9c_max, row["max_abs"])
        if n == N_ROWS:
            # The library's LayerNorm backward without weight and bias, its
            # saved mean and 1/σ made beforehand (K9c recomputes them).
            k9c = ln_bwd_times(x, g, PEAK_FP32_FLOPS)
    emit("kernel", name="ln_bwd", parity=k9c_rows,
         tolerance=dict(max_rel=BWD_MAX_REL, mean_rel=BWD_MEAN_REL,
                        ln_mean_rel=LN_MEAN_REL),
         mean_limit_control="with ln_matmul_fwd's",
         library="aten.native_layer_norm_backward (no weight, no bias)",
         shape="(20480, 768) bf16",
         build={k: v for k, v in measured.get("ptxas", {}).items()
                if k.startswith("ln_bwd_kernel<")}, **k9c)
    summary["ln_bwd"] = dict(
        max_abs_err=k9c_max, ms=k9c["ms"], plain_ms=k9c["plain_ms"],
        bound_ms=k9c["bound"]["bound_ms"], bound_by=k9c["bound"]["bound_by"],
        library_ms=k9c["library_ms"],
        library="aten.native_layer_norm_backward (no weight, no bias)",
        **{k: k9c[k] for k in LN_BWD_TIMES})

    # K10: fc2 (g 768 wide, x 3072), fc1 (g 3072, x 768), a ragged N, and
    # TiTok-S's fc1 and fc2 (384 ↔ 1536) at a ragged N, whose F_in of 384
    # leaves the bf16 form's last 256-column tile half past the edge. The
    # plain version is an fp32 product (TF32 off), the kernel's sums run in
    # another order over 20480 terms.
    k10_rows, k10_max, k10, k10_controls = [], 0.0, {}, {}
    for n, fo, fi in [(N_ROWS, 768, 3072), (N_ROWS, 3072, 768),
                      (N_ROWS + 1, 768, 3072), (4099, 1536, 384),
                      (4099, 384, 1536)]:
        g = r(n, fo).bfloat16()
        x = r(n, fi).bfloat16()
        dw, db = k_fc.matmul_dw_db(g, x)
        dw2, db2 = k_fc.matmul_dw_db(g, x)
        torch.cuda.synchronize()
        dw_ref, db_ref = k_fc.matmul_dw_db_ref(g, x)
        row = dict(N=n, F_out=fo, F_in=fi, dw=rel_errors(dw, dw_ref),
                   db=rel_errors(db, db_ref),
                   deterministic=bool(torch.equal(dw, dw2)
                                      and torch.equal(db, db2)))
        k10_rows.append(row)
        require(bool(torch.isfinite(dw).all() and torch.isfinite(db).all())
                and row["dw"]["max_rel"] <= 1e-3 and row["db"]["max_rel"] <= 1e-4
                and row["dw"]["mean_rel"] <= K10_DW_MEAN_REL
                and row["db"]["mean_rel"] <= K10_DB_MEAN_REL
                and row["deterministic"],
                f"K10 disagrees with its plain version: {row}")
        k10_max = max(k10_max, row["dw"]["max_abs"])
        if n == N_ROWS:
            site = "fc2" if fo < fi else "fc1"
            k10_controls[site] = k10_control(g, x, dw_ref, db_ref)
            k10[site] = dict(
                ms=median_ms(lambda: k_fc.matmul_dw_db(g, x)),
                plain_ms=median_ms(lambda: k_fc.matmul_dw_db_ref(g, x), 5),
                library_ms=median_ms(lambda: torch.mm(g.t(), x)),
                library_dev_ms=device_ms(lambda: torch.mm(g.t(), x)),
                bound=bound(2 * n * fo * fi,
                            2 * n * (fo + fi) + 4 * (fo * fi + fo)),
                # the splits and their ordered sum timed apart, on the card
                # alone: the kernel as the wrapper runs it (dev_ms), the
                # same launch with no block summing the partials, and the
                # difference
                reduction=fc_grad_reduction_ms(g, x))
            k10[site]["dev_ms"] = k10[site]["reduction"]["ms"]
        del g, x, dw, db, dw2, db2, dw_ref, db_ref
    lib = _build.load()
    require(all(lib.fc_grad_tiles(fo, fi) == k_fc.tiles_bf16(fo, fi)
                for fo, fi in ((768, 3072), (3072, 768), (384, 1536))),
            "K10's tiles differ between the source and kernels/fc_grad.py")
    emit("kernel", name="fc_grad", parity=k10_rows,
         tolerance=dict(dw_max_rel=1e-3, db_max_rel=1e-4,
                        dw_mean_rel=K10_DW_MEAN_REL,
                        db_mean_rel=K10_DB_MEAN_REL),
         mean_limit_control=k10_controls,
         build={k: dict(ptxas=v, dynamic_smem_bytes=lib.fc_grad_smem(0))
                for k, v in measured.get("ptxas", {}).items()
                if k.startswith("fc_grad_bf16_kernel")},
         library="torch.mm(g.t(), x) in bf16: dW alone, rounded to bf16, no db",
         shape="fc2: g (20480, 768), x (20480, 3072); fc1 transposed", **k10)
    summary["fc_grad"] = dict(
        max_abs_err=k10_max, ms=k10["fc2"]["ms"],
        dev_ms=k10["fc2"]["dev_ms"], splits=k10["fc2"]["reduction"]["splits"],
        plain_ms=k10["fc2"]["plain_ms"],
        bound_ms=k10["fc2"]["bound"]["bound_ms"],
        bound_by=k10["fc2"]["bound"]["bound_by"],
        library_ms=k10["fc2"]["library_ms"],
        shape="fc2: g (20480, 768), x (20480, 3072)",
        library="torch.mm(g.t(), x) in bf16: dW alone, rounded to bf16, no db")
    torch.cuda.empty_cache()
    return summary


def random_tail(n: int, c: int, gen, gamma_scale: float = 0.5):
    """bf16 rows h, x, dy and a tail's fp32 parameters in the Linear layout,
    γ of order ``gamma_scale`` (the init's 1e-6 would hide the tail under
    x)."""
    def r(*shape, scale=1.0):
        return scale * torch.randn(*shape, device="cuda", generator=gen)
    rows = tuple(r(n, c).bfloat16() for _ in range(3))
    params = (1.0 + r(c, scale=0.1), r(c, scale=0.1),
              r(4 * c, c, scale=c ** -0.5), r(4 * c, scale=0.1),
              r(c, 4 * c, scale=(4 * c) ** -0.5), r(c, scale=0.1),
              r(c, scale=gamma_scale))
    return rows, params


def k12a_flat_rows(gen) -> list:
    """K12a against its plain version, within ``K12_REL`` and
    ``Q8_MEAN_REL``, on rows whose every z lies below 0.27, where GELU is
    flat or small (b1 = −1.2, W1 scaled so that u·W1 spreads z by about
    0.25 around it, across GELU's minimum at −0.75): each such row takes
    the absmax of gelu(z) over every element
    (``csrc/convnext_tail_q8.cu:exact_absmax``) instead of from its
    largest and smallest z. At C 96, 192 and 384, N 777, bf16 and fp32
    rows; checks from the plain version's z that every row is such a
    row."""
    rows = []
    for c in (96, 192, 384):
        (h, x, _), (lns, lnb, w1, b1, w2, b2, gamma) = random_tail(777, c, gen)
        w1, b1 = 0.25 * w1, torch.full_like(b1, -1.2)
        for dt in (torch.bfloat16, torch.float32):
            args = (h.to(dt), x.to(dt), lns, lnb, w1, b1, w2, b2, gamma, 1e-6)
            out = k_cnx.convnext_tail_fwd_q8(*args)
            torch.cuda.synchronize()
            ref = k_cnx.convnext_tail_fwd_q8_ref(*args)
            # z as the plain version forms it
            w1q, w1s = k_cnx.quant_cols(w1.t())
            uhat, _ = k_cnx._normalize(args[0], 1e-6)
            uq, us = k_cnx.quant_rows(uhat * lns.to(dt).float()
                                      + lnb.to(dt).float())
            z = torch._int_mm(uq, w1q).float() * us * w1s + b1.to(dt).float()
            row = dict(N=777, C=c, dtype=str(dt)[6:], **rel_errors(out, ref),
                       z_max=float(z.max()), z_min=float(z.min()))
            rows.append(row)
            require(row["z_max"] < 0.27 and bool(torch.isfinite(out).all())
                    and row["max_rel"] <= K12_REL
                    and row["mean_rel"] <= Q8_MEAN_REL,
                    f"K12a disagrees with its plain version on flat rows: {row}")
            del out, ref, z
        del h, x
    return rows


def k12b_near_half_rows(gen) -> list:
    """K12b against its plain version on rows whose dz levels lie at
    near-half quotients, where the kernels take the IEEE quotient
    (``csrc/convnext_tail_q8.cu``: level, near_half): b1 = 10 puts every z
    where gelu′ is 1 exactly, so dz = da; γ⊙dy is one-hot at channel 0, so
    doq is ±127 there alone; W2 is zero but for its row 0, (k + 0.5)·m/127
    with k random in each column but one, which holds m, so that dz / s =
    127·W2[0, f] / m falls within rounding of k + 0.5. At C 96, 192 and
    384, N 800, bf16 and fp32 rows: checks from the plain version's dz that
    most quotients lie within 4e-5 of a half-integer and holds the kernel
    within K12_REL and Q8_MEAN_REL, fp32 rows within FP32_REL (a level
    flipped from rint(dz / s) moves dh by about a hundredth)."""
    rows = []
    for c in (96, 192, 384):
        (h, _, dy), (lns, lnb, w1, b1, w2, _, gamma) = random_tail(800, c, gen)
        b1, w1 = torch.full_like(b1, 10.0), 0.1 * w1
        k = torch.randint(-127, 127, (4 * c,), device="cuda", generator=gen)
        w2 = torch.zeros_like(w2)
        w2[0] = (k.float() + 0.5) * (0.2 / 127.0)
        w2[0, 5] = 0.2
        dy = torch.zeros_like(dy)
        dy[:, 0] = torch.randn(800, device="cuda", generator=gen)
        gamma = gamma.clone()
        gamma[0] = 1.0
        for dt in (torch.bfloat16, torch.float32):
            args = (h.to(dt), dy.to(dt), lns, lnb, w1, b1, w2, gamma, 1e-6)
            out = k_cnx.convnext_tail_bwd_q8(*args)
            torch.cuda.synchronize()
            ref = k_cnx.convnext_tail_bwd_q8_ref(*args)
            # dz as the plain version forms it (gelu′ = 1 here: dz = da)
            doq, dos = k_cnx.quant_rows(args[1].float() * gamma.to(dt).float())
            w2tq, w2ts = k_cnx.quant_cols(w2)
            dz = torch._int_mm(doq, w2tq).float() * dos * w2ts
            t = dz * torch.reciprocal(
                dz.abs().amax(-1, keepdim=True).clamp_min(1e-8) * (1.0 / 127.0))
            row = dict(N=800, C=c, dtype=str(dt)[6:], **rel_errors(out, ref),
                       near_half=float(((t - t.round()).abs() > 0.49996)
                                       .float().mean()))
            rows.append(row)
            tol = FP32_REL if dt == torch.float32 else K12_REL
            require(row["near_half"] > 0.5 and bool(torch.isfinite(out).all())
                    and row["max_rel"] <= tol
                    and row["mean_rel"] <= min(tol, Q8_MEAN_REL),
                    f"K12b disagrees with its plain version at near-half "
                    f"levels: {row}")
            del out, ref, dz, t
    return rows


def int8_tail_kernels(gen) -> dict:
    """K12a and K12b against their plain versions at the three fused stages'
    shapes of the int8 step and a ragged N, their times and bounds at each
    stage, the plain versions' time and the time of their int8 products
    alone (``torch._int_mm``) at N 12544, C 384, and K12a's ptxas figures
    and shared memory."""
    runs = {"convnext_tail_fwd_q8": dict(rows=[], max=0.0),
            "convnext_tail_bwd_q8": dict(rows=[], max=0.0)}
    for n, c in [(n, c) for _, _, n, c in CNX_STAGES] + [(777, 384)]:
        (h, x, dy), (lns, lnb, w1, b1, w2, b2, gamma) = random_tail(n, c, gen)
        calls = {"convnext_tail_fwd_q8": (
                     k_cnx.convnext_tail_fwd_q8, k_cnx.convnext_tail_fwd_q8_ref,
                     (h, x, lns, lnb, w1, b1, w2, b2, gamma, 1e-6)),
                 "convnext_tail_bwd_q8": (
                     k_cnx.convnext_tail_bwd_q8, k_cnx.convnext_tail_bwd_q8_ref,
                     (h, dy, lns, lnb, w1, b1, w2, gamma, 1e-6))}
        for name, (kernel, plain, args) in calls.items():
            out = kernel(*args)
            torch.cuda.synchronize()
            ref = plain(*args)
            bf16_tail = (k_cnx.convnext_tail_fwd(*args) if name.endswith("fwd_q8")
                         else k_cnx.convnext_tail_bwd(*args))
            row = dict(N=n, C=c, **rel_errors(out, ref),
                       differs_from_bf16_tail=not torch.equal(out, bf16_tail))
            runs[name]["rows"].append(row)
            require(bool(torch.isfinite(out).all()) and row["max_rel"] <= K12_REL
                    and row["mean_rel"] <= Q8_MEAN_REL
                    and row["differs_from_bf16_tail"],
                    f"{name} disagrees with its plain version: {row}")
            runs[name]["max"] = max(runs[name]["max"], row["max_abs"])
            if (n, c) in [(n_, c_) for _, _, n_, c_ in CNX_STAGES]:
                runs[name].setdefault("ms_by_C", {})[c] = median_ms(
                    lambda: kernel(*args))
                runs[name].setdefault("x20_ms_by_C", {})[c] = batched_ms(
                    lambda: kernel(*args))
                runs[name].setdefault("dev_ms_by_C", {})[c] = device_ms(
                    lambda: kernel(*args))
            if (n, c) == (CNX_STAGES[2][2], 384):
                runs[name]["ms"] = runs[name]["ms_by_C"][c]
                runs[name]["plain_ms"] = median_ms(lambda: plain(*args), 5)
        if (n, c) == (CNX_STAGES[2][2], 384):
            q8_control = per_tensor_scale_control(
                calls["convnext_tail_fwd_q8"][2],
                calls["convnext_tail_bwd_q8"][2])
        if (n, c) in [(n_, c_) for _, _, n_, c_ in CNX_STAGES]:
            # the products alone, on int8 operands of the same shapes: the
            # forward's two, the backward's three
            def q(*shape):
                return torch.randint(-127, 128, shape, device="cuda",
                                     generator=gen, dtype=torch.int8)
            a_c, a_4c = q(n, c), q(n, 4 * c)
            w_c4c, w_4cc = q(4 * c, c).t(), q(c, 4 * c).t()   # column-major

            def fwd_products():
                torch._int_mm(a_c, w_c4c)
                torch._int_mm(a_4c, w_4cc)

            def bwd_products():
                torch._int_mm(a_c, w_c4c)
                torch._int_mm(a_c, w_c4c)
                torch._int_mm(a_4c, w_4cc)

            for name, fn in (("convnext_tail_fwd_q8", fwd_products),
                             ("convnext_tail_bwd_q8", bwd_products)):
                runs[name].setdefault("library_dev_ms_by_C", {})[c] = \
                    device_ms(fn)
                if c == 384:
                    runs[name]["library_ms"] = median_ms(fn)
            del a_c, a_4c, w_c4c, w_4cc
        del h, x, dy
        torch.cuda.empty_cache()
    runs["convnext_tail_fwd_q8"]["flat_rows"] = k12a_flat_rows(gen)
    runs["convnext_tail_bwd_q8"]["near_half_rows"] = k12b_near_half_rows(gen)
    # At each stage: the forward's two products of N·C·4C multiply-adds
    # (int8 operations, 2 each), the backward's three (z recomputed, da,
    # du); h and x (h and dy) read, y (dh) written in bf16, the int8
    # weights and their scales read.
    def q8_bounds(n, c):
        rows = 3 * n * c * 2
        return {"convnext_tail_fwd_q8": bound(
                    16 * n * c * c, rows + 2 * 4 * c * c + 4 * (4 * c + c),
                    peak=PEAK_INT8_OPS),
                "convnext_tail_bwd_q8": bound(
                    24 * n * c * c, rows + 3 * 4 * c * c + 4 * (8 * c + c),
                    peak=PEAK_INT8_OPS)}
    by_c = {c: q8_bounds(n, c) for _, _, n, c in CNX_STAGES}
    bounds = by_c[384]
    lib = _build.load()
    q8_build = q8_kernel_build()
    summary = {}
    library = "torch._int_mm of the int8 products alone (2 forward, 3 backward)"
    for name, t in runs.items():
        emit("kernel", name=name, parity=t["rows"],
             tolerance=dict(max_rel=K12_REL, mean_rel=Q8_MEAN_REL),
             mean_limit_control=q8_control[name],
             **{k: t[k] for k in ("flat_rows", "near_half_rows") if k in t},
             ms_C384=t["ms"],
             ms_by_C=t["ms_by_C"], x20_ms_by_C=t["x20_ms_by_C"],
             dev_ms_by_C=t["dev_ms_by_C"],
             bound_ms_by_C={c: b[name]["bound_ms"] for c, b in by_c.items()},
             bound_by_by_C={c: b[name]["bound_by"] for c, b in by_c.items()},
             plain_ms_C384=t["plain_ms"], library_ms_C384=t["library_ms"],
             library_dev_ms_by_C=t["library_dev_ms_by_C"],
             library=library, bound_C384=bounds[name],
             shape="(bs 64 · H · W, C) bf16 rows of ConvNeXt-S stages 0-2",
             summary_shape="C 384, N 12544 (27 of the 33 fused blocks)",
             build={k: v for k, v in q8_build.items()
                    if k.startswith(name + "_kernel<")})
        summary[name] = dict(max_abs_err=t["max"], ms=t["ms"],
                             plain_ms=t["plain_ms"],
                             bound_ms=bounds[name]["bound_ms"],
                             bound_by=bounds[name]["bound_by"],
                             library_ms=t["library_ms"], library=library,
                             dev_ms_by_C=t["dev_ms_by_C"],
                             library_dev_ms_by_C=t["library_dev_ms_by_C"],
                             build={k: v for k, v in q8_build.items()
                                    if k.startswith(name + "_kernel<")})
    return summary


def q8_kernel_build() -> dict:
    """ptxas's report (registers, spills), the dynamic shared memory and the
    blocks an SM holds by it of K12a's and K12b's kernels
    (``convnext_tail_{fwd,bwd}_q8_kernel<C, T>``)."""
    lib = _build.load()
    smem = {"convnext_tail_fwd_q8_kernel": lib.convnext_tail_fwd_q8_smem,
            "convnext_tail_bwd_q8_kernel": lib.convnext_tail_bwd_q8_smem}
    out = {}
    for name, report in measured.get("ptxas", {}).items():
        base = name.partition("<")[0]
        if base in smem:
            b = smem[base](int(template_args(name)[0]))
            out[name] = dict(ptxas=report, dynamic_smem_bytes=b,
                             blocks_per_sm_by_smem=233472 // (b + 1024))
    return out


def k11_bound(shape, elem: int, form: str) -> dict:
    """The least time for K11 at ``shape`` on operands of ``elem`` bytes:
    49 fp32 multiply-adds an output element (form "fwd": K11a; "dx": the
    dx-only K11b), 98 and db's add ("full"), over the published fp32 rate;
    x read and y written (g read, dx written; the full form also reads x and
    writes dw and db in fp32), the taps (and bias) read. Beside it, as
    ``probe``, the same work over P's measured fp32 rate."""
    n_el, c = math.prod(shape), shape[-1]
    if form == "full":
        flop = 2 * 98 * n_el + n_el
        nbytes = 3 * elem * n_el + elem * 49 * c + 4 * 50 * c
    else:
        flop = 2 * 49 * n_el
        nbytes = 2 * elem * n_el + elem * (50 if form == "fwd" else 49) * c
    return dict(bound(flop, nbytes, peak=PEAK_FP32_FLOPS),
                probe=bound(flop, nbytes, peak=measured["fp32_flops"]))


def k11_controls(x, g, w, b, y_ref, dx_ref, dw_ref, db_ref) -> dict:
    """The controls of K11's mean limits on fp32 operands: the plain version
    on x, g, w and b rounded to bf16 (y, dx), and dw and db summed from
    per-image partial sums rounded to bf16; each must fail its limit."""
    xr, gr, wr, br = (t.bfloat16().float() for t in (x, g, w, b))
    row = dict(y=rel_errors(k_dw.depthwise_fwd_ref(xr, wr, br), y_ref),
               dx=rel_errors(k_dw.depthwise_bwd_ref(xr, gr, wr,
                                                    dx_only=True)[0], dx_ref))
    n, h, wd, c = x.shape
    xp, g32 = F.pad(x.float(), (0, 0, 3, 3, 3, 3)), g.float()
    dw = torch.empty(7, 7, c, device=x.device)
    for di in range(7):
        for dj in range(7):
            dw[di, dj] = (xp[:, di:di + h, dj:dj + wd] * g32).sum(
                (1, 2)).bfloat16().float().sum(0)
    row.update(dw=rel_errors(dw, dw_ref),
               db=rel_errors(g32.sum((1, 2)).bfloat16().float().sum(0),
                             db_ref))
    require(row["y"]["mean_rel"] > K11_MEAN_REL
            and row["dx"]["mean_rel"] > K11_MEAN_REL
            and row["dw"]["mean_rel"] > K11_DW_MEAN_REL
            and row["db"]["mean_rel"] > K11_DW_MEAN_REL,
            f"a K11 control passes its mean limit: {row}")
    return row


def depthwise_kernels(gen) -> dict:
    """K11a, K11b's dx-only form and its full form against their plain
    versions in fp32 and bf16 at ConvNeXt-S's four stages at bs 64 and a
    ragged shape (K11_SHAPES): bf16 y and dx within one bf16 ulp, fp32
    within K11_REL of max |plain| and K11_MEAN_REL of mean |plain|, dw and
    db within K11_DW_REL and K11_DW_MEAN_REL, the dx-only dx equal to the
    full form's bit for bit, dx, dw and db the same bits run to run, the
    mean limits' controls failing them (fp32); then at each stage, in both
    dtypes, the three kernels' times, single and 20 back to back, beside
    cuDNN's (``F.conv2d`` channels-last; ``aten.convolution_backward`` with
    output mask [True, False, False] for dx alone and [True, True, True] for
    the full form), their bounds, and the plain versions' times (bf16), with
    the kernels' ptxas figures and each form's tile plan. The summary row
    is stage 0's bf16 row, K11b's in its full form, as earlier runs timed
    them; stage 2 (27 of the perceptual loss's 36 blocks) and the dx-only
    form (what the frozen perceptual trunk launches) beside them."""
    def one_ulp(out, ref) -> int:
        return beyond_one_ulp(out, ref)["beyond_one_ulp_no_floor"]

    rows, times, controls = [], {}, {}
    worst = {"depthwise_fwd": 0.0, "depthwise_bwd": 0.0}
    for shape in K11_SHAPES:
        c = shape[-1]
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(*shape, device="cuda", generator=gen).to(dtype)
            g = torch.randn(*shape, device="cuda", generator=gen).to(dtype)
            w = (torch.randn(7, 7, c, device="cuda", generator=gen) / 7).to(dtype)
            b = torch.randn(c, device="cuda", generator=gen).to(dtype)
            y = k_dw.depthwise_fwd(x, w, b)
            dx, dw, db = k_dw.depthwise_bwd(x, g, w)
            dx2, dw2, db2 = k_dw.depthwise_bwd(x, g, w)
            dxo = k_dw.depthwise_bwd(x, g, w, dx_only=True)[0]
            dxo2 = k_dw.depthwise_bwd(x, g, w, dx_only=True)[0]
            torch.cuda.synchronize()
            y_ref = k_dw.depthwise_fwd_ref(x, w, b)
            dx_ref, dw_ref, db_ref = k_dw.depthwise_bwd_ref(x, g, w)
            row = dict(shape=list(shape), dtype=str(dtype).split(".")[-1],
                       y=rel_errors(y, y_ref), dx=rel_errors(dx, dx_ref),
                       dw=rel_errors(dw, dw_ref), db=rel_errors(db, db_ref),
                       dx_only_equal=bool(torch.equal(dxo, dx)),
                       deterministic=bool(torch.equal(dw, dw2)
                                          and torch.equal(db, db2)
                                          and torch.equal(dx, dx2)
                                          and torch.equal(dxo, dxo2)))
            if dtype == torch.bfloat16:
                row["y_beyond_one_ulp"] = one_ulp(y, y_ref)
                row["dx_beyond_one_ulp"] = one_ulp(dx, dx_ref)
                close = row["y_beyond_one_ulp"] == row["dx_beyond_one_ulp"] == 0
            else:
                close = all(row[k]["max_rel"] <= K11_REL
                            and row[k]["mean_rel"] <= K11_MEAN_REL
                            for k in ("y", "dx"))
                controls[str(shape)] = k11_controls(x, g, w, b, y_ref, dx_ref,
                                                    dw_ref, db_ref)
            rows.append(row)
            require(all(bool(torch.isfinite(t).all()) for t in (y, dx, dw, db))
                    and close and row["dx_only_equal"] and row["deterministic"]
                    and all(row[k]["max_rel"] <= K11_DW_REL
                            and row[k]["mean_rel"] <= K11_DW_MEAN_REL
                            for k in ("dw", "db")),
                    f"K11 disagrees with its plain version: {row}")
            worst["depthwise_fwd"] = max(worst["depthwise_fwd"], row["y"]["max_abs"])
            worst["depthwise_bwd"] = max(worst["depthwise_bwd"], row["dx"]["max_abs"])
            del dx2, dw2, db2, dxo, dxo2, y_ref, dx_ref, dw_ref, db_ref
            if shape in K11_STAGES:
                # cuDNN on the same tensors, channels-last
                xc, gc = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
                wc = w.permute(2, 0, 1)[:, None].contiguous()

                def cudnn_bwd(mask):
                    return lambda: torch.ops.aten.convolution_backward(
                        gc, xc, wc, [c], [1, 1], [3, 3], [1, 1], False,
                        [0, 0], c, mask)

                calls = {
                    "fwd": lambda: k_dw.depthwise_fwd(x, w, b),
                    "dx_only": lambda: k_dw.depthwise_bwd(x, g, w,
                                                          dx_only=True),
                    "full": lambda: k_dw.depthwise_bwd(x, g, w),
                    "cudnn_fwd": lambda: F.conv2d(xc, wc, b, padding=3,
                                                  groups=c),
                    "cudnn_dx_only": cudnn_bwd([True, False, False]),
                    "cudnn_full": cudnn_bwd([True, True, True])}
                t = {}
                for name, fn in calls.items():
                    t[f"{name}_ms"] = median_ms(fn)
                    t[f"{name}_x20_ms"] = batched_ms(fn)
                elem = x.element_size()
                t.update({f"{form}_bound": k11_bound(shape, elem, form)
                          for form in ("fwd", "dx", "full")})
                if dtype == torch.bfloat16:
                    t.update(
                        fwd_plain_ms=median_ms(
                            lambda: k_dw.depthwise_fwd_ref(x, w, b), 3),
                        dx_only_plain_ms=median_ms(
                            lambda: k_dw.depthwise_bwd_ref(
                                x, g, w, dx_only=True), 3),
                        full_plain_ms=median_ms(
                            lambda: k_dw.depthwise_bwd_ref(x, g, w), 3))
                times[(tuple(shape), row["dtype"])] = t
            del x, g, w, b, y, dx, dw, db
            torch.cuda.empty_cache()
    # ptxas's figures of the six instantiations, and the tile plan the C
    # launcher chose for each form (csrc/depthwise.cu:choose_plan: tiles,
    # walk, shared memory and the blocks an SM holds)
    build = {name: report for name, report in measured.get("ptxas", {}).items()
             if name.startswith("depthwise")}
    for shape in K11_SHAPES:
        for bf16 in (True, False):
            for form, what in enumerate(("fwd", "dx-only", "full")):
                build[f"plan {shape} {'bf16' if bf16 else 'fp32'} {what}"] = \
                    k_dw.tile_plan(*shape, bf16, form, torch.cuda.current_device())
    emit("kernel", name="depthwise", parity=rows,
         tolerance=dict(fp32_max_rel=K11_REL, fp32_mean_rel=K11_MEAN_REL,
                        bf16="one bf16 ulp", dw_db_max_rel=K11_DW_REL,
                        dw_db_mean_rel=K11_DW_MEAN_REL,
                        dx_only="equal to the full form's dx"),
         mean_limit_controls=controls,
         library="F.conv2d(groups=C) channels-last; "
                 "aten.convolution_backward, mask [T, F, F] (dx only) and "
                 "[T, T, T] (full)",
         times={f"{k[0]} {k[1]}": v for k, v in times.items()}, build=build)
    t, t2 = (times[(K11_STAGES[s], "bfloat16")] for s in (0, 2))
    stages = {f"{k[0]} {k[1]}": v for k, v in times.items()}
    library = ("F.conv2d(groups=C) / aten.convolution_backward, "
               "channels-last bf16")
    shape = f"{K11_STAGES[0]} bf16 (stage 0)"
    return {"depthwise_fwd": dict(
                max_abs_err=worst["depthwise_fwd"], ms=t["fwd_ms"],
                x20_ms=t["fwd_x20_ms"], plain_ms=t["fwd_plain_ms"],
                bound_ms=t["fwd_bound"]["bound_ms"],
                bound_by=t["fwd_bound"]["bound_by"],
                probe_bound_ms=t["fwd_bound"]["probe"]["bound_ms"],
                library_ms=t["cudnn_fwd_ms"], library=library, shape=shape,
                stage2=dict(shape=f"{K11_STAGES[2]} bf16", ms=t2["fwd_ms"],
                            x20_ms=t2["fwd_x20_ms"],
                            plain_ms=t2["fwd_plain_ms"],
                            bound_ms=t2["fwd_bound"]["bound_ms"],
                            library_ms=t2["cudnn_fwd_ms"]),
                stages={k: {n: v[n] for n in ("fwd_ms", "fwd_x20_ms",
                                              "cudnn_fwd_ms",
                                              "cudnn_fwd_x20_ms")}
                        for k, v in stages.items()}),
            "depthwise_bwd": dict(
                max_abs_err=worst["depthwise_bwd"], ms=t["full_ms"],
                x20_ms=t["full_x20_ms"], plain_ms=t["full_plain_ms"],
                bound_ms=t["full_bound"]["bound_ms"],
                bound_by=t["full_bound"]["bound_by"],
                probe_bound_ms=t["full_bound"]["probe"]["bound_ms"],
                library_ms=t["cudnn_full_ms"], library=library,
                shape=shape + ", the full form (dx, dw, db)",
                dx_only=dict(ms=t["dx_only_ms"], x20_ms=t["dx_only_x20_ms"],
                             plain_ms=t["dx_only_plain_ms"],
                             bound_ms=t["dx_bound"]["bound_ms"],
                             library_ms=t["cudnn_dx_only_ms"]),
                stage2=dict(shape=f"{K11_STAGES[2]} bf16", ms=t2["full_ms"],
                            x20_ms=t2["full_x20_ms"],
                            plain_ms=t2["full_plain_ms"],
                            bound_ms=t2["full_bound"]["bound_ms"],
                            library_ms=t2["cudnn_full_ms"],
                            dx_only=dict(
                                ms=t2["dx_only_ms"],
                                x20_ms=t2["dx_only_x20_ms"],
                                plain_ms=t2["dx_only_plain_ms"],
                                bound_ms=t2["dx_bound"]["bound_ms"],
                                library_ms=t2["cudnn_dx_only_ms"])),
                stages={k: {n: v[n] for n in (
                    "dx_only_ms", "dx_only_x20_ms", "cudnn_dx_only_ms",
                    "cudnn_dx_only_x20_ms", "full_ms", "full_x20_ms",
                    "cudnn_full_ms", "cudnn_full_x20_ms")}
                        for k, v in stages.items()})}


def phase_fma_probe(card: str) -> dict:
    """P against its plain version bit for bit at (64, 128), fp32 and bf16,
    chains 1-6, the script's 4096 steps, x in [1, 2), and in bf16 at
    FMA_GROWTH's constants, where every step changes a; then the rate sweep
    over the card-filling shape (the main path: CUDA events around 20 calls
    after one, as ``vpu_fma_rate`` times them) and ``python -m
    vit_tpu_torch.bench_vpu`` as a subprocess. The best fp32 rate is
    reported beside the published one, which every fp32 bound takes (K11
    also carries a ``probe`` bound at it). Returns P's summary and its
    launches in the sweep."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    parity = []
    for dtype in (torch.float32, torch.bfloat16):
        x = (1 + torch.rand(64, 128, device="cuda", generator=gen)).to(dtype)
        for chains in range(1, k_fma.MAX_CHAINS + 1):
            out = k_fma.fma_chains(x, FMA_ITERS, chains)
            torch.cuda.synchronize()
            ref = k_fma.fma_chains_ref(x, FMA_ITERS, chains)
            parity.append(dict(dtype=str(dtype), chains=chains,
                               equal=bool(torch.equal(out, ref)),
                               max_abs=(out.float() - ref.float()).abs()
                               .max().item()))
    # At the script's constants a bf16 step returns a (c rounds to 1, d is
    # below half an ulp), so the arm above cannot see whether the loop runs:
    # at c = 1 + 2⁻⁷ and d = 2⁻¹⁰ every step changes a.
    x = (1 + torch.rand(64, 128, device="cuda", generator=gen)).bfloat16()
    for chains in range(1, k_fma.MAX_CHAINS + 1):
        out = k_fma.fma_chains(x, FMA_GROWTH_ITERS, chains, *FMA_GROWTH)
        torch.cuda.synchronize()
        ref = k_fma.fma_chains_ref(x, FMA_GROWTH_ITERS, chains, *FMA_GROWTH)
        idle = k_fma.fma_chains_ref(x, 0, chains)
        parity.append(dict(dtype="torch.bfloat16", chains=chains,
                           c=FMA_GROWTH[0], d=FMA_GROWTH[1],
                           iters=FMA_GROWTH_ITERS,
                           equal=bool(torch.equal(out, ref)),
                           steps_change_output=not torch.equal(ref, idle),
                           max_abs=(out.float() - ref.float()).abs()
                           .max().item()))
    require(all(r["equal"] and r.get("steps_change_output", True)
                for r in parity),
            f"P differs from its plain version: {parity}")

    reset_launches()   # the main path's run starts here
    sweep = []
    for dtype in (torch.float32, torch.bfloat16):
        shape = k_fma.default_shape(dtype)
        lanes = FMA_LANES * (2 if dtype == torch.bfloat16 else 1)
        for chains in range(1, k_fma.MAX_CHAINS + 1):
            rate, sec = k_fma.fma_rate(shape, FMA_ITERS, FMA_STEPS, dtype,
                                       chains)
            macs = k_fma.macs(shape, FMA_ITERS, chains)
            sweep.append(dict(dtype=str(dtype), chains=chains, shape=shape,
                              mac_per_s=rate, ms=sec * 1e3,
                              bound_ms=macs / (lanes * BOOST_HZ) * 1e3,
                              share_of_bound=macs / (lanes * BOOST_HZ) / sec))
    launches = k_fma.launches
    best = max((r for r in sweep if r["dtype"] == "torch.float32"),
               key=lambda r: r["mac_per_s"])
    best16 = max((r for r in sweep if r["dtype"] == "torch.bfloat16"),
                 key=lambda r: r["mac_per_s"])
    measured["fp32_flops"] = 2 * best["mac_per_s"]
    x = torch.ones(best["shape"], device="cuda")
    plain_ms = median_ms(
        lambda: k_fma.fma_chains_ref(x, FMA_ITERS, best["chains"]), 1)
    proc = subprocess.run([sys.executable, "-m", "vit_tpu_torch.bench_vpu"],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    lines = proc.stdout.strip().splitlines()
    require(proc.returncode == 0 and len(lines) == 13
            and all("T MAC/s" in s for s in lines[:12])
            and lines[-1].startswith("→ dwconv floor"),
            f"bench_vpu exited {proc.returncode}: {proc.stdout[-2000:]}"
            f"{proc.stderr[-2000:]}")
    emit("fma_probe", card=card, parity=parity, sweep=sweep,
         best_fp32_mac_per_s=best["mac_per_s"],
         best_bf16_mac_per_s=best16["mac_per_s"],
         fp32_flops_measured=measured["fp32_flops"],
         fp32_flops_published=PEAK_FP32_FLOPS,
         note="every fp32 bound below uses the measured fp32 rate",
         plain_ms=plain_ms, entry=lines)
    return dict(max_abs_err=max(r["max_abs"] for r in parity),
                ms=best["ms"], plain_ms=plain_ms, bound_ms=best["bound_ms"],
                bound_by="operations", library_ms=None,
                shape=f"{tuple(best['shape'])} fp32, {best['chains']} chains,"
                      f" {FMA_ITERS} steps", mac_per_s=best["mac_per_s"],
                bf16_mac_per_s=best16["mac_per_s"],
                bf16_ms=best16["ms"], bf16_bound_ms=best16["bound_ms"]), \
        launches


def fp32_check(name: str, out, ref, tol: float = FP32_REL,
               mean_tol: float = FP32_REL) -> dict:
    """rel_errors of an fp32 form against its plain version, held to
    ``tol`` on the max and ``mean_tol`` on the mean."""
    row = rel_errors(out, ref)
    require(bool(torch.isfinite(out).all()) and row["max_rel"] <= tol
            and row["mean_rel"] <= mean_tol,
            f"the fp32 form of {name} disagrees with its plain version: {row}")
    return row


def k9a_f32_exact(x, w, b, gelu: bool, z, zpre) -> dict:
    """K9a's fp32 form beyond its check against the plain version: the mean
    distance of z (and zpre) from the float64 K9a
    (``bench_kernels.exact_ln_matmul_fwd``) within F32_LNMM_MEAN_REL, and
    the two-part control's (x̂ and W rounded to x0 + x1), which must fail
    it."""
    z_ex, zpre_ex = exact_ln_matmul_fwd(x, w, b, gelu)
    got = dict(z=mean_rel(z, z_ex))
    if gelu:
        got["zpre"] = mean_rel(zpre, zpre_ex)
    row = dict(mean_rel_exact=got, two_part_control=mean_rel(
        two_part_ln_matmul_fwd(x, w, b, gelu)[0], z_ex))
    require(max(got.values()) <= F32_LNMM_MEAN_REL,
            f"K9a fp32 is off the float64 K9a: {row}")
    require(row["two_part_control"] > F32_LNMM_MEAN_REL,
            f"K9a's two-part control passes its mean limit: {row}")
    return row


def k3_f32_width(args, y, peak: float) -> dict:
    """K3's fp32 form at one width beyond its check against the plain
    version: its mean distance from the float64 tail
    (``bench_kernels.exact_tail_fwd``) within F32_TAIL_MEAN_REL, with the
    two-part control (u, a and the weights rounded to x0 + x1) that must
    fail it; its single-call, x20 and dev times; its bound at the split
    rate and at the fp32 rate; and the weights' pre-split alone
    (``split_weights``), bit for bit against its plain version, timed,
    with its bound (each fp32 weight read once, its three bf16 parts
    written once)."""
    h, x, lns, lnb, w1, b1, w2, b2, gamma, eps = args
    n, c = h.shape
    exact = exact_tail_fwd(*args)
    two = two_part_tail_fwd(*args)
    # the control against the plain tail too, where SIMT_F32_MEAN_REL["K3"]
    # holds the kernel: recorded, not required to fail that limit
    row = dict(mean_rel_exact=mean_rel(y, exact),
               two_part_control=mean_rel(two, exact),
               two_part_control_plain=mean_rel(
                   two, k_cnx.convnext_tail_fwd_ref(*args)))
    require(row["mean_rel_exact"] <= F32_TAIL_MEAN_REL,
            f"K3 fp32 at C {c} is off the float64 tail: {row}")
    require(row["two_part_control"] > F32_TAIL_MEAN_REL,
            f"K3's two-part control passes its mean limit at C {c}: {row}")
    del exact, two

    def kernel():
        k_cnx.convnext_tail_fwd(*args)

    parts = k_cnx.split_weights(w1, w2)
    torch.cuda.synchronize()
    equal = bool(torch.equal(parts, k_cnx.split_weights_ref(w1, w2)))
    require(equal, f"K3's pre-split differs from its plain version at C {c}")
    # h and x read, y written, the fp32 parameters read once
    nbytes = 3 * n * c * 4 + 4 * (8 * c * c + 6 * c)
    row.update(ms=median_ms(kernel), x20_ms=batched_ms(kernel),
               dev_ms=device_ms(kernel),
               bound=bound(16 * n * c * c, nbytes, peak=PEAK_SPLIT_FLOPS),
               fp32_rate_bound=bound(16 * n * c * c, nbytes, peak=peak),
               split=dict(bit_equal=equal,
                          ms=median_ms(lambda: k_cnx.split_weights(w1, w2)),
                          dev_ms=device_ms(lambda: k_cnx.split_weights(w1,
                                                                       w2)),
                          bound=bound(0.0, 8 * c * c * (4 + 6))))
    return row


def k4_f32_width(args, dh, peak: float) -> dict:
    """K4's fp32 form at one width beyond its check against the plain
    version, as ``k3_f32_width`` holds K3's: its mean distance from the
    float64 tail gradient (``bench_kernels.exact_tail_bwd``) within
    F32_TAIL_BWD_MEAN_REL, with the two-part control (u, do, dz and the
    weights rounded to x0 + x1) that must fail it; its single-call, x20
    and dev times; its bound at the split rate and at the fp32 rate (h and
    dy read, dh written, the fp32 parameters read once; C 384's z pre-pass
    writes and reads gelu'(z) beside them, counted apart as
    ``gz_bytes_ms``)."""
    h, dy, lns, lnb, w1, b1, w2, gamma, eps = args
    n, c = h.shape
    exact = exact_tail_bwd(*args)
    row = dict(mean_rel_exact=mean_rel(dh, exact),
               two_part_control=mean_rel(two_part_tail_bwd(*args), exact))
    require(row["mean_rel_exact"] <= F32_TAIL_BWD_MEAN_REL,
            f"K4 fp32 at C {c} is off the float64 tail gradient: {row}")
    require(row["two_part_control"] > F32_TAIL_BWD_MEAN_REL,
            f"K4's two-part control passes its mean limit at C {c}: {row}")
    del exact

    def kernel():
        k_cnx.convnext_tail_bwd(*args)

    nbytes = 3 * n * c * 4 + 4 * (8 * c * c + 7 * c)
    row.update(ms=median_ms(kernel), x20_ms=batched_ms(kernel),
               dev_ms=device_ms(kernel),
               bound=bound(24 * n * c * c, nbytes, peak=PEAK_SPLIT_FLOPS),
               fp32_rate_bound=bound(24 * n * c * c, nbytes, peak=peak),
               gz_bytes_ms=(2 * n * 4 * c * 4 / PEAK_BYTES_PER_S * 1e3
                            if _build.load().convnext_tail_f32_bwd_gz(c)
                            else 0.0))
    return row


def f32_bwd_check(name: str, out, ref) -> dict:
    """fp32_check of the fp32 backward: FP32_REL on the max, the tighter
    F32_BWD_MEAN_REL on the mean."""
    return fp32_check(name, out, ref, mean_tol=F32_BWD_MEAN_REL)


def split_pass(q, k, v, dout, bias=None) -> dict:
    """The fp32 forms' pre-split pass alone on the backward's operands, or
    the forward's with ``dout`` None (``kernels/attention.py:split_parts``):
    bit for bit against its plain version, its time and its bound (each
    fp32 element read once, its three bf16 parts written once)."""
    parts = k_attn.split_parts(q, k, v, dout, bias)
    torch.cuda.synchronize()
    equal = bool(torch.equal(parts, k_attn.split_parts_ref(q, k, v, dout,
                                                            bias)))
    require(equal, "the pre-split's parts differ from its plain version's")
    del parts
    n = (3 if dout is None else 4) * q.numel()
    return dict(bit_equal=equal,
                ms=median_ms(lambda: k_attn.split_parts(q, k, v, dout, bias)),
                bound=bound(0.0, n * (4 + 6)))


@contextlib.contextmanager
def tf32_on():
    """TF32 for cuBLAS and cuDNN inside the block: the control's setting."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def tf32_control(name: str, plain, ref: torch.Tensor,
                 mean_limit: "float | None" = None) -> dict:
    """The plain version run with TF32 on, in an fp32 form's place, against
    the same plain version with TF32 off: it must fail the form's limit,
    or the limit could not tell an fp32 form from one that multiplies in
    TF32 (and, given ``mean_limit``, the form's own mean limit too).
    ``plain`` computes the form's output."""
    with tf32_on():
        out = plain()
        torch.cuda.synchronize()
    row = rel_errors(out, ref)
    require(row["max_rel"] > FP32_REL or row["mean_rel"] > FP32_REL,
            f"the TF32 control of {name} passes the fp32 limit: {row}")
    if mean_limit is not None:
        require(row["mean_rel"] > mean_limit,
                f"the TF32 control of {name} passes its mean limit "
                f"{mean_limit}: {row}")
    return row


def bf16_operand_control(name: str, plain, args, ref: torch.Tensor,
                         limit: float) -> dict:
    """The plain version on its floating-point operands rounded to bf16, in
    an fp32 form's place, against the plain version on the operands as they
    are: it must fail the form's mean limit."""
    rounded = [t.bfloat16().float() if torch.is_tensor(t)
               and t.is_floating_point() else t for t in args]
    row = rel_errors(plain(*rounded), ref)
    require(row["mean_rel"] > limit,
            f"the bf16-operand control of {name} passes its mean limit "
            f"{limit}: {row}")
    return row


def mask_counts(out: torch.Tensor, scale: float) -> torch.Tensor:
    """Integer counts recovered from a probe's output: out · l / scale with l
    given as 1 (dv) or multiplied in by the caller."""
    return torch.round(out.float() / scale).to(torch.int32)


def fp32_mask_probe(b: int, h: int, s: int, causal: bool, rate: float,
                    gen, packed: bool) -> dict:
    """The fp32 forms' dropout mask against the bf16 forms' and the plain
    mask, bit for bit. With q = k = 0 every unmasked p is 1 and l counts the
    unmasked keys; v one-hot by key residue makes output column c, times l
    over the kept probability's factor, the number of kept keys of residue
    c. With m = 0, l = 1 and dO one-hot by query residue, dv column c over
    that factor counts kept queries through the dk/dv kernel's transposed
    walk. Those counts must be equal, integer for integer, in fp32 (factor
    fp32(scale)), bf16 (p rounded: bf16(scale)) and from the mask itself."""
    seed = random_seed(gen)
    _, scale = k_attn.dropout_consts(rate)
    scales = {torch.float32: scale,
              torch.bfloat16: float(torch.tensor(scale).bfloat16())}
    r = torch.arange(s, device="cuda")
    onehot = (r[:, None] % 64 == torch.arange(64, device="cuda")).float()
    keys = (r + 1).float()[:, None] if causal else torch.full(
        (s, 1), float(s), device="cuda")
    drop = dict(dropout_rate=rate, seed=seed)
    counts = {}
    for dt in (torch.bfloat16, torch.float32):
        stats = (torch.zeros(b, h, s, device="cuda"),
                 torch.ones(b, h, s, device="cuda"))
        oh = onehot.to(dt)
        if packed:
            width = h * 64
            qkv = torch.zeros(b, s, 3 * width, dtype=dt, device="cuda")
            qkv[:, :, 2 * width:] = oh.repeat(1, h)
            bias = torch.zeros(3 * width, device="cuda")
            dout = oh.repeat(1, h)[None].expand(b, s, width).contiguous()
            out = k_attn.attention_packed_fwd(qkv, bias, h, causal, **drop)
            out = out.reshape(b, s, h, 64).transpose(1, 2)
            dv = k_attn.attention_packed_bwd(qkv, bias, dout, *stats, h,
                                             causal, **drop)[0]
            dv = dv[..., 2 * width:].reshape(b, s, h, 64).transpose(1, 2)
        else:
            q = torch.zeros(b, h, s, 64, dtype=dt, device="cuda")
            v = oh[None, None].expand(b, h, s, 64).contiguous()
            out = k_attn.attention_fwd(q, q, v, causal, **drop)
            dv = k_attn.attention_bwd(q, q, v, v, *stats, causal, **drop)[2]
        counts[dt] = (mask_counts(out.float() * keys, scales[dt]),
                      mask_counts(dv, scales[dt]))
    kept = (k_attn._head_mask(seed, b, h, s, rate) > 0).float()
    if causal:
        kept = kept * torch.ones(s, s, device="cuda").tril()
    plain = ((kept @ onehot).to(torch.int32),
             (kept.transpose(-1, -2) @ onehot).to(torch.int32))
    row = dict(B=b, H=h, S=s, causal=causal, rate=rate,
               fp32_equals_bf16=all(torch.equal(a, c) for a, c in zip(
                   counts[torch.float32], counts[torch.bfloat16])),
               fp32_equals_mask=all(torch.equal(a, c) for a, c in zip(
                   counts[torch.float32], plain)),
               kept_share=kept.sum().item() / (b * h * (
                   s * (s + 1) // 2 if causal else s * s)))
    require(row["fp32_equals_bf16"] and row["fp32_equals_mask"],
            f"the fp32 forms' dropout mask differs: {row}")
    return row


def fp32_kernels(gen) -> dict:
    """Every fp32 form against its fp32 plain version on the card (TF32 off)
    at the fp32 paths' shapes, then its time, bound (operations over the
    published fp32 rate, fp32 bytes over the memory rate) and library
    yardstick: SDPA on fp32 tensors (with the backend it picks), ``F.linear``
    for K9a and fp32 ``torch.mm`` for K10. The dropout arms of K1/K2 and
    K6/K8, and the mask probes through the fp32 forms against the bf16
    forms'. Returns {kernel name: its fp32 summary}."""
    def r(*shape, scale=1.0):
        return scale * torch.randn(*shape, device="cuda", generator=gen)

    peak, summary, controls = PEAK_FP32_FLOPS, {}, {}

    def entry(name, row, ms, plain_ms, bnd, library_ms, shape, **kw):
        summary[name] = dict(max_abs_err=row["max_abs"],
                             max_rel=row["max_rel"], mean_rel=row["mean_rel"],
                             ms=ms, plain_ms=plain_ms,
                             bound_ms=bnd["bound_ms"],
                             bound_by=bnd["bound_by"], library_ms=library_ms,
                             shape=shape, **kw)

    probes = [fp32_mask_probe(b, h, s, causal, VIT_DROPOUT if packed
                              else GPT_DROPOUT, gen, packed)
              for b, h, s, causal, packed in [(4, 16, 257, False, True),
                                              (4, 16, 257, True, True),
                                              (2, 12, 1024, True, False),
                                              (2, 12, 513, True, False),
                                              (2, 12, 257, False, False)]]
    emit("fp32_kernels", name="dropout_mask_probe", rows=probes)

    # K1 / K2: TiTok-B's (64, 320, 12 h) with stats, and ViT-L's (64, 257,
    # 16 h) at rate 0.15
    arms = {}
    for arm, (b, s, h, rate) in {"titok": (TRAIN_BS, 320, 12, 0.0),
                                 "vit_dropout": (VIT_BS, 257, 16,
                                                 VIT_DROPOUT)}.items():
        width = h * 64
        qkv = r(b, s, 3 * width)
        bias = r(3 * width, scale=0.3)
        dout = r(b, s, width)
        drop = dict(dropout_rate=rate,
                    seed=random_seed(gen) if rate else None)
        out, m, l = k_attn.attention_packed_fwd(qkv, bias, h, False, True,
                                                **drop)
        dqkv, dbias = k_attn.attention_packed_bwd(qkv, bias, dout, m, l, h,
                                                  False, **drop)
        torch.cuda.synchronize()
        ref, m_ref, l_ref = k_attn.attention_packed_fwd_ref(qkv, bias, h,
                                                            False, True,
                                                            **drop)
        dqkv_ref, dbias_ref = k_attn.attention_packed_bwd_ref(
            qkv, bias, dout, m_ref, l_ref, h, False, **drop)
        qh, kh, vh = k_attn.split_heads(qkv, h, bias)
        exact = exact_attention_fwd(qh, kh, vh, False, **drop)
        heads = (out.reshape(b, s, h, 64).transpose(1, 2), m, l)
        row = dict(**f32_fwd_check("K1", heads, (
                       ref.reshape(b, s, h, 64).transpose(1, 2), m_ref, l_ref),
                       exact),
                   dqkv=f32_bwd_check("K2", dqkv, dqkv_ref),
                   dbias=f32_bwd_check("K2 dbias", dbias, dbias_ref))
        if arm == "titok":
            controls["K1"] = tf32_control(
                "K1", lambda: k_attn.attention_packed_fwd_ref(
                    qkv, bias, h, False, True, **drop)[0], ref)
            controls["K2"] = tf32_control(
                "K2", lambda: k_attn.attention_packed_bwd_ref(
                    qkv, bias, dout, m_ref, l_ref, h, False, **drop)[0],
                dqkv_ref)
        if arm == "titok":
            controls["K1 two parts"] = two_part_fwd_control(qh, kh, vh, False,
                                                            exact, **drop)
        del ref, m_ref, l_ref, dqkv_ref, dbias_ref, exact, heads
        torch.cuda.empty_cache()
        dh = dout.reshape(b, s, h, 64).transpose(1, 2)
        if arm == "titok":
            controls["K2 two parts"] = two_part_control(qh, kh, vh, dh, m, l,
                                                        False)
            row["split"] = split_pass(*k_attn.split_heads(qkv, h), dh, bias)
            row["fwd_split"] = split_pass(*k_attn.split_heads(qkv, h), None,
                                          bias)
        row.update(
            fwd_ms=median_ms(lambda: k_attn.attention_packed_fwd(
                qkv, bias, h, False, True, **drop)),
            fwd_plain_ms=median_ms(lambda: k_attn.attention_packed_fwd_ref(
                qkv, bias, h, False, True, **drop), 3),
            sdpa_fwd_ms=median_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, dropout_p=rate)),
            sdpa_backend=sdpa_backend(qh, kh, vh, False),
            bwd_ms=median_ms(lambda: k_attn.attention_packed_bwd(
                qkv, bias, dout, m, l, h, False, **drop)),
            bwd_plain_ms=median_ms(lambda: k_attn.attention_packed_bwd_ref(
                qkv, bias, dout, m, l, h, False, **drop), 3),
            sdpa_bwd=sdpa_backward_ms(qh, kh, vh, dh, False, dropout_p=rate),
            fwd_bound=attention_bound(b, h, s, False, False,
                                      extra_bytes=3 * width * 4, elem=4,
                                      peak=PEAK_SPLIT_FLOPS,
                                      dropout=bool(rate)),
            fwd_fp32_rate_bound=attention_bound(
                b, h, s, False, False, extra_bytes=3 * width * 4, elem=4,
                peak=peak, dropout=bool(rate)),
            bwd_bound=attention_bound(b, h, s, False, True,
                                      extra_bytes=3 * width * 8, elem=4,
                                      peak=PEAK_SPLIT_FLOPS,
                                      dropout=bool(rate)),
            bwd_fp32_rate_bound=attention_bound(
                b, h, s, False, True, extra_bytes=3 * width * 8, elem=4,
                peak=peak, dropout=bool(rate)))
        arms[arm] = row
        del qkv, bias, dout, out, m, l, dqkv, dbias, qh, kh, vh, dh
        torch.cuda.empty_cache()
    build = hopper_attention_ptxas()
    emit("fp32_kernels", name="attention_packed_fwd/attention_packed_bwd",
         tolerance=dict(max_rel=FP32_REL, mean_rel=FP32_REL,
                        fwd_mean_rel_exact=F32_FWD_MEAN_REL,
                        bwd_mean_rel=F32_BWD_MEAN_REL),
         bound_note="split products: 6 bf16 products per fp32 product "
                    "at 989 TFLOP/s; fp32_rate: the published 67 TFLOP/s",
         build={n: r for n, r in build.items() if fp32_form(n) and (
             packed_form(n) or n.startswith("attention_fwd"))
             and head_width(n) == 64}, **arms)
    for name, key in (("attention_packed_fwd", "fwd"),
                      ("attention_packed_bwd", "bwd")):
        t, d = arms["titok"], arms["vit_dropout"]
        split = t["fwd_split" if key == "fwd" else "split"]
        more = dict(
            fp32_rate_bound_ms=t[f"{key}_fp32_rate_bound"]["bound_ms"],
            split_ms=split["ms"], split_bound_ms=split["bound"]["bound_ms"])
        if key == "fwd":
            more.update(mean_rel_exact={part: t[part]["mean_rel_exact"]
                                        for part in ("out", "m", "l")},
                        dropout_library_ms=d["sdpa_fwd_ms"])
        else:
            more.update(mean_rel_dbias=t["dbias"]["mean_rel"],
                        dropout_library_ms=d["sdpa_bwd"]["backward_ms"])
        entry(name, t["out" if key == "fwd" else "dqkv"], t[f"{key}_ms"],
              t[f"{key}_plain_ms"], t[f"{key}_bound"],
              t["sdpa_fwd_ms"] if key == "fwd"
              else t["sdpa_bwd"]["backward_ms"],
              "(64, 320, 12 h), stats", sdpa_backend=t["sdpa_backend"],
              dropout_ms=d[f"{key}_ms"],
              dropout_bound_ms=d[f"{key}_bound"]["bound_ms"],
              dropout_shape="(64, 257, 16 h), rate 0.15", **more)

    # K6 / K7/K8: VideoGPT-B's (32, 12, 1024) causal head views, with and
    # without dropout 0.1; K7 at (2, 12, 513)
    rows = {}
    for arm, (b, s, rate) in {"K8": (VIDEO_BS, 1024, 0.0),
                              "K8_dropout": (VIDEO_BS, 1024, GPT_DROPOUT),
                              "K7": (2, 513, 0.0)}.items():
        qkv = r(b, s, 3, 12, 64)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        dout = r(b, s, 12, 64).transpose(1, 2)
        drop = dict(dropout_rate=rate,
                    seed=random_seed(gen) if rate else None)
        out, m, l = k_attn.attention_fwd(q, k, v, True, True, **drop)
        grads = k_attn.attention_bwd(q, k, v, dout, m, l, True, **drop)
        torch.cuda.synchronize()
        ref = k_attn.attention_fwd_ref(q, k, v, True, True, **drop)
        exact = exact_attention_fwd(q, k, v, True, **drop)
        row = f32_fwd_check("K6", (out, m, l), ref, exact)
        if arm == "K8":
            controls["K6"] = tf32_control(
                "K6", lambda: k_attn.attention_fwd_ref(q, k, v, True, **drop),
                ref[0])
            controls["K6 two parts"] = two_part_fwd_control(q, k, v, True,
                                                            exact, **drop)
        del ref, exact
        refs = k_attn.attention_bwd_ref(q, k, v, dout, m, l, True, **drop)
        row.update({g: f32_bwd_check("K7/K8", a, c)
                    for g, a, c in zip(("dq", "dk", "dv"), grads, refs)})
        del refs
        torch.cuda.empty_cache()
        if arm == "K8":
            controls["K8 two parts"] = two_part_control(q, k, v, dout, m, l,
                                                        True)
            row["split"] = split_pass(q, k, v, dout)
            row["fwd_split"] = split_pass(q, k, v, None)
        row.update(
            fwd_ms=median_ms(lambda: k_attn.attention_fwd(q, k, v, True, True,
                                                          **drop)),
            bwd_ms=median_ms(lambda: k_attn.attention_bwd(
                q, k, v, dout, m, l, True, **drop)),
            fwd_bound=attention_bound(b, 12, s, True, False, elem=4,
                                      peak=PEAK_SPLIT_FLOPS,
                                      dropout=bool(rate)),
            fwd_fp32_rate_bound=attention_bound(b, 12, s, True, False,
                                                elem=4, peak=peak,
                                                dropout=bool(rate)),
            sdpa_fwd_ms=median_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, dropout_p=rate)),
            bwd_bound=attention_bound(b, 12, s, True, True, elem=4,
                                      peak=PEAK_SPLIT_FLOPS,
                                      dropout=bool(rate)),
            bwd_fp32_rate_bound=attention_bound(b, 12, s, True, True, elem=4,
                                                peak=peak,
                                                dropout=bool(rate)))
        if arm == "K8":
            row.update(
                fwd_plain_ms=median_ms(lambda: k_attn.attention_fwd_ref(
                    q, k, v, True, True), 3),
                bwd_plain_ms=median_ms(lambda: k_attn.attention_bwd_ref(
                    q, k, v, dout, m, l, True), 3),
                sdpa_backend=sdpa_backend(q, k, v, True),
                sdpa_bwd=sdpa_backward_ms(q, k, v, dout, True))
        rows[arm] = row
        del qkv, q, k, v, dout, out, m, l, grads
        torch.cuda.empty_cache()
    emit("fp32_kernels", name="attention_fwd/attention_bwd",
         tolerance=dict(max_rel=FP32_REL, mean_rel=FP32_REL,
                        fwd_mean_rel_exact=F32_FWD_MEAN_REL,
                        bwd_mean_rel=F32_BWD_MEAN_REL),
         build={n: r for n, r in build.items()
                if fp32_form(n) and not packed_form(n)
                and head_width(n) == 64}, **rows)
    k8, k8d = rows["K8"], rows["K8_dropout"]
    entry("attention_fwd", k8["out"], k8["fwd_ms"], k8["fwd_plain_ms"],
          k8["fwd_bound"], k8["sdpa_fwd_ms"], "(32, 12, 1024, 64) causal",
          sdpa_backend=k8["sdpa_backend"], dropout_ms=k8d["fwd_ms"],
          dropout_bound_ms=k8d["fwd_bound"]["bound_ms"],
          dropout_library_ms=k8d["sdpa_fwd_ms"],
          fp32_rate_bound_ms=k8["fwd_fp32_rate_bound"]["bound_ms"],
          split_ms=k8["fwd_split"]["ms"],
          split_bound_ms=k8["fwd_split"]["bound"]["bound_ms"],
          mean_rel_exact={part: k8[part]["mean_rel_exact"]
                          for part in ("out", "m", "l")})
    entry("attention_bwd", k8["dv"], k8["bwd_ms"], k8["bwd_plain_ms"],
          k8["bwd_bound"], k8["sdpa_bwd"]["backward_ms"],
          "(32, 12, 1024, 64) causal", sdpa_backend=k8["sdpa_backend"],
          dropout_ms=k8d["bwd_ms"],
          dropout_bound_ms=k8d["bwd_bound"]["bound_ms"],
          k7_ms=rows["K7"]["bwd_ms"],
          k7_bound_ms=rows["K7"]["bwd_bound"]["bound_ms"],
          fp32_rate_bound_ms=k8["bwd_fp32_rate_bound"]["bound_ms"],
          split_ms=k8["split"]["ms"],
          split_bound_ms=k8["split"]["bound"]["bound_ms"])

    # K3 / K4 and K12b at the three fused stages' shapes; K12a at stage 2's.
    TAIL_FORMS = {"convnext_tail_fwd": "K3", "convnext_tail_bwd": "K4",
                  "convnext_tail_fwd_q8": "K12a",
                  "convnext_tail_bwd_q8": "K12b"}
    # Timed at N 12544, C 384: 16·C² FLOP a row forward, 24·C² backward;
    # h, x (dy) read and y (dh) written in fp32, the weights read once.
    tails = {}
    for n, c in [(n, c) for _, _, n, c in CNX_STAGES]:
        rows3, params = random_tail(n, c, gen)
        h, x, dy = (t.float() for t in rows3)
        lns, lnb, w1, b1, w2, b2, gamma = params
        fwd_args = (h, x, lns, lnb, w1, b1, w2, b2, gamma, 1e-6)
        bwd_args = (h, dy, lns, lnb, w1, b1, w2, gamma, 1e-6)
        calls = {"convnext_tail_fwd": (k_cnx.convnext_tail_fwd,
                                       k_cnx.convnext_tail_fwd_ref, fwd_args),
                 "convnext_tail_bwd": (k_cnx.convnext_tail_bwd,
                                       k_cnx.convnext_tail_bwd_ref, bwd_args)}
        if c == 384:
            calls["convnext_tail_fwd_q8"] = (k_cnx.convnext_tail_fwd_q8,
                                             k_cnx.convnext_tail_fwd_q8_ref,
                                             fwd_args)
        calls["convnext_tail_bwd_q8"] = (k_cnx.convnext_tail_bwd_q8,
                                         k_cnx.convnext_tail_bwd_q8_ref,
                                         bwd_args)
        for name, (kernel, plain, args) in calls.items():
            out = kernel(*args)
            torch.cuda.synchronize()
            ref = plain(*args)
            form = TAIL_FORMS[name]
            # an int8 level flips where the fp32 values round apart (K12_REL)
            row = dict(N=n, C=c, **fp32_check(
                name, out, ref, K12_REL if name.endswith("q8") else FP32_REL,
                min(FP32_REL, Q8_MEAN_REL, SIMT_F32_MEAN_REL[form])
                if name.endswith("q8")
                else min(FP32_REL, SIMT_F32_MEAN_REL[form])))
            if c == 384:
                limit = SIMT_F32_MEAN_REL[form]
                controls[form] = (
                    bf16_operand_control(form, plain, args, ref, limit)
                    if name.endswith("q8") else
                    tf32_control(form, lambda: plain(*args), ref, limit))
            if name == "convnext_tail_fwd":
                row.update(k3_f32_width(args, out, peak))
            elif name == "convnext_tail_bwd":
                row.update(k4_f32_width(args, out, peak))
            t = tails.setdefault(name, dict(rows=[], max=0.0))
            t["rows"].append(row)
            if c == 384:
                t.update(ms=median_ms(lambda: kernel(*args)),
                         plain_ms=median_ms(lambda: plain(*args), 3),
                         row=row)
        del h, x, dy, rows3, out, ref
        torch.cuda.empty_cache()
    n, c = CNX_STAGES[2][2], 384
    rows_b = 3 * n * c * 4
    tail_bounds = {
        # six bf16 wgmma products an fp32 one: at the split rate (the fp32
        # rate beside them, k3_f32_width, k4_f32_width)
        "convnext_tail_fwd": tails["convnext_tail_fwd"]["row"]["bound"],
        "convnext_tail_bwd": tails["convnext_tail_bwd"]["row"]["bound"],
        "convnext_tail_fwd_q8": bound(16 * n * c * c,
                                      rows_b + 2 * 4 * c * c
                                      + 4 * (4 * c + c), peak=PEAK_INT8_OPS),
        "convnext_tail_bwd_q8": bound(24 * n * c * c,
                                      rows_b + 3 * 4 * c * c
                                      + 4 * (8 * c + c), peak=PEAK_INT8_OPS)}
    # the kParts = 3 kernels: K3's, K4's and K4's z pre-pass
    split_build = {k: v for k, v in tail_build().items()
                   if template_args(k)[1:2] == ["3"]
                   or k.startswith("convnext_tail_gz_kernel")}
    for name, t in tails.items():
        k3 = name == "convnext_tail_fwd"
        split = name in ("convnext_tail_fwd", "convnext_tail_bwd")
        build = {k: v for k, v in split_build.items()
                 if k.startswith("convnext_tail_fwd") == k3}
        emit("fp32_kernels", name=name, parity=t["rows"], ms_C384=t["ms"],
             plain_ms_C384=t["plain_ms"], bound_C384=tail_bounds[name],
             tolerance=dict(max_rel=K12_REL if name.endswith("q8")
                            else FP32_REL, mean_rel=FP32_REL,
                            simt_mean_rel=SIMT_F32_MEAN_REL[TAIL_FORMS[name]],
                            **({"q8_mean_rel": Q8_MEAN_REL}
                               if name.endswith("q8") else {}),
                            **({"mean_rel_exact": F32_TAIL_MEAN_REL
                                if k3 else F32_TAIL_BWD_MEAN_REL}
                               if split else {})),
             mean_limit_control=controls[TAIL_FORMS[name]],
             **({"build": build} if split else {}))
        more = {}
        if split:
            rows = {r["C"]: r for r in t["rows"]}
            more = dict(
                ms_by_C={c: r["ms"] for c, r in rows.items()},
                x20_ms_by_C={c: r["x20_ms"] for c, r in rows.items()},
                dev_ms_by_C={c: r["dev_ms"] for c, r in rows.items()},
                bound_ms_by_C={c: r["bound"]["bound_ms"]
                               for c, r in rows.items()},
                fp32_rate_bound_ms_by_C={
                    c: r["fp32_rate_bound"]["bound_ms"]
                    for c, r in rows.items()},
                mean_rel_exact_by_C={c: r["mean_rel_exact"]
                                     for c, r in rows.items()},
                two_part_control_by_C={c: r["two_part_control"]
                                       for c, r in rows.items()},
                ptxas={k: v["ptxas"] for k, v in build.items()},
                dynamic_smem_bytes={k: v["dynamic_smem_bytes"]
                                    for k, v in build.items()})
            if k3:
                more.update(
                    split_ms_by_C={c: r["split"]["ms"]
                                   for c, r in rows.items()},
                    split_bound_ms_by_C={c: r["split"]["bound"]["bound_ms"]
                                         for c, r in rows.items()})
            else:
                more.update(gz_bytes_ms_by_C={c: r["gz_bytes_ms"]
                                              for c, r in rows.items()})
        entry(name, t["row"], t["ms"], t["plain_ms"], tail_bounds[name], None,
              "N 12544, C 384 fp32 rows",
              mean_limit=SIMT_F32_MEAN_REL[TAIL_FORMS[name]],
              mean_rel_max=max(r["mean_rel"] for r in t["rows"]), **more)

    # K9a: fc1 (20480, 768 → 3072) with bias, GELU, zpre and x̂, qkv (→
    # 2304) plain, and the bf16 check's edge shapes; K9b (20480, 3072); K9c
    # (20480, 768); K10 fc2.
    ln_tol = min(FP32_REL, LN_MEAN_REL, SIMT_F32_MEAN_REL["K9a"])
    k9a, k9a_rows = {}, []
    for n, c, f, bias, gelu in [(N_ROWS, 768, 2304, False, False),
                                (N_ROWS, 768, 3072, True, True),
                                (77, 512, 2048, True, True),
                                (77, 1024, 4096, True, True),
                                (130, 768, 384, True, False)]:
        x = 3 * r(n, c) + 1
        w = r(f, c, scale=c ** -0.5)
        b = r(f, scale=0.3) if bias else None
        z, zpre, xhat = k_lnmm.ln_matmul_fwd(x, w, b, gelu)
        torch.cuda.synchronize()
        z_ref, zpre_ref, xhat_ref = k_lnmm.ln_matmul_fwd_ref(x, w, b, gelu)
        row = dict(N=n, C=c, F=f, bias=bias, gelu=gelu,
                   z=fp32_check("K9a", z, z_ref, mean_tol=ln_tol),
                   xhat=fp32_check("K9a x̂", xhat, xhat_ref, mean_tol=ln_tol),
                   **k9a_f32_exact(x, w, b, gelu, z, zpre))
        if gelu:
            row["zpre"] = fp32_check("K9a zpre", zpre, zpre_ref,
                                     mean_tol=ln_tol)
        k9a_rows.append(row)
        if n == N_ROWS and gelu:
            controls["K9a"] = tf32_control(
                "K9a", lambda: k_lnmm.ln_matmul_fwd_ref(x, w, b, True)[0],
                z_ref, SIMT_F32_MEAN_REL["K9a"])
            k9b_zpre = zpre
        if n == N_ROWS:
            site = "fc1" if gelu else "qkv"
            k9a[site] = dict(k9a_times(x, w, b, gelu, xhat_ref),
                             fp32_rate_bound=bound(
                                 2 * n * c * f, 4 * (2 * n * c + f * c + (
                                     f if bias else 0) + (2 if gelu else 1)
                                     * n * f), peak=peak))
            k9a[site]["row"] = row
        del x, w, b, z, zpre, xhat, z_ref, zpre_ref, xhat_ref
    torch.cuda.empty_cache()
    build = {k: v for k, v in k9a_build().items()
             if not k.startswith("ln_matmul_fwd_kernel<1")}
    emit("fp32_kernels", name="ln_matmul_fwd", parity=k9a_rows,
         tolerance=dict(max_rel=FP32_REL, mean_rel=ln_tol,
                        mean_rel_exact=F32_LNMM_MEAN_REL),
         mean_limit_control=dict(tf32=controls["K9a"], two_part={
             f"{r['N']}, {r['C']} → {r['F']}": r["two_part_control"]
             for r in k9a_rows}),
         build=build, **{site: {k: v for k, v in t.items() if k != "row"}
                         for site, t in k9a.items()},
         library="F.linear(x̂, W, b) in fp32, TF32 off: the product alone",
         shape="x (20480, 768) fp32, fc1 W (3072, 768); qkv W (2304, 768)")
    fc1 = k9a["fc1"]
    entry("ln_matmul_fwd", fc1["row"]["z"], fc1["ms"], fc1["plain_ms"],
          fc1["bound"], fc1["library_ms"], "fc1 (20480, 768 → 3072) fp32",
          mean_limit=SIMT_F32_MEAN_REL["K9a"],
          mean_rel_max=max(r[k]["mean_rel"] for r in k9a_rows
                           for k in ("z", "zpre", "xhat") if k in r),
          mean_limit_exact=F32_LNMM_MEAN_REL,
          mean_rel_exact_max=max(max(r["mean_rel_exact"].values())
                                 for r in k9a_rows),
          two_part_control_min=min(r["two_part_control"] for r in k9a_rows),
          fp32_rate_bound_ms=fc1["fp32_rate_bound"]["bound_ms"],
          **{f"{site}_{k}": k9a[site][k] for site in ("qkv", "fc1")
             for k in K9A_TIMES},
          ptxas={k: v["ptxas"] for k, v in build.items()})
    zpre = k9b_zpre
    del k9b_zpre
    dz = r(N_ROWS, 3072)
    out = k_lnmm.ln_matmul_dgelu(zpre, dz)
    torch.cuda.synchronize()
    ref = k_lnmm.ln_matmul_dgelu_ref(zpre, dz)
    controls["K9b"] = bf16_operand_control(
        "K9b", k_lnmm.ln_matmul_dgelu_ref, (zpre, dz), ref,
        SIMT_F32_MEAN_REL["K9b"])
    k9b = dict(parity=fp32_check("K9b", out, ref, mean_tol=min(
                   FP32_REL, SIMT_F32_MEAN_REL["K9b"])),
               ms=median_ms(lambda: k_lnmm.ln_matmul_dgelu(zpre, dz)),
               plain_ms=median_ms(lambda: k_lnmm.ln_matmul_dgelu_ref(zpre,
                                                                     dz)),
               bound=bound(30 * N_ROWS * 3072, 3 * 4 * N_ROWS * 3072,
                           peak=peak))
    emit("fp32_kernels", name="ln_matmul_dgelu", **k9b)
    entry("ln_matmul_dgelu", k9b["parity"], k9b["ms"], k9b["plain_ms"],
          k9b["bound"], None, "(20480, 3072) fp32",
          mean_limit=SIMT_F32_MEAN_REL["K9b"])
    del dz, out, zpre, ref
    x, g = 2 * r(N_ROWS, 768) + 0.5, r(N_ROWS, 768)
    out = k_lnmm.ln_bwd(x, g)
    torch.cuda.synchronize()
    ref = k_lnmm.ln_bwd_ref(x, g)
    controls["K9c"] = bf16_operand_control("K9c", k_lnmm.ln_bwd_ref, (x, g),
                                           ref, SIMT_F32_MEAN_REL["K9c"])
    # The library's LayerNorm backward on the same fp32 tensors, as the
    # bf16 row's
    k9c = dict(parity=fp32_check("K9c", out, ref, mean_tol=min(
                   FP32_REL, LN_MEAN_REL, SIMT_F32_MEAN_REL["K9c"])),
               **ln_bwd_times(x, g, peak))
    emit("fp32_kernels", name="ln_bwd", **k9c,
         library="aten.native_layer_norm_backward on fp32 (no weight, no "
                 "bias; mean and 1/σ given)")
    entry("ln_bwd", k9c["parity"], k9c["ms"], k9c["plain_ms"], k9c["bound"],
          k9c["library_ms"], "(20480, 768) fp32",
          mean_limit=SIMT_F32_MEAN_REL["K9c"],
          **{k: k9c[k] for k in LN_BWD_TIMES})
    del x, g, out, ref
    # K10: fc2 (g 768 wide, x 3072), fc1 (g 3072, x 768), a ragged N;
    # against the plain version and the float64 dW (F32_FCGRAD_MEAN_REL,
    # which the two-part control must fail), deterministic
    k10_tol = min(FP32_REL, SIMT_F32_MEAN_REL["K10"])
    k10, k10_rows = {}, []
    for n, fo, fi in [(N_ROWS, 768, 3072), (N_ROWS, 3072, 768),
                      (N_ROWS + 1, 768, 3072)]:
        g, x = r(n, fo), r(n, fi)
        dw, db = k_fc.matmul_dw_db(g, x)
        dw2, db2 = k_fc.matmul_dw_db(g, x)
        torch.cuda.synchronize()
        dw_ref, db_ref = k_fc.matmul_dw_db_ref(g, x)
        dw_ex, db_ex = exact_fc_grad(g, x)
        row = dict(N=n, F_out=fo, F_in=fi,
                   dw=fp32_check("K10 dW", dw, dw_ref, mean_tol=k10_tol),
                   db=fp32_check("K10 db", db, db_ref, mean_tol=k10_tol),
                   mean_rel_exact=dict(dw=mean_rel(dw, dw_ex),
                                       db=mean_rel(db, db_ex),
                                       plain_dw=mean_rel(dw_ref, dw_ex)),
                   two_part_control=mean_rel(two_part_fc_grad(g, x)[0],
                                             dw_ex),
                   deterministic=bool(torch.equal(dw, dw2)
                                      and torch.equal(db, db2)))
        k10_rows.append(row)
        require(row["deterministic"],
                f"K10 in fp32 is not deterministic: {row}")
        require(row["mean_rel_exact"]["dw"] <= F32_FCGRAD_MEAN_REL,
                f"K10 fp32 is off the float64 dW: {row}")
        require(row["two_part_control"] > F32_FCGRAD_MEAN_REL,
                f"K10's two-part control passes its mean limit: {row}")
        if n == N_ROWS:
            site = "fc2" if fo < fi else "fc1"
            if site == "fc2":
                controls["K10"] = tf32_control(
                    "K10", lambda: k_fc.matmul_dw_db_ref(g, x)[0], dw_ref,
                    SIMT_F32_MEAN_REL["K10"])
            nbytes = 4 * (n * (fo + fi) + fo * fi + fo)
            k10[site] = dict(
                ms=median_ms(lambda: k_fc.matmul_dw_db(g, x)),
                dev_ms=device_ms(lambda: k_fc.matmul_dw_db(g, x)),
                x20_ms=batched_ms(lambda: k_fc.matmul_dw_db(g, x)),
                plain_ms=median_ms(lambda: k_fc.matmul_dw_db_ref(g, x), 5),
                library_ms=median_ms(lambda: torch.mm(g.t(), x)),
                library_dev_ms=device_ms(lambda: torch.mm(g.t(), x)),
                # six bf16 wgmma products an fp32 one: at the split rate,
                # the fp32 rate beside it
                bound=bound(2 * n * fo * fi, nbytes, peak=PEAK_SPLIT_FLOPS),
                fp32_rate_bound=bound(2 * n * fo * fi, nbytes, peak=peak),
                row=row)
        del g, x, dw, db, dw2, db2, dw_ref, db_ref, dw_ex, db_ex
        torch.cuda.empty_cache()
    lib = _build.load()
    build = {}
    for name, report in measured.get("ptxas", {}).items():
        if name.startswith("fc_grad_split_kernel<3>"):
            b = lib.fc_grad_smem(1)
            build[name] = dict(ptxas=report, dynamic_smem_bytes=b,
                               blocks_per_sm_by_smem=233472 // (b + 1024))
    emit("fp32_kernels", name="fc_grad", parity=k10_rows,
         tolerance=dict(max_rel=FP32_REL, mean_rel=k10_tol,
                        mean_rel_exact=F32_FCGRAD_MEAN_REL),
         build=build, **{site: {k: v for k, v in t.items() if k != "row"}
                         for site, t in k10.items()},
         library="torch.mm(g.t(), x) in fp32, TF32 off: dW alone")
    fc2 = k10["fc2"]
    entry("fc_grad", fc2["row"]["dw"], fc2["ms"], fc2["plain_ms"],
          fc2["bound"], fc2["library_ms"],
          "fc2: g (20480, 768), x (20480, 3072) fp32",
          mean_limit=SIMT_F32_MEAN_REL["K10"],
          mean_rel_max=max(r[k]["mean_rel"] for r in k10_rows
                           for k in ("dw", "db")),
          mean_limit_exact=F32_FCGRAD_MEAN_REL,
          mean_rel_exact_max=max(r["mean_rel_exact"]["dw"] for r in k10_rows),
          two_part_control_min=min(r["two_part_control"] for r in k10_rows),
          fp32_rate_bound_ms=fc2["fp32_rate_bound"]["bound_ms"],
          **{f"{site}_{k}": k10[site][k] for site in ("fc2", "fc1")
             for k in ("ms", "dev_ms", "x20_ms", "library_dev_ms")},
          ptxas={k: v["ptxas"] for k, v in build.items()},
          dynamic_smem_bytes={k: v["dynamic_smem_bytes"]
                              for k, v in build.items()},
          blocks_per_sm_by_smem={k: v["blocks_per_sm_by_smem"]
                                 for k, v in build.items()})
    emit("fp32_kernels", name="tf32_control", limit=FP32_REL,
         fwd_mean_limit=F32_FWD_MEAN_REL, bwd_mean_limit=F32_BWD_MEAN_REL,
         simt_mean_limits=SIMT_F32_MEAN_REL, rows=controls,
         what="each plain version with TF32 on against itself with TF32 "
              "off: all fail the fp32 forms' limit; the two-part controls "
              "(the plain version on operands rounded to x0 + x1) fail "
              "F32_FWD_MEAN_REL against the float64 forward (K1, K6) and "
              "F32_BWD_MEAN_REL against the plain backward (K2, K8); the "
              "SIMT forms' controls (TF32 for K3, K4, K9a, K10; operands "
              "rounded to bf16 for K9b, K9c, K12a, K12b) fail their "
              "SIMT_F32_MEAN_REL")
    return summary


def fp32_titok(card: str) -> "tuple[dict, dict]":
    """The flagship TiTok-B step at dtype float32 (``train_titok.py
    --mixed false``): bench.py's widths, ConvNeXt-S at fp32, bs 64, under
    three settings (unfused; VIT_TPU_FUSED_LN=1 VIT_TPU_FUSED_FC=1;
    ``PerceptualLoss(quant="int8")``): the launches of one step, which must
    all be the fp32 forms', its loss, perceptual loss and gradient norm
    against the same first step through the plain versions within 1e-3,
    then one warm-up and two timed steps and the peak memory. Returns the
    launches and the fp32 launches of the three settings."""
    model = TiTok(TiTokConfig(**FLAGSHIP, dtype=torch.float32))
    init_params_(model, torch.Generator().manual_seed(0))
    model = model.cuda().train()
    weights = copy.deepcopy(model.state_dict())
    net = ConvNeXt(dtype=torch.float32)
    init_convnext_(net, torch.Generator().manual_seed(1))
    net_state = net.state_dict()
    images = torch.from_numpy(np.random.default_rng(2).uniform(
        0, 1, (TRAIN_BS, FLAGSHIP["image_size"], FLAGSHIP["image_size"], 3))
        .astype(np.float32)).cuda()
    launches, fp32_launches = {}, {}
    for setting, (ln, fc, quant) in FP32_SETTINGS.items():
        cnx = ConvNeXt(dtype=torch.float32, quant=quant)
        cnx.load_state_dict(net_state)
        perceptual = PerceptualLoss(cnx).cuda()
        model.load_state_dict(weights)
        state = TrainState.create(model, flagship_optimizer())
        usage = torch.zeros(model.config.codebook_size, device="cuda")
        plain = copy.deepcopy((model, state, usage))
        step = make_tokenizer_train_step(model, perceptual_loss_fn=perceptual)
        plain_step = make_tokenizer_train_step(plain[0],
                                               perceptual_loss_fn=perceptual)
        with fused_switches(ln, fc):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()   # the main path's run starts here
            _, _, metrics, recon = step(state, images, usage)
            torch.cuda.synchronize()
            got, got32 = read_launches(), read_fp32_launches()
            with plain_versions():
                _, _, plain_metrics, _ = plain_step(plain[1], images,
                                                    plain[2])
            torch.cuda.synchronize()
            metrics = {k: v.item() for k, v in metrics.items()}
            plain_metrics = {k: v.item() for k, v in plain_metrics.items()}
            rel = {k: abs(metrics[k] - plain_metrics[k]) / abs(
                plain_metrics[k]) for k in ("train/loss",
                                            "train/perceptual_loss",
                                            "train/grad_norm")}
            times = []
            for _ in range(3):   # one warm-up, two timed
                t0 = time.perf_counter()
                step(state, images, usage)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        want = FP32_STEP_LAUNCHES[setting]
        row = dict(launches=got, fp32_launches=got32, metrics=metrics,
                   plain_metrics=plain_metrics, rel_diff=rel,
                   step_ms=times[1:], images_per_s=TRAIN_BS / np.mean(
                       times[1:]) * 1e3,
                   peak_gb=torch.cuda.max_memory_allocated() / 2**30)
        emit("fp32", path=f"titok_step_{setting}", card=card, **row,
             tolerance=dict(rel=FP32_STEP_REL))
        require(all(np.isfinite(v) for v in metrics.values())
                and bool(torch.isfinite(recon).all()),
                f"fp32 {setting} step: non-finite output {metrics}")
        require(got == want, f"fp32 {setting} step launched {got}, "
                             f"expected {want}")
        require(not [k for k, v in got.items() if v and got32.get(k) != v],
                f"fp32 {setting} step: launches that were not fp32 forms: "
                f"{got} vs {got32}")
        require(all(v <= FP32_STEP_REL for v in rel.values()),
                f"fp32 {setting} step vs plain versions: {rel}")
        for d, src in ((launches, got), (fp32_launches, got32)):
            for k, v in src.items():
                d[k] = d.get(k, 0) + v
        del plain, state, perceptual, cnx, step, plain_step
        torch.cuda.empty_cache()
    del model, weights, images
    torch.cuda.empty_cache()
    return launches, fp32_launches


def fp32_videogpt(card: str) -> "tuple[dict, dict]":
    """The VideoGPT-B step at dtype float32 (``train_videogpt.py --mixed
    false``), bs 32, S 1024, over the frozen random TiTok-S at fp32: the
    launches of one step (K6 12, K7/K8 12, K1 6, K5 1, all fp32 forms), the
    first step's loss and gradient norm on the step's codes against the
    plain versions within 1e-3, one warm-up and two timed steps, peak
    memory. Returns the step's launches and fp32 launches."""
    tok = TiTok(TiTokConfig(**VIDEO_TOKENIZER, dtype=torch.float32))
    init_params_(tok, torch.Generator().manual_seed(123))
    tokenizer = FrozenTokenizer(tok.cuda())
    model = VideoGPT(VideoGPTConfig(**VIDEOGPT, dtype=torch.float32))
    init_params_(model, torch.Generator().manual_seed(0))
    model = model.cuda().train()
    videos = video_batch(VIDEO_TOKENIZER["image_size"])
    kernel_model, plain_model = copy.deepcopy(model), copy.deepcopy(model)
    state = TrainState.create(model, make_optimizer(
        1e-4, 5000, 500000, 1e-5, 1e-4, clip_norm=None))
    step = make_videogpt_train_step(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()   # the main path's run starts here
    _, tokens, metrics = step(state, tokenizer, videos)
    torch.cuda.synchronize()
    got, got32 = read_launches(), read_fp32_launches()
    loss, norm = loss_and_grad_norm(kernel_model, tokens)
    with plain_versions():
        plain_loss, plain_norm = loss_and_grad_norm(plain_model, tokens)
    del kernel_model, plain_model
    torch.cuda.empty_cache()
    times = []
    for _ in range(3):   # one warm-up, two timed
        t0 = time.perf_counter()
        step(state, tokenizer, videos)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    rel = dict(loss=abs(loss - plain_loss) / abs(plain_loss),
               grad_norm=abs(norm - plain_norm) / abs(plain_norm))
    emit("fp32", path="videogpt_step", card=card, launches=got,
         fp32_launches=got32, step_loss=metrics["train/loss"].item(),
         loss=loss, grad_norm=norm, plain_loss=plain_loss,
         plain_grad_norm=plain_norm, rel_diff=rel, step_ms=times[1:],
         tokens_per_s=VIDEO_BS * 1024 / np.mean(times[1:]) * 1e3,
         peak_gb=torch.cuda.max_memory_allocated() / 2**30,
         tolerance=dict(rel=FP32_STEP_REL))
    require(np.isfinite(loss) and np.isfinite(norm),
            f"fp32 VideoGPT step: loss {loss}, gradient norm {norm}")
    require(got == VIDEO_STEP_LAUNCHES,
            f"fp32 VideoGPT step launched {got}, expected "
            f"{VIDEO_STEP_LAUNCHES}")
    require(not [k for k, v in got.items() if v and got32.get(k) != v],
            f"fp32 VideoGPT step: launches that were not fp32 forms: {got} "
            f"vs {got32}")
    require(all(v <= FP32_STEP_REL for v in rel.values()),
            f"fp32 VideoGPT step vs plain versions: {rel}")
    del model, state, tok, tokenizer, videos, tokens
    torch.cuda.empty_cache()
    return got, got32


def fp32_vit(card: str) -> "tuple[dict, dict]":
    """ViT-L/16 @256 at dropout 0.15 at dtype float32, bs 64: the step of
    ``train_vit.py --mixed false``. The launches of one step (K1 24 and K2
    24, every one an fp32 form through the dropout branch), the first
    step's logits, loss and gradient norm against the plain versions from
    the same generator state within FP32_STEP_REL, one warm-up and two
    timed steps, peak memory. Returns the step's launches and fp32
    launches."""
    name = "vit_l16_256_drop0.15"
    size, patch, preset, rate = VIT_CELLS[name]
    cfg = ViTConfig(size, 3, patch, preset, 1, rate, dtype=torch.float32)
    model = ViTClassifier(cfg, VIT_CLASSES, device="cuda")
    init_params_(model, torch.Generator(device="cuda").manual_seed(0))
    images, labels = vit_batch(size)
    n_layers = cfg.trans_config.n_layers
    step = make_classifier_train_step(model)
    state = TrainState.create(model, make_optimizer(
        1e-4, 5000, 500000, 1e-5, 1e-2, clip_norm=None))
    gen = torch.Generator(device="cuda").manual_seed(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()   # the main path's run starts here
    _, metrics = step(state, images, labels, gen)
    torch.cuda.synchronize()
    got, got32 = read_launches(), read_fp32_launches()
    dropout = read_dropout_launches()
    want = dict.fromkeys(got, 0)
    want.update(attention_packed_fwd=n_layers, attention_packed_bwd=n_layers)
    require(got == want and all(
        got32[k] == dropout[k] == n_layers
        for k in ("attention_packed_fwd", "attention_packed_bwd")),
        f"fp32 {name} step launched {got}, fp32 {got32}, with dropout "
        f"{dropout}")
    step_loss = metrics["train/loss"].item()
    # lr is 0 at the warmup's first step: the weights are unchanged
    logits, loss, norm = classifier_loss(model, images, labels, 2)
    with plain_versions():
        p_logits, p_loss, p_norm = classifier_loss(model, images, labels, 2)
    torch.cuda.synchronize()
    rel = dict(loss=abs(loss - p_loss) / abs(p_loss),
               grad_norm=abs(norm - p_norm) / abs(p_norm))
    logits_rel = rel_errors(logits, p_logits)
    del logits, p_logits
    times = []
    for _ in range(3):   # one warm-up, two timed
        t0 = time.perf_counter()
        step(state, images, labels, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    emit("fp32", path=name, card=card, launches={k: v for k, v in
                                                 got.items() if v},
         fp32_launches={k: v for k, v in got32.items() if v},
         dropout_launches=dropout, step_loss=step_loss, loss=loss,
         plain_loss=p_loss, grad_norm=norm, plain_grad_norm=p_norm,
         rel_diff=rel, logits=logits_rel, step_ms=times[1:],
         images_per_s=VIT_BS / np.mean(times[1:]) * 1e3,
         peak_gb=torch.cuda.max_memory_allocated() / 2**30,
         tolerance=dict(rel=FP32_STEP_REL))
    require(np.isfinite(step_loss) and np.isfinite(loss)
            and np.isfinite(norm), f"fp32 {name} step: {metrics}")
    require(all(v <= FP32_STEP_REL for v in rel.values())
            and logits_rel["max_rel"] <= FP32_STEP_REL
            and logits_rel["mean_rel"] <= FP32_STEP_REL,
            f"fp32 {name} step vs plain versions: {rel}, logits "
            f"{logits_rel}")
    del model, state, step, images, labels
    torch.cuda.empty_cache()
    return got, got32


def phase_fp32(card: str) -> "tuple[dict, dict]":
    """The fp32 paths: the flagship TiTok-B step in its three settings, the
    VideoGPT-B step and the ViT-L/16 step. Returns their launches and fp32
    launches, summed."""
    launches, fp32_launches = fp32_titok(card)
    for path in (fp32_videogpt, fp32_vit):
        for total, part in zip((launches, fp32_launches), path(card)):
            for k, v in part.items():
                total[k] = total.get(k, 0) + v
    return launches, fp32_launches


def phase_slice(work: Path, model: TiTok) -> dict:
    cfg = model.config
    size, n_tok, n_codes = cfg.image_size, cfg.latent_tokens, cfg.codebook_size
    export_tokenizer(model, str(work / "bs8"), bs=8)
    rng = np.random.default_rng(0)
    batches = [rng.uniform(0, 1, (k, size, size, 3)).astype(np.float32)
               for k in (1, 3, 8, 5, 2)]
    launches = {}
    with serving(str(work / "bs8"), batch_window_ms=20) as url:
        with urllib.request.urlopen(url + "/manifest", timeout=60) as resp:
            manifest = json.loads(resp.read())
        require(manifest["n_tokens"] == n_tok and manifest["bs"] == 8,
                f"manifest: {manifest}")
        try:
            post(url + "/encode", np.zeros((2, size // 2, size // 2, 3),
                                           np.float32))
            raise AssertionError("a wrongly shaped request was accepted")
        except urllib.error.HTTPError as e:
            require(e.code == 400, f"wrong shape gave HTTP {e.code}")

        reset_launches()   # the main path's run starts here
        indices = [None] * len(batches)

        def encode(i):
            indices[i] = post(url + "/encode", batches[i])

        threads = [threading.Thread(target=encode, args=(i,))
                   for i in range(len(batches))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        require(not any(t.is_alive() for t in threads), "encode timed out")
        launches["encode"] = dict(attention_packed_fwd=k_attn.launches,
                                  vq_nearest=k_vq.launches)
        reset_launches()
        recons = [post(url + "/decode", idx) for idx in indices]
        launches["decode"] = dict(attention_packed_fwd=k_attn.launches,
                                  vq_nearest=k_vq.launches)

    for x, idx, rec in zip(batches, indices, recons):
        require(idx.shape == (len(x), n_tok) and idx.dtype == np.int32,
                f"encode gave {idx.shape} {idx.dtype}")
        require(idx.min() >= 0 and idx.max() < n_codes, "index out of range")
        require(rec.shape == (len(x), size, size, 3) and rec.dtype == np.float32,
                f"decode gave {rec.shape} {rec.dtype}")
        require(bool(np.isfinite(rec).all()), "decode is not finite")
    require(launches["encode"]["attention_packed_fwd"] > 0
            and launches["encode"]["vq_nearest"] > 0
            and launches["decode"]["attention_packed_fwd"] > 0,
            f"a kernel of the path never launched: {launches}")

    # The same weights on the card, once with the kernels and once through
    # the plain versions, each request padded to bs as the server pads it
    # (cuBLAS picks its GEMM algorithm by shape, so other shapes would round
    # differently in every matmul).
    ref = copy.deepcopy(model).cuda().eval().requires_grad_(False)

    def run(arr, fn):
        k = len(arr)
        pad = np.zeros((8 - k,) + arr.shape[1:], arr.dtype)
        with torch.inference_mode():
            return fn(torch.from_numpy(np.concatenate([arr, pad])).cuda())[:k]

    def latents(x):
        return run(x, ref.enc).double()

    def encode_from(lat):
        with torch.inference_mode():
            return ref.quant(lat.float())[1].cpu().numpy()

    kernel_lat = torch.cat([latents(x) for x in batches])
    with plain_versions():
        plain_lat = torch.cat([latents(x) for x in batches])
        plain_idx = encode_from(plain_lat)
        plain_rec = np.concatenate([run(i, ref.decode_indices).cpu().numpy()
                                    for i in indices])
    served_idx = np.concatenate(indices)
    require(np.array_equal(served_idx, encode_from(kernel_lat)),
            "served encode differs from the same kernels called directly")

    flips = code_flips(kernel_lat, plain_lat, ref.quant.codebook,
                       torch.from_numpy(served_idx).cuda(),
                       torch.from_numpy(plain_idx).cuda())
    rec_all = np.concatenate(recons)
    rec_rel = float(np.abs(rec_all - plain_rec).max() / np.abs(plain_rec).max())
    emit("slice", requests=len(batches), images=sum(map(len, batches)),
         launches=launches, **flips, decode_max_rel_err=rec_rel,
         tolerance=dict(max_rel_err=MAX_REL_ERR,
                        min_index_agreement=MIN_INDEX_AGREEMENT))
    require_codes_agree(flips, "served encode")
    require(rec_rel <= MAX_REL_ERR,
            f"kernels vs plain: decode {rec_rel:.3g}")
    total = {k: launches["encode"][k] + launches["decode"][k]
             for k in launches["encode"]}
    return total


def require_codes_agree(flips: dict, what: str) -> None:
    """``code_flips``'s verdict: every flip a near-tie, latents within
    MAX_REL_ERR, and codes agreeing on MIN_INDEX_AGREEMENT of positions."""
    require(flips["unexplained_disagreements"] == 0,
            f"{what}: {flips['unexplained_disagreements']} code disagreements "
            "are not near-ties of the measured latent difference")
    require(flips["latent_max_rel_err"] <= MAX_REL_ERR,
            f"{what}: kernels vs plain latents {flips['latent_max_rel_err']:.3g}")
    require(flips["index_agreement"] >= MIN_INDEX_AGREEMENT,
            f"{what} agrees with the plain run on {flips['index_agreement']:.4f}")


def phase_timing(model: TiTok, card: str) -> None:
    """The live model's encode and decode at bs 8 and 64 with the kernels
    and through the plain versions, each from host arrays (the served
    requests' latencies are the serve_export phase's)."""
    size = model.config.image_size
    rng = np.random.default_rng(1)
    model = copy.deepcopy(model).cuda().eval().requires_grad_(False)
    for bs in (8, 64):
        x = rng.uniform(0, 1, (bs, size, size, 3)).astype(np.float32)

        def encode():
            with torch.inference_mode():
                return model.encode(torch.from_numpy(x).cuda())

        idx = encode()

        def decode():
            with torch.inference_mode():
                return model.decode_indices(idx)

        direct = dict(
            encode_ms=host_median_ms(
                lambda: (encode(), torch.cuda.synchronize())),
            decode_ms=host_median_ms(
                lambda: (decode(), torch.cuda.synchronize())))
        with plain_versions():
            direct["plain_encode_ms"] = host_median_ms(
                lambda: (encode(), torch.cuda.synchronize()))
            direct["plain_decode_ms"] = host_median_ms(
                lambda: (decode(), torch.cuda.synchronize()))
        emit("timing", bs=bs, card=card, device_call=direct)
        torch.cuda.empty_cache()


def train_inputs(model: TiTok):
    """The flagship step's frozen ConvNeXt-S perceptual loss (random weights
    from a seed) and its batch of 64 images, on the card."""
    net = ConvNeXt(dtype=torch.bfloat16)
    init_convnext_(net, torch.Generator().manual_seed(1))
    size = model.config.image_size
    images = torch.from_numpy(np.random.default_rng(2).uniform(
        0, 1, (TRAIN_BS, size, size, 3)).astype(np.float32)).cuda()
    return PerceptualLoss(net).cuda(), images


def flagship_optimizer():
    return make_optimizer(1e-4, 5000, 1_000_000, 1e-5, 1e-4, clip_norm=1.0)


@contextlib.contextmanager
def fused_switches(ln: str, fc: str):
    """VIT_TPU_FUSED_LN and VIT_TPU_FUSED_FC set for the block only."""
    saved = {k: os.environ.get(k) for k in ("VIT_TPU_FUSED_LN",
                                            "VIT_TPU_FUSED_FC")}
    os.environ.update(VIT_TPU_FUSED_LN=ln, VIT_TPU_FUSED_FC=fc)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_train(model: TiTok, perceptual, images, card: str) -> dict:
    """The flagship training step: launches, kernels vs plain versions,
    learning on one batch, and throughput. Returns the step's launches."""
    model = model.cuda().train()
    tx = flagship_optimizer()
    state = TrainState.create(model, tx)
    usage = torch.zeros(model.config.codebook_size, device="cuda")
    plain_model, plain_state, plain_usage = copy.deepcopy((model, state, usage))
    step = make_tokenizer_train_step(model, perceptual_loss_fn=perceptual)
    plain_step = make_tokenizer_train_step(plain_model,
                                           perceptual_loss_fn=perceptual)

    torch.cuda.synchronize()
    reset_launches()   # the main path's run starts here
    _, _, metrics, recon = step(state, images, usage)
    torch.cuda.synchronize()
    launches = read_launches()
    require(launches == STEP_LAUNCHES,
            f"one train step launched {launches}, expected {STEP_LAUNCHES}")
    with plain_versions():
        _, _, plain_metrics, _ = plain_step(plain_state, images, plain_usage)
    torch.cuda.synchronize()
    metrics = {k: v.item() for k, v in metrics.items()}
    plain_metrics = {k: v.item() for k, v in plain_metrics.items()}
    require(recon.shape == images.shape and bool(torch.isfinite(recon).all()),
            f"recon {tuple(recon.shape)} is not a finite image batch")
    require(all(np.isfinite(v) for v in metrics.values()),
            f"non-finite metrics {metrics}")
    require(0.0 < metrics["train/codebook_usage"] <= 1.0,
            f"codebook usage {metrics['train/codebook_usage']}")
    rel = {k: abs(metrics[k] - plain_metrics[k]) / abs(plain_metrics[k])
           for k in ("train/loss", "train/perceptual_loss",
                     "train/grad_norm")}
    emit("train", what="first step, kernels vs plain versions",
         launches=launches, metrics=metrics, plain_metrics=plain_metrics,
         rel_diff=rel, tolerance=dict(loss_rel=STEP_LOSS_REL,
                                      grad_norm_rel=STEP_GRAD_NORM_REL))
    require(rel["train/loss"] <= STEP_LOSS_REL
            and rel["train/perceptual_loss"] <= STEP_LOSS_REL
            and rel["train/grad_norm"] <= STEP_GRAD_NORM_REL,
            f"kernel step vs plain step: {rel}")

    # Learning: 20 steps on the same batch with a 2-step warmup.
    quick = TrainState.create(model, make_optimizer(1e-4, 2, 1_000_000, 1e-5,
                                                    1e-4, clip_norm=1.0))
    recon_losses = []
    for _ in range(20):
        recon_losses.append(step(quick, images, usage)[2]["train/recon_loss"])
    recon_losses = torch.stack(recon_losses).tolist()
    emit("train", what="learning on one batch, lr 1e-4, warmup 2",
         first_recon_loss=recon_losses[0], last_recon_loss=recon_losses[-1],
         recon_losses=recon_losses)
    require(recon_losses[-1] < recon_losses[0],
            f"recon loss did not fall: {recon_losses[0]} -> {recon_losses[-1]}")

    # Throughput: host clock around synchronised steps, median of 6 after 2.
    timing = {}
    for name, st, fn, use, ctx in (
            ("kernels", quick, step, usage, contextlib.nullcontext),
            ("plain", plain_state, plain_step, plain_usage, plain_versions)):
        with ctx():
            torch.cuda.reset_peak_memory_stats()
            ms = host_median_ms(
                lambda: (fn(st, images, use), torch.cuda.synchronize()), 6)
        timing[name] = dict(step_ms=ms, images_per_s=TRAIN_BS / ms * 1e3,
                            peak_gb=torch.cuda.max_memory_allocated() / 2**30)
    emit("train", what="throughput at bs 64", card=card, **timing)
    del plain_model, plain_state, quick, state
    torch.cuda.empty_cache()
    return launches


def phase_train_fused(model: TiTok, weights: dict, perceptual, images,
                      card: str) -> dict:
    """The flagship step with the fused kernels switched on as a user
    switches them, VIT_TPU_FUSED_LN=1 VIT_TPU_FUSED_FC=1, on the same
    weights and batch as ``phase_train``: launches, the first step against
    the plain versions and against the unfused kernels, learning, the
    in-step A/B and a profile; then one step with fused FC alone, and a
    bs-64 encode and decode with fused LN. Returns the launches."""
    model = model.cuda().train()
    step = make_tokenizer_train_step(model, perceptual_loss_fn=perceptual)
    usage = torch.zeros(model.config.codebook_size, device="cuda")

    def first_step(ln: str, fc: str, ctx=contextlib.nullcontext):
        """One first step from ``weights`` (lr is 0 at the warmup's first
        step, so it moves no weight): its launches and metrics."""
        model.load_state_dict(weights)
        state = TrainState.create(model, flagship_optimizer())
        with fused_switches(ln, fc), ctx():
            torch.cuda.synchronize()
            reset_launches()   # the main path's run starts here
            _, _, metrics, recon = step(state, images, torch.zeros_like(usage))
            torch.cuda.synchronize()
            launches = read_launches()
        metrics = {k: v.item() for k, v in metrics.items()}
        require(recon.shape == images.shape
                and bool(torch.isfinite(recon).all())
                and all(np.isfinite(v) for v in metrics.values()),
                f"step under LN={ln} FC={fc}: {metrics}")
        return launches, metrics

    def rel(a: dict, b: dict) -> dict:
        return {k: abs(a[k] - b[k]) / abs(b[k])
                for k in ("train/loss", "train/perceptual_loss",
                          "train/grad_norm")}

    def within(r: dict) -> bool:
        return (r["train/loss"] <= STEP_LOSS_REL
                and r["train/perceptual_loss"] <= STEP_LOSS_REL
                and r["train/grad_norm"] <= STEP_GRAD_NORM_REL)

    with held_launches() as worst:
        launches, fused = first_step("1", "1")
    held = require_held(worst, "the first fused step")
    require(launches == FUSED_STEP_LAUNCHES,
            f"one fused step launched {launches}, expected "
            f"{FUSED_STEP_LAUNCHES}")
    _, plain = first_step("1", "1", plain_versions)
    _, unfused = first_step("0", "0")
    rel_plain, rel_unfused = rel(fused, plain), rel(fused, unfused)
    emit("train_fused", what="first fused step vs plain versions and vs the "
         "unfused kernels", launches=launches, metrics=fused,
         plain_metrics=plain, unfused_metrics=unfused,
         rel_diff_plain=rel_plain, rel_diff_unfused=rel_unfused,
         held_launches=held,
         tolerance=dict(loss_rel=STEP_LOSS_REL,
                        grad_norm_rel=STEP_GRAD_NORM_REL))
    require(within(rel_plain), f"fused step vs plain versions: {rel_plain}")
    require(within(rel_unfused),
            f"fused step vs unfused kernels: {rel_unfused}")

    # Fused FC alone: K10 at fc1 and fc2, no K9.
    fc_launches, fc_only = first_step("0", "1")
    require(fc_launches == FC_STEP_LAUNCHES,
            f"one fused-FC step launched {fc_launches}, expected "
            f"{FC_STEP_LAUNCHES}")
    _, fc_plain = first_step("0", "1", plain_versions)
    rel_fc = rel(fc_only, fc_plain)
    emit("train_fused", what="first step with VIT_TPU_FUSED_LN=0 "
         "VIT_TPU_FUSED_FC=1 vs plain versions", launches=fc_launches,
         metrics=fc_only, plain_metrics=fc_plain, rel_diff_plain=rel_fc)
    require(within(rel_fc), f"fused-FC step vs plain versions: {rel_fc}")

    # Learning: 20 fused steps on the same batch with a 2-step warmup.
    model.load_state_dict(weights)
    quick = TrainState.create(model, make_optimizer(1e-4, 2, 1_000_000, 1e-5,
                                                    1e-4, clip_norm=1.0))
    with fused_switches("1", "1"):
        recon_losses = torch.stack([step(quick, images, usage)[2]
                                    ["train/recon_loss"]
                                    for _ in range(20)]).tolist()
    emit("train_fused", what="learning on one batch, lr 1e-4, warmup 2",
         first_recon_loss=recon_losses[0], last_recon_loss=recon_losses[-1],
         recon_losses=recon_losses)
    require(recon_losses[-1] < recon_losses[0],
            f"recon loss did not fall: {recon_losses[0]} -> {recon_losses[-1]}")

    # The in-step A/B, in turns in this run: host clock around synchronised
    # steps, median of 6 after 2.
    timing = {}
    for name, ln, fc, ctx in (("unfused", "0", "0", contextlib.nullcontext),
                              ("fused", "1", "1", contextlib.nullcontext),
                              ("fused_fc_only", "0", "1",
                               contextlib.nullcontext),
                              ("fused_plain", "1", "1", plain_versions)):
        with fused_switches(ln, fc), ctx():
            torch.cuda.reset_peak_memory_stats()
            ms = host_median_ms(
                lambda: (step(quick, images, usage), torch.cuda.synchronize()),
                6)
        timing[name] = dict(step_ms=ms, images_per_s=TRAIN_BS / ms * 1e3,
                            peak_gb=torch.cuda.max_memory_allocated() / 2**30)
    emit("train_fused", what="throughput at bs 64, fused vs unfused",
         card=card, **timing)
    with fused_switches("1", "1"):
        emit("train_fused", what="profile of one fused step", card=card,
             **profile_window(lambda: step(quick, images, usage)))
    del quick
    torch.cuda.empty_cache()

    # Serving with fused LN: a bs-64 encode and decode (K9a without a
    # gradient: 24 launches each, 12 layers × qkv and fc1) against the
    # unfused kernels'.
    model.load_state_dict(weights)
    model.eval()
    serve = {}
    with torch.inference_mode():
        for name, ln in (("fused", "1"), ("unfused", "0")):
            with fused_switches(ln, "0"):
                reset_launches()
                with held_launches() as worst:
                    lat = model.enc(images)
                    idx = model.quant(lat)[1]
                    enc_launches = read_launches()
                    rec = model.decode_indices(idx)
                    torch.cuda.synchronize()
                    dec_launches = read_launches()
                serve[name] = dict(
                    held=require_held(worst, "the fused encode and decode")
                    if ln == "1" else None,
                    lat=lat.double(), idx=idx, rec=rec,
                    encode_launches=enc_launches["ln_matmul_fwd"],
                    decode_launches=(dec_launches["ln_matmul_fwd"]
                                     - enc_launches["ln_matmul_fwd"]),
                    backward_launches=sum(dec_launches[k] for k in (
                        "ln_matmul_dgelu", "ln_bwd", "fc_grad")),
                    encode_ms=host_median_ms(lambda: (
                        model.encode(images), torch.cuda.synchronize())),
                    decode_ms=host_median_ms(lambda: (
                        model.decode_indices(idx), torch.cuda.synchronize())))
    f, u = serve["fused"], serve["unfused"]
    flips = code_flips(f["lat"], u["lat"], model.quant.codebook, f["idx"],
                       u["idx"])
    rec_rel = ((f["rec"] - u["rec"]).abs().max()
               / u["rec"].abs().max()).item()
    emit("train_fused", what="bs-64 encode and decode, VIT_TPU_FUSED_LN=1 "
         "vs unfused kernels", card=card, **flips, decode_max_rel_err=rec_rel,
         held_launches=f["held"],
         **{f"{name}_{k}": v[k] for name, v in serve.items()
            for k in ("encode_launches", "decode_launches", "encode_ms",
                      "decode_ms")})
    sites = [2 * len(vit.transformer.layers)
             for vit in (model.enc.vit, model.dec.vit)]
    require([f["encode_launches"], f["decode_launches"]] == sites
            and f["backward_launches"] == 0 and u["encode_launches"] == 0,
            f"fused serving launched K9a {f['encode_launches']} + "
            f"{f['decode_launches']} times")
    require_codes_agree(flips, "fused encode")
    require(rec_rel <= MAX_REL_ERR, f"fused vs unfused decode: {rec_rel:.3g}")
    total = {k: launches[k] + fc_launches[k] for k in launches}
    total["ln_matmul_fwd"] += f["encode_launches"] + f["decode_launches"]
    del serve, f, u
    torch.cuda.empty_cache()
    return total


def video_batch(tokenizer_size: int) -> torch.Tensor:
    """The first batch of the port's SyntheticVideoLoader (32 uint8 frames
    per video) with train_videogpt.py's random temporal crop to 16 frames,
    scaled to [0, 1], on the card."""
    videos, _ = next(iter(SyntheticVideoLoader(
        VIDEO_BS, frames=2 * VIDEOGPT["max_frames"], image_size=tokenizer_size,
        steps_per_epoch=1, seed=0)))
    crop = np.random.default_rng((0, 0xC407, 0))
    offset = int(crop.integers(0, max(videos.shape[1]
                                      - VIDEOGPT["max_frames"], 1)))
    clip = videos[:, offset:offset + VIDEOGPT["max_frames"]]
    return torch.from_numpy(clip.astype(np.float32) / 255.0).cuda()


def loss_and_grad_norm(model: VideoGPT, tokens: torch.Tensor,
                       generator: "torch.Generator | None" = None):
    """The step's loss and the global norm of its gradients, without the
    optimizer."""
    _, loss = model(tokens, generator)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    return loss.item(), norm.item()


def phase_videogpt_train(card: str):
    """The VideoGPT-B step at bs 32: launches, kernels vs plain versions,
    learning on one batch, throughput, and a profile. Returns the model,
    the tokenizer, the batch's codes and the step's launches."""
    tok_model = TiTok(TiTokConfig(**VIDEO_TOKENIZER))
    init_params_(tok_model, torch.Generator().manual_seed(123))
    tokenizer = FrozenTokenizer(tok_model.cuda())
    model = VideoGPT(VideoGPTConfig(**VIDEOGPT))
    init_params_(model, torch.Generator().manual_seed(0))
    model = model.cuda().train()
    emit("videogpt_model", params=sum(p.numel() for p in model.parameters()),
         tokenizer_params=sum(p.numel() for p in tok_model.parameters()),
         config=VIDEOGPT, tokenizer=VIDEO_TOKENIZER,
         dtype="bfloat16 compute, float32 params")
    videos = video_batch(VIDEO_TOKENIZER["image_size"])
    step = make_videogpt_train_step(model)
    # train_videogpt.py's optimizer: no clip, min_lr = lr / 10
    state = TrainState.create(model, make_optimizer(
        1e-4, 5000, 500000, 1e-5, 1e-4, clip_norm=None))

    torch.cuda.synchronize()
    reset_launches()   # the main path's run starts here
    _, tokens, metrics = step(state, tokenizer, videos)
    torch.cuda.synchronize()
    launches = read_launches()
    require(launches == VIDEO_STEP_LAUNCHES,
            f"one VideoGPT step launched {launches}, expected "
            f"{VIDEO_STEP_LAUNCHES}")
    loss = metrics["train/loss"].item()
    require(tuple(tokens.shape) == (VIDEO_BS, VIDEOGPT["max_frames"],
                                    VIDEOGPT["frame_size"])
            and tokens.dtype == torch.int32
            and 0 <= tokens.min().item()
            and tokens.max().item() < VIDEOGPT["codebook_size"],
            f"tokens {tuple(tokens.shape)} {tokens.dtype}")
    require(np.isfinite(loss), f"loss {loss}")

    # The frozen tokenizer's codes (K1 and K5 on this path) with the kernels
    # and through the plain versions, at the step's 512 frames: the step's
    # codes must be the kernels' own, and every code the plain run picks
    # otherwise a near-tie.
    frames = videos.reshape(-1, *videos.shape[2:])
    with torch.inference_mode():
        kernel_lat = tok_model.enc(frames).double()
        kernel_idx = tok_model.quant(kernel_lat.float())[1]
        with plain_versions():
            plain_lat = tok_model.enc(frames).double()
            plain_idx = tok_model.quant(plain_lat.float())[1]
    require(torch.equal(tokens.reshape(kernel_idx.shape), kernel_idx),
            "the step's codes differ from the same kernels called directly")
    flips = code_flips(kernel_lat, plain_lat, tok_model.quant.codebook,
                       kernel_idx, plain_idx)
    emit("videogpt_train", what="tokenizer codes, kernels vs plain versions",
         frames=len(frames), **flips,
         tolerance=dict(max_rel_err=MAX_REL_ERR,
                        min_index_agreement=MIN_INDEX_AGREEMENT))
    require_codes_agree(flips, "the step's tokenizer codes")
    del frames, kernel_lat, plain_lat

    # The first step's loss and gradient norm with the kernels and through
    # the plain versions, on the same weights (lr is 0 at the first step of
    # the warmup, so the step above moved none) and the same codes.
    kernel_loss, kernel_norm = loss_and_grad_norm(model, tokens)
    with plain_versions():
        plain_loss, plain_norm = loss_and_grad_norm(model, tokens)
    torch.cuda.synchronize()
    rel = dict(loss=abs(kernel_loss - plain_loss) / abs(plain_loss),
               grad_norm=abs(kernel_norm - plain_norm) / abs(plain_norm))
    emit("videogpt_train", what="first step, kernels vs plain versions",
         launches=launches, step_loss=loss, loss=kernel_loss,
         plain_loss=plain_loss, grad_norm=kernel_norm,
         plain_grad_norm=plain_norm, rel_diff=rel,
         tolerance=dict(loss_rel=STEP_LOSS_REL,
                        grad_norm_rel=STEP_GRAD_NORM_REL))
    require(abs(kernel_loss - loss) <= 1e-6 * abs(loss),
            f"the step's loss {loss} is not its forward's {kernel_loss}")
    require(rel["loss"] <= STEP_LOSS_REL
            and rel["grad_norm"] <= STEP_GRAD_NORM_REL,
            f"kernel step vs plain step: {rel}")

    # Learning: 20 steps on the same batch with a 2-step warmup.
    quick = TrainState.create(model, make_optimizer(
        1e-4, 2, 500000, 1e-5, 1e-4, clip_norm=None))
    losses = torch.stack([step(quick, tokenizer, videos)[2]["train/loss"]
                          for _ in range(20)]).tolist()
    emit("videogpt_train", what="learning on one batch, lr 1e-4, warmup 2",
         first_loss=losses[0], last_loss=losses[-1], losses=losses)
    require(losses[-1] < losses[0],
            f"the loss did not fall: {losses[0]} -> {losses[-1]}")

    # Throughput of the full step (host clock around synchronised steps),
    # with the kernels and through the plain versions.
    timing = {}
    for name, ctx, reps in (("kernels", contextlib.nullcontext, 6),
                            ("plain", plain_versions, 3)):
        with ctx():
            torch.cuda.reset_peak_memory_stats()
            ms = host_median_ms(lambda: (step(quick, tokenizer, videos),
                                         torch.cuda.synchronize()), reps)
        timing[name] = dict(step_ms=ms,
                            tokens_per_s=VIDEO_BS * 1024 / ms * 1e3,
                            peak_gb=torch.cuda.max_memory_allocated() / 2**30)
    # The AR step alone on random codes, as scripts/bench_videogpt_step.py
    # times it: make_optimizer(1e-4, 10, 1000, 1e-5, 1e-4) with its clip,
    # one warm-up step, then the mean of 10 steps between synchronisations.
    codes = torch.randint(0, VIDEOGPT["codebook_size"],
                          (VIDEO_BS, VIDEOGPT["max_frames"],
                           VIDEOGPT["frame_size"]), device="cuda",
                          generator=torch.Generator(device="cuda")
                          .manual_seed(0), dtype=torch.int32)
    ar_state = TrainState.create(model, make_optimizer(1e-4, 10, 1000, 1e-5,
                                                       1e-4))

    def ar_step():
        _, ar_loss = model(codes)
        ar_state.apply_gradients(torch.autograd.grad(ar_loss, ar_state.params))

    torch.cuda.reset_peak_memory_stats()
    ar_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        ar_step()
    torch.cuda.synchronize()
    ar_ms = (time.perf_counter() - t0) / 10 * 1e3
    timing["ar_step_alone"] = dict(
        step_ms=ar_ms, tokens_per_s=VIDEO_BS * 1024 / ar_ms * 1e3,
        peak_gb=torch.cuda.max_memory_allocated() / 2**30)
    emit("videogpt_train", what="throughput at bs 32, S 1024", card=card,
         **timing)
    emit("videogpt_train", what="profile of one full step (kernels)",
         card=card, **profile_window(
             lambda: step(quick, tokenizer, videos)))
    del state, quick, ar_state
    torch.cuda.empty_cache()
    dropout_launches = videogpt_dropout(model, tokenizer, videos, card)
    return model.eval(), tokens, launches, dropout_launches


def videogpt_dropout(model: VideoGPT, tokenizer, videos: torch.Tensor,
                     card: str) -> dict:
    """Three steps of the VideoGPT-B step at ``--dropout 0.1`` on the same
    weights and batch: K6 and K8 run their dropout branch (12 launches each
    a step); the first step's loss and gradient norm against the plain
    versions from the same generator state (so both draw the same masks).
    Returns the dropout launches of the first step."""
    drop_model = VideoGPT(VideoGPTConfig(**VIDEOGPT, dropout=GPT_DROPOUT),
                          device="cuda")
    drop_model.load_state_dict(model.state_dict())
    drop_model.train()
    step = make_videogpt_train_step(drop_model)
    state = TrainState.create(drop_model, make_optimizer(
        1e-4, 2, 500000, 1e-5, 1e-4, clip_norm=None))
    gen = torch.Generator(device="cuda").manual_seed(3)
    torch.cuda.synchronize()
    reset_launches()   # the main path's run starts here
    _, tokens, metrics = step(state, tokenizer, videos, gen)
    torch.cuda.synchronize()
    launches, dropout_launches = read_launches(), read_dropout_launches()
    n_layers = drop_model.config.trans_config.n_layers
    want = dict(attention_packed_fwd=0, attention_packed_bwd=0,
                attention_fwd=n_layers, attention_bwd=n_layers)
    require(launches == VIDEO_STEP_LAUNCHES and dropout_launches == want,
            f"one VideoGPT step at dropout {GPT_DROPOUT} launched {launches}, "
            f"with dropout {dropout_launches}")
    losses, times = [metrics["train/loss"].item()], []
    for _ in range(2):
        t0 = time.perf_counter()
        losses.append(step(state, tokenizer, videos, gen)[2]["train/loss"]
                      .item())
        times.append((time.perf_counter() - t0) * 1e3)
    # the first step's loss and gradient norm, kernels vs plain versions,
    # each from the same generator state
    kernel = loss_and_grad_norm(drop_model, tokens,
                                torch.Generator(device="cuda").manual_seed(4))
    with plain_versions():
        plain = loss_and_grad_norm(drop_model, tokens, torch.Generator(
            device="cuda").manual_seed(4))
    torch.cuda.synchronize()
    rel = dict(loss=abs(kernel[0] - plain[0]) / abs(plain[0]),
               grad_norm=abs(kernel[1] - plain[1]) / abs(plain[1]))
    emit("videogpt_train", what=f"dropout {GPT_DROPOUT}: 3 steps, kernels vs "
         "plain versions", card=card, launches=launches,
         dropout_launches=dropout_launches, losses=losses, step_ms=times,
         loss=kernel[0], plain_loss=plain[0], grad_norm=kernel[1],
         plain_grad_norm=plain[1], rel_diff=rel,
         tolerance=dict(loss_rel=STEP_LOSS_REL,
                        grad_norm_rel=STEP_GRAD_NORM_REL))
    require(all(np.isfinite(losses)), f"non-finite losses {losses}")
    require(rel["loss"] <= STEP_LOSS_REL
            and rel["grad_norm"] <= STEP_GRAD_NORM_REL,
            f"dropout step, kernels vs plain versions: {rel}")
    del drop_model, state, step
    torch.cuda.empty_cache()
    return dropout_launches


def vit_batch(image_size: int):
    """bs 64 images in [0, 1] and labels from a numpy seed, on the card."""
    rng = np.random.default_rng(4)
    images = rng.uniform(0, 1, (VIT_BS, image_size, image_size, 3))
    labels = rng.integers(0, VIT_CLASSES, VIT_BS, dtype=np.int32)
    return (torch.from_numpy(images.astype(np.float32)).cuda(),
            torch.from_numpy(labels).cuda())


def classifier_loss(model: ViTClassifier, images, labels, seed: int):
    """Logits, CE and the global gradient norm in training mode, dropout
    drawn from a generator seeded with ``seed``; no optimizer."""
    model.train()
    logits = model(images, torch.Generator(device="cuda").manual_seed(seed))
    loss = F.cross_entropy(logits, labels.long())
    grads = torch.autograd.grad(loss, list(model.parameters()))
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    return logits.detach(), loss.item(), norm.item()


def phase_vit(card: str):
    """``bench_extra.py``'s classifier configs at bs 64: ViT-B/16 @224
    without dropout (S 197) and ViT-L/16 @256 at dropout 0.15 (S 257,
    ``train_vit.py``'s default). For each: the launches of one step (K1
    and K2 once per layer, with dropout under ViT-L), the first step's
    logits, loss and gradient norm against the plain versions from the same
    generator state, 10 steps on one batch at lr 1e-5 that lower the loss,
    images/s and peak memory; a profile of one ViT-L step. Returns the
    launches and the dropout launches of the steps."""
    total, dropout_total = {}, {}
    for name, (size, patch, preset, rate) in VIT_CELLS.items():
        cfg = ViTConfig(size, 3, patch, preset, 1, rate)
        model = ViTClassifier(cfg, VIT_CLASSES, device="cuda")
        init_params_(model, torch.Generator(device="cuda").manual_seed(0))
        images, labels = vit_batch(size)
        n_layers = cfg.trans_config.n_layers
        step = make_classifier_train_step(model)
        state = TrainState.create(model, make_optimizer(
            1e-4, 5000, 500000, 1e-5, 1e-2, clip_norm=None))
        gen = torch.Generator(device="cuda").manual_seed(1)
        torch.cuda.synchronize()
        reset_launches()   # the main path's run starts here
        _, metrics = step(state, images, labels, gen)
        torch.cuda.synchronize()
        launches, dropout_launches = read_launches(), read_dropout_launches()
        want = dict.fromkeys(launches, 0)
        want.update(attention_packed_fwd=n_layers,
                    attention_packed_bwd=n_layers)
        want_drop = dict(attention_packed_fwd=n_layers if rate else 0,
                         attention_packed_bwd=n_layers if rate else 0,
                         attention_fwd=0, attention_bwd=0)
        require(launches == want and dropout_launches == want_drop,
                f"{name}: one step launched {launches}, with dropout "
                f"{dropout_launches}")
        step_loss = metrics["train/loss"].item()
        require(np.isfinite(step_loss)
                and 0.0 <= metrics["train/acc"].item() <= 1.0,
                f"{name}: first step {metrics}")
        # lr is 0 at the warmup's first step: the weights are unchanged
        logits, loss, norm = classifier_loss(model, images, labels, 2)
        with plain_versions():
            p_logits, p_loss, p_norm = classifier_loss(model, images, labels,
                                                       2)
        torch.cuda.synchronize()
        rel = dict(loss=abs(loss - p_loss) / abs(p_loss),
                   grad_norm=abs(norm - p_norm) / abs(p_norm),
                   logits=rel_errors(logits, p_logits))
        emit("vit", cell=name, what="first step, kernels vs plain versions",
             config=dict(image_size=size, patch_size=patch, transformer=preset,
                         dropout=rate, bs=VIT_BS, seq_len=(size // patch) ** 2
                         + 1, num_classes=VIT_CLASSES),
             params=sum(p.numel() for p in model.parameters()),
             launches={k: v for k, v in launches.items() if v},
             dropout_launches=dropout_launches, step_loss=step_loss,
             loss=loss, plain_loss=p_loss, grad_norm=norm, plain_grad_norm=p_norm,
             rel_diff=rel, tolerance=dict(loss_rel=STEP_LOSS_REL,
                                          grad_norm_rel=STEP_GRAD_NORM_REL,
                                          logits_max_rel=MAX_REL_ERR))
        require(rel["loss"] <= STEP_LOSS_REL
                and rel["grad_norm"] <= STEP_GRAD_NORM_REL
                and rel["logits"]["max_rel"] <= MAX_REL_ERR,
                f"{name}: kernel step vs plain step: {rel}")
        del logits, p_logits
        # Learning: 10 steps on the same batch with a 2-step warmup, at lr
        # 1e-5: at 1e-4 without the recipe's 5000-step warmup (and without
        # a clip) ViT-L diverged on an H100 after its third step (8.18 ->
        # 5.57 -> 11.59), while its first step agreed with the plain
        # versions to 3e-5.
        quick = TrainState.create(model, make_optimizer(
            1e-5, 2, 500000, 1e-6, 1e-2, clip_norm=None))
        losses = torch.stack([step(quick, images, labels, gen)[1]["train/loss"]
                              for _ in range(10)]).tolist()
        emit("vit", cell=name, what="learning on one batch, lr 1e-5, warmup 2",
             first_loss=losses[0], last_loss=losses[-1], losses=losses)
        require(losses[-1] < losses[0],
                f"{name}: the loss did not fall: {losses[0]} -> {losses[-1]}")
        # Throughput: host clock around synchronised steps, median of 6
        # after 2.
        torch.cuda.reset_peak_memory_stats()
        ms = host_median_ms(lambda: (step(quick, images, labels, gen),
                                     torch.cuda.synchronize()), 6)
        timing = dict(step_ms=ms, images_per_s=VIT_BS / ms * 1e3,
                      peak_gb=torch.cuda.max_memory_allocated() / 2**30)
        if rate:
            timing["profile"] = profile_window(
                lambda: step(quick, images, labels, gen))
        emit("vit", cell=name, what=f"throughput at bs {VIT_BS}", card=card,
             **timing)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        for k, v in dropout_launches.items():
            dropout_total[k] = dropout_total.get(k, 0) + v
        del model, state, quick, step, images, labels
        torch.cuda.empty_cache()
    return total, dropout_total


def phase_train_vit_entry(card: str, *flags: str) -> None:
    """``python -m vit_tpu_torch.train_vit`` at its defaults (ViT-L/16
    @256, dropout 0.15, bs 64) and ``flags`` (``--mixed false``: fp32) on
    the synthetic stream for one epoch of 5 steps, as a user runs it: return
    code 0, a finite loss on every step's line and the epoch's eval line."""
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_vit_") as tmp:
        cmd = [sys.executable, "-m", "vit_tpu_torch.train_vit", "--dataset",
               "synthetic", "--no_wandb", "--epochs", "1", "--steps_per_epoch",
               "5", "--log_every", "1", "--ckpt_dir", f"{tmp}/ckpt",
               "--run_dir", f"{tmp}/runs", *flags]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=600)
        seconds = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    steps = [re.match(r"e=0 i=\d+ loss=(\S+) acc=\S+ load_time=\S+ "
                      r"step_time=(\S+)", line) for line in lines]
    steps = [(float(m.group(1)), float(m.group(2))) for m in steps if m]
    evals = [re.match(r"epoch 0: val_loss=(\S+), acc=(\S+)", line)
             for line in lines]
    evals = [float(m.group(1)) for m in evals if m]
    emit("train_vit_entry", card=card, cmd=" ".join(cmd[1:]),
         returncode=proc.returncode, seconds=seconds, stdout=lines[-10:],
         stderr=proc.stderr[-3000:] if proc.returncode else "",
         step_losses=[l for l, _ in steps], step_times=[t for _, t in steps],
         val_loss=evals)
    require(proc.returncode == 0,
            f"train_vit exited {proc.returncode}: {proc.stderr[-2000:]}")
    require(len(steps) == 5 and all(np.isfinite(l) for l, _ in steps),
            f"train_vit's step lines: {lines}")
    require(len(evals) == 1 and np.isfinite(evals[0]),
            f"train_vit's eval line: {lines}")


# The train_titok entry: its flags in every run of the phase, the step it
# is sent SIGTERM after and the steps of each short run.
TITOK_ENTRY = ("--dataset", "synthetic", "--bs", "64", "--perceptual_weights",
               "random", "--no_wandb", "--log_every", "1")
PREEMPT_AFTER = 5
SHORT_STEPS = 3
# The committed TPU run the S-scale run is held against, and the limits:
# twice the TPU run's median recon loss over the logs at steps 226-376 (and
# over its last four logs when the whole run is made), and a tenth of the
# run's own step-1 value.
TPU_RUN = ROOT / "runs" / "titok-synthetic" / "8px_64px_S_32_1024.jsonl"
CONVERGE_WINDOW = (226, 376)
CONVERGE_FACTOR = 2.0
CONVERGE_DROP = 0.1
# the steps of the curve printed beside the TPU run's
CURVE_STEPS = (1, 26, 101, 501, 1001, 2001)
# Queue C #1 with trained weights: images of a seed the run never drew
HELD_OUT_SEED, HELD_OUT_IMAGES = 123457, 128
# epochs of the S-scale run in a whole smoke run (4: its first 400 steps,
# logs up to step 376; cut from 6 to keep the run in its time)
SMOKE_CONVERGE_EPOCHS = 4


def entry_lines(proc: subprocess.Popen, stop: str, lines: list,
                timeout: float = 600) -> bool:
    """Read ``proc``'s output into ``lines`` until a line starts with
    ``stop``; False if the output ends or the time runs out first."""
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        line = proc.stdout.readline()
        if not line:
            return False
        lines.append(line.rstrip("\n"))
        if line.startswith(stop):
            return True
    return False


def entry_steps(lines: list) -> "list[tuple[int, float, float]]":
    """(i, loss, step_time) of each step line of the train_titok entry."""
    out = []
    for line in lines:
        m = re.match(r"e=\d+ i=(\d+) loss=(\S+) recon=\S+ quant=\S+ "
                     r"usage=\S+ step_time=(\S+)", line)
        if m:
            out.append((int(m.group(1)), float(m.group(2)),
                        float(m.group(3))))
    return out


def run_titok_entry(*flags: str, stop: str) -> dict:
    """``python -m vit_tpu_torch.train_titok`` with ``flags`` as a
    subprocess, sent SIGTERM once a line starts with ``stop``."""
    cmd = [sys.executable, "-m", "vit_tpu_torch.train_titok", *flags]
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines: list = []
    try:
        reached = entry_lines(proc, stop, lines)
        require(reached, f"train_titok never printed {stop!r}: {lines[-30:]}")
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    lines += out.splitlines()
    require(proc.returncode == 0,
            f"train_titok exited {proc.returncode}: {lines[-30:]}")
    return entry_run(" ".join(cmd[1:]), time.perf_counter() - t0, lines)


def run_titok_main(*flags: str) -> dict:
    """``vit_tpu_torch.train_titok.main(flags)`` in this process, its output
    captured, the kernels' launch counts set to 0 just before it and read
    just after (its SIGTERM handler is removed again afterwards)."""
    from vit_tpu_torch.train_titok import main as titok_main

    buf = io.StringIO()
    prev = signal.getsignal(signal.SIGTERM)
    t0 = time.perf_counter()
    reset_launches()
    try:
        with contextlib.redirect_stdout(buf):
            titok_main(list(flags))
        torch.cuda.synchronize()
    finally:
        signal.signal(signal.SIGTERM, prev)
    run = entry_run("-m vit_tpu_torch.train_titok " + " ".join(flags),
                    time.perf_counter() - t0, buf.getvalue().splitlines())
    run["launches"] = read_launches()
    run["fp32_launches"] = read_fp32_launches()
    torch.cuda.empty_cache()
    return run


def entry_run(cmd: str, seconds: float, lines: list) -> dict:
    run = dict(cmd=cmd, seconds=seconds, lines=lines,
               steps=entry_steps(lines))
    require(run["steps"] and all(np.isfinite(l) for _, l, _ in run["steps"]),
            f"train_titok's step lines: {lines[-30:]}")
    return run


def require_launched(run: dict, names, key: str = "launches") -> None:
    missing = [n for n in names if run[key][n] == 0]
    require(not missing, f"{run['cmd']}: kernels never launched: {missing}")


def entry_summary(run: dict) -> dict:
    """What a phase line keeps of a run: the command, seconds, the steps'
    losses and times, the last lines, the launches."""
    return dict(cmd=run["cmd"], seconds=run["seconds"],
                step_losses=[l for _, l, _ in run["steps"]],
                step_times=[t for _, _, t in run["steps"]],
                tail=run["lines"][-6:],
                **{k: {n: v for n, v in run[k].items() if v}
                   for k in ("launches", "fp32_launches") if k in run})


def state_round_trip(state: TrainState, other: TrainState, config,
                     directory: Path) -> dict:
    """``state`` saved as "best" and "last" under ``directory`` and "last"
    restored into ``other`` (a state of other weights): every tensor equal,
    the seconds of each save and of the restore, the bytes of a tag."""
    ckpt = Checkpointer(str(directory))
    seconds = {}
    for tag in ("best", "last"):
        t0 = time.perf_counter()
        ckpt.save(state, config=config, tag=tag)
        seconds[tag] = time.perf_counter() - t0
    nbytes = (directory / "last" / "state.pt").stat().st_size
    t0 = time.perf_counter()
    Checkpointer(str(directory)).restore(other)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    want, got = state.state_dict(), other.state_dict()
    equal = (torch.equal(want["step"], got["step"])
             and torch.equal(want["opt_state"]["count"],
                             got["opt_state"]["count"])
             and all(torch.equal(want["params"][k], got["params"][k])
                     for k in want["params"])
             and all(torch.equal(want["opt_state"][g][k],
                                 got["opt_state"][g][k])
                     for g in ("mu", "nu") for k in want["opt_state"][g]))
    out = dict(save_seconds=seconds, restore_seconds=restore_s,
               bytes_per_tag=nbytes, equal=equal,
               mu_dtype=str(other.opt_state.mu[0].dtype))
    require(equal, f"checkpoint round trip differs: {out}")
    return out


def checkpoint_round_trip(work: Path) -> dict:
    """A TiTok-B train state on the card (fp32 parameters, bf16 μ, fp32 ν,
    after one step) saved as "best" and "last" and restored into a state of
    other weights: every tensor equal; the seconds of each save."""
    model = TiTok(TiTokConfig(**FLAGSHIP))
    init_params_(model, torch.Generator().manual_seed(0))
    model = model.cuda().train()
    state = TrainState.create(model, flagship_optimizer())
    gen = torch.Generator(device="cuda").manual_seed(4)
    images = torch.rand(8, 128, 128, 3, device="cuda", generator=gen)
    usage = torch.zeros(model.config.codebook_size, device="cuda")
    make_tokenizer_train_step(model)(state, images, usage)
    torch.cuda.synchronize()
    other = TiTok(TiTokConfig(**FLAGSHIP))
    init_params_(other, torch.Generator().manual_seed(1))
    other_state = TrainState.create(other.cuda().train(),
                                    flagship_optimizer())
    out = state_round_trip(state, other_state, model.config,
                           work / "titok_b_ckpt")
    del model, other, state, other_state
    torch.cuda.empty_cache()
    return out


def phase_train_titok_entry(card: str, work: Path) -> "tuple[dict, dict]":
    """``python -m vit_tpu_torch.train_titok`` at the flagship defaults
    (TiTok-B, image 128, patch 16, 256 tokens, codebook 2048 × 12) with bs
    64 and the random ConvNeXt-S perceptual loss: run A, a subprocess sent
    SIGTERM after step ``PREEMPT_AFTER``, must exit 0 with PREEMPTED and a
    "last" at that step or later; run B resumes from it for ``SHORT_STEPS``
    steps; then ``SHORT_STEPS`` steps under ``--mixed false`` and under
    ``--perceptual_quant int8``; runs B and after call the entry's ``main``
    in this process, each with its launches counted (K1-K5; their fp32
    forms; K12a/K12b); then a TiTok-B checkpoint round trip. Returns the
    launches and the fp32 launches of those runs."""
    torch.cuda.empty_cache()

    def dirs(name):
        return ("--ckpt_dir", str(work / name / "ckpt"),
                "--run_dir", str(work / name / "runs"))

    a = run_titok_entry(*TITOK_ENTRY, *dirs("bf16"), "--steps_per_epoch",
                        "100000", stop=f"e=0 i={PREEMPT_AFTER}")
    meta = json.loads((work / "bf16" / "ckpt" / "last_meta.json").read_text())
    require(any(line.startswith("PREEMPTED: saving 'last' at step")
                for line in a["lines"]), f"no PREEMPTED line: {a['lines']}")
    require(meta["step"] >= PREEMPT_AFTER, f"last_meta.json: {meta}")
    b = run_titok_main(*TITOK_ENTRY, *dirs("bf16"), "--resume", "--epochs",
                       "1", "--steps_per_epoch", "100000",
                       "--max_epoch_steps", str(meta["step"] + SHORT_STEPS))
    resumed = [int(line.split()[-1]) for line in b["lines"]
               if line.startswith("RESUMED at step")]
    require(resumed and resumed[0] >= meta["step"],
            f"run B did not resume at step {meta['step']}: {b['lines']}")
    require(f"RESUMED data stream at epoch 0, batch {meta['step']}"
            in b["lines"], f"run B's stream position: {b['lines']}")
    require(len(b["steps"]) == SHORT_STEPS, f"run B's steps: {b['lines']}")
    tokenizer = ("attention_packed_fwd", "attention_packed_bwd", "vq_nearest")
    require_launched(b, tokenizer + ("convnext_tail_fwd", "convnext_tail_bwd"))
    short = {}
    runs = [b]
    # --mixed false with --latent_dim 6 (the step's K5 launches take its
    # runtime-D form), and --perceptual_quant int8 with --watch (the
    # histogram step on log steps; each histogram counts its tensor's
    # elements): two features a run
    from vit_tpu_torch.bridge import _flax_key
    from vit_tpu_torch.utils.logging import MetricsLogger

    logged: list = []
    log_histograms = MetricsLogger.log_histograms

    def keep(self, hists, step=None):
        logged.append(hists)
        return log_histograms(self, hists, step)

    MetricsLogger.log_histograms = keep
    try:
        for name, flags, kernels, key in (
                ("fp32", ("--mixed", "false", "--latent_dim", "6"), tokenizer
                 + ("convnext_tail_fwd", "convnext_tail_bwd"),
                 "fp32_launches"),
                ("int8", ("--perceptual_quant", "int8", "--watch"), tokenizer
                 + ("convnext_tail_fwd_q8", "convnext_tail_bwd_q8"),
                 "launches")):
            run = run_titok_main(*TITOK_ENTRY, *dirs(name), *flags,
                                 "--epochs", "1", "--steps_per_epoch",
                                 str(SHORT_STEPS))
            require(len(run["steps"]) == SHORT_STEPS,
                    f"{name} run's steps: {run['lines']}")
            require_launched(run, kernels, key)
            short[name] = entry_summary(run)
            runs.append(run)
    finally:
        MetricsLogger.log_histograms = log_histograms
    measured["k5_any_dim_launches"] = runs[1]["launches"]["vq_nearest"]
    sizes = {_flax_key(n, t.ndim)[0]: t.numel() for n, t in load_params(
        str(work / "int8" / "ckpt"), "last").items()}
    require(len(logged) == SHORT_STEPS and all(
        sorted(h) == sorted([f"{p}/{k}" for p in ("grad_hist", "param_hist")
                             for k in sizes])
        and all(counts.sum() == sizes[k.split("/", 1)[1]]
                for k, (counts, _) in h.items()) for h in logged),
        f"--watch histograms: {len(logged)} log steps")
    short["int8"].update(histograms=len(logged[0]),
                         plain_step_times=[t for _, _, t in b["steps"]])
    short_epoch = ("--epochs", "1", "--steps_per_epoch", str(SHORT_STEPS))

    # --quantizer fsq with --ema_decay 0.999 (warmup 1, so the parameters
    # move): the same step without K5, the bitmap of the CLI's
    # codebook_size taking what FSQ's wrapped indices reach of it; the
    # "last" average apart from the parameters, and one --resume step that
    # continues it (e·d + p·(1 − d) of the saved average, closer than the
    # same update of an average re-seeded from the saved parameters)
    ema_flags = (*TITOK_ENTRY, *dirs("ema"), "--quantizer", "fsq",
                 "--ema_decay", "0.999", "--warmup_steps", "1")
    run = run_titok_main(*ema_flags, *short_epoch)
    usage = [float(m.group(1)) for m in (re.search(r"usage=(\S+)", line)
                                         for line in run["lines"]) if m]
    require(len(run["steps"]) == SHORT_STEPS and run["launches"][
        "vq_nearest"] == 0 and len(usage) == SHORT_STEPS
        and all(np.isfinite(usage)), f"fsq run: {run['lines']}")
    require_launched(run, tokenizer[:2] + ("convnext_tail_fwd",
                                           "convnext_tail_bwd"))
    short["fsq"] = dict(usage=usage)
    runs.append(run)
    saved = load_params(str(work / "ema" / "ckpt"), "last", ema=True)
    params = load_params(str(work / "ema" / "ckpt"), "last")
    apart = max(((saved[n] - params[n]).abs().max()
                 / params[n].abs().max()).item() for n in params)
    resumed_ema = run_titok_main(*ema_flags, "--resume", "--epochs", "2",
                                 "--steps_per_epoch", str(SHORT_STEPS),
                                 "--max_epoch_steps", "1")
    runs.append(resumed_ema)
    after = load_params(str(work / "ema" / "ckpt"), "last", ema=True)
    stepped = load_params(str(work / "ema" / "ckpt"), "last")

    def off(start):
        return max(((after[n] - (start[n] * 0.999 + stepped[n] * (1 - 0.999)))
                    .abs().max() / saved[n].abs().max()).item() for n in saved)

    continued, reseeded = off(saved), off(params)
    short["ema"] = dict(entry_summary(run), resumed=entry_summary(resumed_ema),
                        ema_apart_max_rel=apart,
                        resumed_vs_saved_update_max_rel=continued,
                        resumed_vs_reseeded_update_max_rel=reseeded,
                        tolerance=dict(continued=FP32_REL))
    require(apart > 0 and f"RESUMED at step {SHORT_STEPS}"
            in resumed_ema["lines"] and continued <= FP32_REL
            and continued < reseeded, f"ema runs: {short['ema']}")
    del saved, params, after, stepped

    ckpt = checkpoint_round_trip(work)
    emit("train_titok_entry", card=card, preempted=entry_summary(a),
         last_meta=meta, resumed_at=resumed[0], resumed=entry_summary(b),
         **short, checkpoint=ckpt)
    return ({n: sum(r["launches"][n] for r in runs) for n in b["launches"]},
            {n: sum(r["fp32_launches"][n] for r in runs)
             for n in b["fp32_launches"]})


def converge_argv(config: dict, work: Path, epochs: int) -> "list[str]":
    """The train_titok flags of a logged ``_config`` (the committed TPU
    run's), with this run's checkpoint and log directories and ``epochs``."""
    switches = {"resume", "no_wandb", "watch"}
    argv = []
    for key, value in config.items():
        if key in ("min_lr", "ckpt_dir", "run_dir", "epochs") or value is None:
            continue
        if key in switches:
            argv += [f"--{key}"] if value else []
        elif isinstance(value, bool):
            argv += [f"--{key}", str(value).lower()]
        else:
            argv += [f"--{key}", str(value)]
    return argv + ["--epochs", str(epochs), "--ckpt_dir",
                   str(work / "converge" / "ckpt"), "--run_dir",
                   str(work / "converge" / "runs")]


def recon_curve(path: Path) -> "dict[int, float]":
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    return {r["_step"]: r["train/recon_loss"] for r in rows
            if "train/recon_loss" in r}


def held_out_codes(ckpt_dir: Path, config: dict) -> dict:
    """Queue C #1 with trained weights: the run's "best" weights on the
    card encode ``HELD_OUT_IMAGES`` shapes images of a seed the run never
    drew, through the kernels and through their plain versions; the codes'
    agreement, every differing code checked for a near-tie of the latent
    difference, and the PSNR of the kernels' reconstructions."""
    cfg = TiTokConfig(config["image_size"], config["patch_size"],
                      config["latent_tokens"], config["codebook_size"],
                      config["latent_dim"], config["transformer"])
    model = TiTok(cfg, device="meta")
    model.load_state_dict(load_params(str(ckpt_dir), "best"), assign=True)
    model = model.cuda().eval().requires_grad_(False)
    images, _ = next(iter(SyntheticImageLoader(
        cfg.image_size, HELD_OUT_IMAGES, seed=HELD_OUT_SEED, mode="shapes")))
    x = torch.from_numpy(images).cuda()
    with torch.no_grad():
        reset_launches()
        lat_k = model.enc(x)
        ik = model.quant(lat_k)[1]
        recon = model.dec(model.quant.lookup(ik)).float()
        launches = read_launches()
        with plain_versions():
            lat_p = model.enc(x)
            ip = model.quant(lat_p)[1]
            recon_p = model.dec(model.quant.lookup(ip)).float()
    flips = code_flips(lat_k, lat_p, model.quant.codebook, ik, ip)
    out = dict(seed=HELD_OUT_SEED, images=HELD_OUT_IMAGES,
               best_meta=json.loads((ckpt_dir / "best_meta.json").read_text()),
               launches={k: v for k, v in launches.items() if v},
               psnr_db=psnr(recon.clamp(0, 1), x).mean().item(),
               psnr_plain_db=psnr(recon_p.clamp(0, 1), x).mean().item(),
               **flips)
    require(flips["unexplained_disagreements"] == 0,
            f"trained TiTok-S codes differ beyond near-ties: {out}")
    return out


def phase_train_titok_converge(card: str, work: Path,
                               epochs: "int | None" = None) -> dict:
    """The committed S-scale TPU run (``TPU_RUN``: TiTok-S, image 64, patch
    8, 32 tokens, codebook 1024, bs 64, lr 3e-4, warmup 100, seed 3, the
    shapes stream, 100 steps an epoch) through ``python -m
    vit_tpu_torch.train_titok`` with its ``_config``, for ``epochs`` of its
    25 epochs (all by default): the median recon loss over the logs in
    ``CONVERGE_WINDOW`` within ``CONVERGE_FACTOR`` × the TPU run's and
    below ``CONVERGE_DROP`` × the run's step-1 value; over a whole run the
    median of the last four logs too. Then the run's "best" weights encode
    held-out images (``held_out_codes``)."""
    rows = TPU_RUN.read_text().splitlines()
    config = json.loads(rows[0])["_config"]
    epochs = epochs or config["epochs"]
    torch.cuda.empty_cache()
    run = run_titok_main(*converge_argv(config, work, epochs))
    require_launched(run, ("attention_packed_fwd", "attention_packed_bwd",
                           "vq_nearest"))
    got = recon_curve(work / "converge" / "runs" / "titok-synthetic"
                      / TPU_RUN.name)
    tpu = recon_curve(TPU_RUN)
    lo, hi = CONVERGE_WINDOW

    def window(curve):
        return float(np.median([v for s, v in curve.items() if lo <= s <= hi]))

    def last4(curve):
        return float(np.median([curve[s] for s in sorted(curve)[-4:]]))

    whole = epochs == config["epochs"]
    shown = [s for s in CURVE_STEPS if s in got] + (
        sorted(got)[-4:] if whole else [])
    out = dict(card=card, epochs=epochs, steps=max(got),
               seconds=run["seconds"],
               step_time_median=float(np.median(
                   [t for _, _, t in run["steps"][2:]])),
               curve={s: dict(cuda=got[s], tpu=tpu.get(s)) for s in shown},
               window_median=dict(cuda=window(got), tpu=window(tpu)),
               last4_median=(dict(cuda=last4(got), tpu=last4(tpu))
                             if whole else None),
               launches={n: v for n, v in run["launches"].items() if v})
    out["held_out"] = held_out_codes(work / "converge" / "ckpt", config)
    emit("train_titok_converge", **out)
    require(out["window_median"]["cuda"]
            <= CONVERGE_FACTOR * out["window_median"]["tpu"],
            f"S-scale run's recon loss over steps {lo}-{hi}: {out}")
    require(out["window_median"]["cuda"] < CONVERGE_DROP * got[1],
            f"S-scale run's recon loss did not fall tenfold: {out}")
    if whole:
        require(out["last4_median"]["cuda"]
                <= CONVERGE_FACTOR * out["last4_median"]["tpu"],
                f"S-scale run's last four logs: {out}")
    return run["launches"]


# The train_videogpt entry: its flags in every run; run A of arm (a) is sent
# SIGTERM during step GPT_PREEMPT_AT (counted from 1) of an epoch of
# GPT_EPOCH steps, which the resumed run B finishes.
GPT_ENTRY = ("--dataset", "synthetic", "--no_wandb", "--log_every", "1")
GPT_PREEMPT_AT, GPT_EPOCH = 4, 8


def gpt_entry_steps(lines: list) -> "list[tuple[int, float, float]]":
    """(s, loss, step_time) of each step line of the train_videogpt entry."""
    out = []
    for line in lines:
        m = re.match(r"e=\d+ s=(\d+) loss=(\S+) step_time=(\S+)", line)
        if m:
            out.append((int(m.group(1)), float(m.group(2)),
                        float(m.group(3))))
    return out


@contextlib.contextmanager
def videogpt_entry_hooks(kill_at: "int | None" = None,
                         first: "dict | None" = None,
                         generated: "list | None" = None):
    """Watch the entry's run from inside: SIGTERM to this process during
    train step ``kill_at`` (counted from 1); ``first`` gets the model, the
    tokenizer, the first step's clip and a copy of the weights it starts
    from; ``generated`` each generation eval's conditioning codes, output,
    seconds and a copy of the weights it ran with. The copies are device
    copies, no kernel launches."""
    import vit_tpu_torch.train_videogpt as tv

    factory, gen_fn = tv.make_videogpt_train_step, tv.generate_frames

    def weights(model):
        return {n: p.detach().clone() for n, p in model.named_parameters()}

    def make(model):
        step = factory(model)
        calls = [0]

        def hooked(state, tokenizer, videos, generator=None):
            if first is not None and calls[0] == 0:
                first.update(model=model, tokenizer=tokenizer,
                             videos=videos.clone(), weights=weights(model))
            calls[0] += 1
            if calls[0] == kill_at:
                os.kill(os.getpid(), signal.SIGTERM)
            return step(state, tokenizer, videos, generator)

        return hooked

    def gen(model, cond, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = gen_fn(model, cond, n)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        generated.append(dict(model=model, cond=cond.clone(), n=n,
                              out=out.clone(), weights=weights(model),
                              seconds=seconds))
        return out

    tv.make_videogpt_train_step = make
    if generated is not None:
        tv.generate_frames = gen
    try:
        yield
    finally:
        tv.make_videogpt_train_step, tv.generate_frames = factory, gen_fn


def run_videogpt_main(*flags: str, **hooks) -> dict:
    """``vit_tpu_torch.train_videogpt.main(flags)`` in this process, its
    output captured, the kernels' launch counts set to 0 just before it and
    read just after; ``hooks`` as ``videogpt_entry_hooks`` takes them."""
    from vit_tpu_torch.train_videogpt import main as gpt_main

    buf = io.StringIO()
    prev = signal.getsignal(signal.SIGTERM)
    t0 = time.perf_counter()
    reset_launches()
    try:
        with contextlib.redirect_stdout(buf), videogpt_entry_hooks(**hooks):
            state = gpt_main(list(flags))
        torch.cuda.synchronize()
    finally:
        signal.signal(signal.SIGTERM, prev)
    launches = read_launches()
    lines = buf.getvalue().splitlines()
    run = dict(cmd="-m vit_tpu_torch.train_videogpt " + " ".join(flags),
               seconds=time.perf_counter() - t0, lines=lines,
               steps=gpt_entry_steps(lines), launches=launches, state=state)
    require(run["steps"] and all(np.isfinite(l) for _, l, _ in run["steps"]),
            f"train_videogpt's step lines: {lines[-30:]}")
    return run


def logged_losses(run_dir: Path) -> "dict[int, float]":
    """The entry's logged train/loss by optimizer step (full precision)."""
    (path,) = (run_dir / "videogpt-synthetic").glob("*.jsonl")
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    return {r["_step"]: r["train/loss"] for r in rows if "train/loss" in r}


def gpt_first_step(first: dict, logged_loss: float) -> dict:
    """The run's first step again on its clip and the weights it started
    from: the frozen tokenizer's codes through the kernels and the plain
    versions (every flip a near-tie), and the prior's forward and backward
    on the kernels' codes through both: the loss (also against the logged
    one), the logits and the gradients' global norm."""
    model, tok = first["model"], first["tokenizer"]
    live = {n: p.detach().clone() for n, p in model.named_parameters()}
    model.load_state_dict(first["weights"], strict=False)
    frames = first["videos"].reshape(-1, *first["videos"].shape[2:])
    tm = tok.model
    params = list(model.parameters())

    def prior_step(codes):
        logits, loss = model(codes)
        grads = torch.autograd.grad(loss, params)
        norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
        return logits.detach(), loss.item(), norm.item()

    with torch.no_grad():
        lat_k = tm.enc(frames).double()
        ik = tm.quant(lat_k.float())[1]
        with plain_versions():
            lat_p = tm.enc(frames).double()
            ip = tm.quant(lat_p.float())[1]
    codes = ik.reshape(*first["videos"].shape[:2], -1)
    logits_k, loss_k, norm_k = prior_step(codes)
    with plain_versions():
        logits_p, loss_p, norm_p = prior_step(codes)
    torch.cuda.synchronize()
    model.load_state_dict(live, strict=False)
    flips = code_flips(lat_k, lat_p, tm.quant.codebook, ik, ip)
    require_codes_agree(flips, "the entry's tokenizer codes")
    logits = rel_errors(logits_k, logits_p)
    del logits_k, logits_p
    out = dict(logged_loss=logged_loss, loss=loss_k, plain_loss=loss_p,
               grad_norm=norm_k, plain_grad_norm=norm_p, logits=logits,
               rel_diff=dict(loss=abs(loss_k - loss_p) / abs(loss_p),
                             grad_norm=abs(norm_k - norm_p) / abs(norm_p)),
               tolerance=dict(loss_rel=STEP_LOSS_REL,
                              grad_norm_rel=STEP_GRAD_NORM_REL,
                              logits_max_rel=PREFILL_MAX_REL), **flips)
    require(abs(loss_k - logged_loss) <= 1e-6 * abs(logged_loss),
            f"the first step's loss again differs from the logged one: {out}")
    require(out["rel_diff"]["loss"] <= STEP_LOSS_REL
            and out["rel_diff"]["grad_norm"] <= STEP_GRAD_NORM_REL
            and logits["max_rel"] <= PREFILL_MAX_REL,
            f"the entry's first step, kernels vs plain versions: {out}")
    return out


def prior_round_trip(state: TrainState, config, directory: Path) -> dict:
    """``state_round_trip`` of an entry's final VideoGPT state into a state
    of other weights (seed 1) under train_videogpt.py's optimizer."""
    other_model = VideoGPT(config)
    init_params_(other_model, torch.Generator().manual_seed(1))
    other = TrainState.create(other_model.cuda().train(), make_optimizer(
        1e-4, 5000, 500000, 1e-5, 1e-4, clip_norm=None))
    out = state_round_trip(state, other, config, directory)
    del state, other, other_model
    torch.cuda.empty_cache()
    return out


def phase_train_videogpt_entry(card: str, work: Path,
                               tokenizer_ckpt: Path) -> dict:
    """``python -m vit_tpu_torch.train_videogpt`` through its ``main``:
    arm (a) at the reference defaults over the random tokenizer, SIGTERM'd
    and resumed; arm (b) over ``tokenizer_ckpt`` (a "best" written by the
    train_titok entry) with its step-0 generation eval. Each arm's first
    step is run again through the kernels and the plain versions, and its
    final state saved and restored. Returns the runs' launches, summed."""
    torch.cuda.empty_cache()

    def dirs(name):
        return ("--ckpt_dir", str(work / name / "ckpt"),
                "--run_dir", str(work / name / "runs"))

    def rollout(gen):
        """The generation eval's rate: the codes it generated a second."""
        tokens = gen["out"].shape[0] * gen["n"] * gen["model"].config.frame_size
        return dict(seconds=gen["seconds"], generated_codes=tokens,
                    codes_per_s=tokens / gen["seconds"])

    epoch = ("--epochs", "1", "--steps_per_epoch", str(GPT_EPOCH))
    generated: list = []
    a = run_videogpt_main(*GPT_ENTRY, "--tokenizer_ckpt", "random", *epoch,
                          *dirs("gpt_a"), kill_at=GPT_PREEMPT_AT,
                          generated=generated)
    require(len(generated) == 1, f"run A's generation evals: {a['lines']}")
    a_gen = rollout(generated.pop())
    meta = json.loads((work / "gpt_a" / "ckpt" / "last_meta.json")
                      .read_text())
    stream = json.loads((work / "gpt_a" / "ckpt" / "data_state.json")
                        .read_text())[str(meta["step"])]
    require(any(line.startswith("PREEMPTED: saving 'last' at step")
                for line in a["lines"]), f"no PREEMPTED line: {a['lines']}")
    require(meta["step"] == GPT_PREEMPT_AT
            and stream == {"epoch": 0, "next_batch": GPT_PREEMPT_AT,
                           "consumed": GPT_PREEMPT_AT},
            f"run A's last: {meta}, stream {stream}")
    del a["state"]
    torch.cuda.empty_cache()
    first: dict = {}
    b = run_videogpt_main(*GPT_ENTRY, "--tokenizer_ckpt", "random", *epoch,
                          *dirs("gpt_a"), "--resume", first=first)
    require(f"RESUMED at step {meta['step']}" in b["lines"]
            and f"RESUMED data stream at epoch 0, batch {meta['step']}"
            in b["lines"], f"run B's resume: {b['lines'][:8]}")
    require([s for s, _, _ in b["steps"]]
            == list(range(GPT_PREEMPT_AT, GPT_EPOCH)),
            f"run B's steps (the crop count runs on from "
            f"{GPT_PREEMPT_AT}): {b['lines']}")
    for run in (a, b):
        require_launched(run, ("attention_fwd", "attention_bwd",
                               "attention_packed_fwd", "vq_nearest"))
    check = gpt_first_step(first, logged_losses(work / "gpt_a" / "runs")[
        meta["step"] + 1])
    ckpt = prior_round_trip(b.pop("state"), first["model"].config,
                            work / "gpt_ckpt")
    del first
    torch.cuda.empty_cache()

    first = {}
    c = run_videogpt_main(*GPT_ENTRY, "--tokenizer_ckpt", str(tokenizer_ckpt),
                          "--epochs", "1", "--steps_per_epoch",
                          str(SHORT_STEPS), *dirs("gpt_b"),
                          generated=generated, first=first)
    require(len(c["steps"]) == SHORT_STEPS and len(generated) == 1,
            f"arm (b): {c['lines']}")
    require_launched(c, ("attention_packed_fwd", "vq_nearest"))
    c_check = gpt_first_step(first, logged_losses(work / "gpt_b" / "runs")[1])
    gen = generated[0]
    c_gen = rollout(gen)
    model = gen["model"]
    cfg = model.config
    live = {n: p.detach().clone() for n, p in model.named_parameters()}
    model.load_state_dict(gen["weights"], strict=False)
    direct = generate_frames(model, gen["cond"], gen["n"])
    model.load_state_dict(live, strict=False)
    out = gen["out"]
    require(tuple(out.shape) == (2, cfg.max_tokens)
            and 0 <= out.min().item() and out.max().item() < cfg.codebook_size
            and torch.equal(out[:, :gen["cond"][0].numel()],
                            gen["cond"].reshape(2, -1)),
            f"the generation eval's codes: {tuple(out.shape)}")
    require(torch.equal(out, direct),
            "the entry's generation eval differs from a direct "
            "generate_frames call")
    del generated, gen, model, live, direct
    c_ckpt = prior_round_trip(c.pop("state"), cfg, work / "gpt_b_ckpt")
    del first
    torch.cuda.empty_cache()

    def summary(run):
        return dict(cmd=run["cmd"], seconds=run["seconds"],
                    step_losses=[l for _, l, _ in run["steps"]],
                    step_times=[t for _, _, t in run["steps"]],
                    tail=run["lines"][-4:],
                    launches={k: v for k, v in run["launches"].items() if v})

    emit("train_videogpt_entry", card=card,
         a=dict(preempted=summary(a), generation_eval=a_gen, last_meta=meta,
                stream=stream, resumed=summary(b), first_step=check,
                checkpoint=ckpt),
         b=dict(tokenizer=str(tokenizer_ckpt), run=summary(c),
                prior_tokens=cfg.max_tokens, first_step=c_check,
                checkpoint=c_ckpt, generation_eval=c_gen,
                direct_equal=True))
    return {n: a["launches"][n] + b["launches"][n] + c["launches"][n]
            for n in a["launches"]}


def phase_videogpt_rollout(work: Path, model: VideoGPT, tokens: torch.Tensor,
                           card: str) -> dict:
    """The greedy rollout served over HTTP at bs 8 (bs 1 is phase 20's):
    8 frames of codes in, 2 generated. Returns the launches of the served
    rollout."""
    frame = VIDEOGPT["frame_size"]
    n_cond, n_gen = ROLLOUT_COND * frame, ROLLOUT_GEN * frame
    cond_all = tokens[:8, :ROLLOUT_COND].reshape(8, n_cond)
    cond_np = cond_all.cpu().numpy()
    launches, results = {}, {}
    for bs in (8,):
        d = work / f"videogpt_bs{bs}"
        export_videogpt(model, str(d), cond_frames=ROLLOUT_COND,
                        gen_frames=ROLLOUT_GEN, bs=bs)
        cond = cond_np[:bs]
        with serving(str(d), batch_window_ms=0) as url:
            reset_launches()   # the main path's run starts here
            # the served rollout is the timed one: the server warms up at
            # load (a rollout takes seconds, host-bound; a second timed
            # one did not fit the run)
            t0 = time.perf_counter()
            served = post(url + "/generate", cond)
            latency = (time.perf_counter() - t0) * 1e3
            launches[bs] = read_launches()
        require(served.shape == (bs, n_cond + n_gen)
                and served.dtype == np.int32,
                f"generate gave {served.shape} {served.dtype}")
        require(np.array_equal(served[:, :n_cond], cond),
                "the conditioning prefix did not come back unchanged")
        require(served.min() >= 0
                and served.max() < VIDEOGPT["codebook_size"],
                "a generated code lies outside the codebook")
        require(launches[bs]["attention_fwd"] == model.config.trans_config
                .n_layers and launches[bs]["attention_bwd"] == 0,
                f"one rollout launched {launches[bs]}")
        direct = generate(model, torch.from_numpy(cond), n_gen).cpu().numpy()
        require(np.array_equal(served, direct),
                "the served rollout differs from a direct generate call")
        results[bs] = dict(latency_ms=latency,
                           generated_tokens_per_s=bs * n_gen / latency * 1e3,
                           launches=launches[bs])
        torch.cuda.empty_cache()

    # The prefill (SOS + 512 codes) with the kernels and through the plain
    # versions: last-position logits, and the first generated code equal or
    # a near-tie of the measured logit difference.
    sos = torch.full((8, 1), VIDEOGPT["codebook_size"], dtype=torch.int32,
                     device="cuda")
    prefix = torch.cat([sos, cond_all], 1)
    with torch.inference_mode():
        logits = model.prefill(prefix, init_cache(model, 8))[0]
        with plain_versions():
            plain = model.prefill(prefix, init_cache(model, 8))[0]
    # The device's share of a rollout: a profile of one bs-8 rollout of one
    # frame (the prefill and 63 decode steps).
    cond8 = torch.from_numpy(cond_np)
    results[8]["profile_one_frame"] = profile_window(
        lambda: generate(model, cond8, frame))
    err = rel_errors(logits, plain)
    first, plain_first = logits.argmax(-1), plain.argmax(-1)
    rows = torch.arange(8, device="cuda")
    gap = (plain[rows, plain_first] - plain[rows, first]).max().item()
    emit("videogpt_rollout", card=card, cond_codes=n_cond, gen_codes=n_gen,
         bs8=results[8], prefill_logits=err,
         first_code_equal=int((first == plain_first).sum()),
         first_code_max_gap=gap,
         tolerance=dict(prefill_max_rel=PREFILL_MAX_REL))
    require(err["max_rel"] <= PREFILL_MAX_REL,
            f"prefill logits vs plain versions: {err}")
    require(gap <= 2 * err["max_abs"],
            f"a first generated code differs beyond a near-tie: gap {gap}")
    return launches[8]


def phase_train_int8(model: TiTok, weights: dict, perceptual, images,
                     card: str) -> dict:
    """The flagship step with the int8 perceptual loss, as ``bench.py
    --perceptual_quant int8`` builds it, on the same weights and batch as
    ``phase_train``: launches, the first step against the plain versions,
    the int8 perceptual loss against the bf16 one, learning, and step time
    in turns with the bf16 step. Returns the launches."""
    net = ConvNeXt(dtype=torch.bfloat16, quant="int8")
    net.load_state_dict(perceptual.net.state_dict())
    q8 = PerceptualLoss(net).cuda()
    model = model.cuda().train()
    steps = {"int8": make_tokenizer_train_step(model, perceptual_loss_fn=q8),
             "bf16": make_tokenizer_train_step(model,
                                               perceptual_loss_fn=perceptual)}
    usage = torch.zeros(model.config.codebook_size, device="cuda")

    def first_step(arm: str, ctx=contextlib.nullcontext):
        model.load_state_dict(weights)
        state = TrainState.create(model, flagship_optimizer())
        with ctx():
            torch.cuda.synchronize()
            reset_launches()   # the main path's run starts here
            _, _, metrics, recon = steps[arm](state, images,
                                              torch.zeros_like(usage))
            torch.cuda.synchronize()
            launches = read_launches()
        metrics = {k: v.item() for k, v in metrics.items()}
        require(recon.shape == images.shape
                and bool(torch.isfinite(recon).all())
                and all(np.isfinite(v) for v in metrics.values()),
                f"{arm} step: {metrics}")
        return launches, metrics

    with held_launches() as worst:
        launches, q = first_step("int8")
    held = require_held(worst, "the first int8 step")
    require(launches == INT8_STEP_LAUNCHES,
            f"one int8 step launched {launches}, expected {INT8_STEP_LAUNCHES}")
    _, plain = first_step("int8", plain_versions)
    _, bf = first_step("bf16")
    rel = {k: abs(q[k] - plain[k]) / abs(plain[k])
           for k in ("train/loss", "train/perceptual_loss", "train/grad_norm")}
    gap = (abs(q["train/perceptual_loss"] - bf["train/perceptual_loss"])
           / abs(bf["train/perceptual_loss"]))
    emit("train_int8", what="first int8 step vs plain versions, and its "
         "perceptual loss vs the bf16 one", launches=launches, metrics=q,
         plain_metrics=plain, bf16_metrics=bf, rel_diff_plain=rel,
         perceptual_gap_vs_bf16=gap, held_launches=held,
         tolerance=dict(loss_rel=STEP_LOSS_REL,
                        grad_norm_rel=STEP_GRAD_NORM_REL, gap=INT8_LOSS_GAP))
    require(rel["train/loss"] <= STEP_LOSS_REL
            and rel["train/perceptual_loss"] <= STEP_LOSS_REL
            and rel["train/grad_norm"] <= STEP_GRAD_NORM_REL,
            f"int8 step vs plain versions: {rel}")
    require(gap <= INT8_LOSS_GAP, f"int8 vs bf16 perceptual loss: {gap}")

    # Learning: 20 int8 steps on the same batch with a 2-step warmup.
    model.load_state_dict(weights)
    quick = TrainState.create(model, make_optimizer(1e-4, 2, 1_000_000, 1e-5,
                                                    1e-4, clip_norm=1.0))
    recon_losses = torch.stack([steps["int8"](quick, images, usage)[2]
                                ["train/recon_loss"]
                                for _ in range(20)]).tolist()
    emit("train_int8", what="learning on one batch, lr 1e-4, warmup 2",
         first_recon_loss=recon_losses[0], last_recon_loss=recon_losses[-1],
         recon_losses=recon_losses)
    require(recon_losses[-1] < recon_losses[0],
            f"recon loss did not fall: {recon_losses[0]} -> {recon_losses[-1]}")

    # Step time in turns, bf16 / int8 / int8 / bf16: host clock around
    # synchronised steps, median of 5 after 2.
    timing = {"bf16": [], "int8": []}
    for arm in ("bf16", "int8", "int8", "bf16"):
        torch.cuda.reset_peak_memory_stats()
        ms = host_median_ms(lambda: (steps[arm](quick, images, usage),
                                     torch.cuda.synchronize()), 5)
        timing[arm].append(dict(step_ms=ms, images_per_s=TRAIN_BS / ms * 1e3,
                                peak_gb=torch.cuda.max_memory_allocated()
                                / 2**30))
    emit("train_int8", what="throughput at bs 64, int8 vs bf16 perceptual "
         "loss, in turns", card=card, **timing)
    emit("train_int8", what="profile of one int8 step", card=card,
         **profile_window(lambda: steps["int8"](quick, images, usage)))
    del quick, q8, net, steps
    torch.cuda.empty_cache()
    return launches


def phase_perceptual(state_dict: dict, card: str) -> dict:
    """``scripts/bench_perceptual.py``'s measurement: the perceptual loss
    and its gradient with respect to x at bs 64, image 128, under the four
    arms of ``dw_impl`` × ``quant``, each with its launches per call, against
    its plain versions, its time and a profile of one call; under int8 every
    K12a and K12b launch of the first call within ``Q8_MEAN_REL`` of its
    plain version on the same inputs. The net is the flagship's, with γ
    drawn around 0.5 (the flagship step's init of 1e-6 hides every tail, so
    there K12's outputs equal its plain version's). Returns the launches of
    one call of each arm."""
    rng = np.random.default_rng(3)
    x, y = (torch.from_numpy(rng.uniform(0, 1, (PERCEPTUAL_BS, 128, 128, 3))
                             .astype(np.float32)).cuda() for _ in range(2))
    gen = torch.Generator(device="cuda").manual_seed(5)
    state_dict = dict(state_dict)
    for k in state_dict:
        if k.endswith(".gamma"):
            state_dict[k] = 0.5 + 0.1 * torch.randn(
                state_dict[k].shape, device="cuda", generator=gen)
    total, arms = {}, {}
    for dw_impl, quant in PERCEPTUAL_ARMS:
        net = ConvNeXt(dtype=torch.bfloat16, dw_impl=dw_impl, quant=quant)
        net.load_state_dict(state_dict)
        loss_fn = PerceptualLoss(net).cuda()
        xg = x.clone().requires_grad_()

        def call():
            loss = loss_fn(xg, y)
            return loss, torch.autograd.grad(loss, xg)[0]

        torch.cuda.synchronize()
        reset_launches()   # the main path's run starts here
        with held_launches() as worst:
            loss, grad = call()
            torch.cuda.synchronize()
        launches = read_launches()
        with plain_versions():
            plain_loss, plain_grad = call()
        torch.cuda.synchronize()
        want = dict.fromkeys(launches, 0)
        # the trunk is frozen: every K11b launch in its dx-only form
        want.update(depthwise_fwd=72 if dw_impl == "pallas" else 0,
                    depthwise_bwd=36 if dw_impl == "pallas" else 0,
                    depthwise_bwd_dx_only=36 if dw_impl == "pallas" else 0)
        tails = ("convnext_tail_fwd_q8", "convnext_tail_bwd_q8") \
            if quant == "int8" else ("convnext_tail_fwd", "convnext_tail_bwd")
        want.update({tails[0]: 66, tails[1]: 33})
        name = f"dw_{dw_impl}_quant_{quant}"
        arms[name] = dict(
            launches={k: v for k, v in launches.items() if v},
            loss=loss.item(), plain_loss=plain_loss.item(),
            loss_rel=abs(loss.item() - plain_loss.item()) / abs(plain_loss.item()),
            grad=rel_errors(grad, plain_grad),
            ms=host_median_ms(lambda: (call(), torch.cuda.synchronize()), 5),
            profile=profile_window(call),
            held_launches=(require_held(worst, name) if quant == "int8"
                           else None))
        arms[name]["expected_launches"] = launches == want
        arms[name]["finite"] = bool(torch.isfinite(grad).all()
                                    and grad.abs().max() > 0)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        del net, loss_fn, xg, loss, grad, plain_loss, plain_grad
        torch.cuda.empty_cache()
    emit("perceptual", what="loss and image gradient at bs 64, image 128",
         card=card, arms=arms,
         tolerance=dict(loss_rel=PERCEPTUAL_LOSS_REL,
                        grad_max_rel=PERCEPTUAL_GRAD_MAX_REL,
                        grad_mean_rel=PERCEPTUAL_GRAD_MEAN_REL))
    for name, arm in arms.items():
        require(arm["expected_launches"],
                f"{name}: one call launched {arm['launches']}")
        require(arm["finite"] and arm["loss_rel"] <= PERCEPTUAL_LOSS_REL
                and arm["grad"]["max_rel"] <= PERCEPTUAL_GRAD_MAX_REL
                and arm["grad"]["mean_rel"] <= PERCEPTUAL_GRAD_MEAN_REL,
                f"{name} vs its plain versions: {arm}")
    return total


# The data phase's fixtures: DMLab clips as the reference stores them
# (np.savez, uncompressed: 'video' (300, 64, 64, 3) uint8, 'actions' (300,)),
# tar shards of npy/cls/json payloads, and (where Pillow is here) JPEGs
DMLAB_CLIPS, DMLAB_FOLDERS = 96, 4     # 3 batches an epoch at bs 32
DMLAB_SHAPE = (300, 64, 64, 3)
SHARD_SAMPLES, SHARD_MAXCOUNT = 40, 8
LOADER_BATCHES = 16        # the image loader's batches timed alone
LOADER_EPOCHS = 1          # the video loader's epochs timed alone
DATA_STEPS = 3
JPEG_TRAIN, JPEG_VAL, JPEG_SIZE = 128, 64, 288


def write_dmlab(root: Path) -> "list[Path]":
    """DMLAB_CLIPS clips in ``<root>/<folder>/<video>.npz``, from seed 21;
    their paths in the order DmlabDataset lists them."""
    rng = np.random.default_rng(21)
    paths = []
    for v in range(DMLAB_CLIPS):
        folder = root / f"{v % DMLAB_FOLDERS:02d}"
        folder.mkdir(parents=True, exist_ok=True)
        path = folder / f"{v:04d}.npz"
        np.savez(path, video=rng.integers(0, 256, DMLAB_SHAPE, np.uint8),
                 actions=rng.integers(0, 9, DMLAB_SHAPE[:1]))
        paths.append(path)
    return sorted(paths)


def first_order(n: int) -> np.ndarray:
    """The threaded loader's first epoch at seed 0: ``default_rng(0)``'s
    shuffle of ``arange(n)``."""
    order = np.arange(n)
    np.random.default_rng(0).shuffle(order)
    return order


def loader_rate(loader, batches: int, epochs: int = 1) -> dict:
    """The loader alone: ``batches`` batches (or ``epochs`` whole epochs),
    batches a second on the host's clock."""
    t0 = time.perf_counter()
    n = 0
    for _ in range(epochs):
        for _ in loader:
            n += 1
            if n == batches:
                break
    seconds = time.perf_counter() - t0
    return dict(batches=n, seconds=seconds, batches_per_s=n / seconds)


def load_times(run_dir: Path) -> "list[float]":
    """Each logged step's ``benchmark/load_time`` (the wait for the
    prefetched batch) from the entry's JSONL log."""
    (path,) = run_dir.rglob("*.jsonl")
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    return [r["benchmark/load_time"] for r in rows
            if "benchmark/load_time" in r]


@contextlib.contextmanager
def first_images(into: dict):
    """``into["images"]``: a device copy of the first batch the tokenizer
    loop's step gets."""
    from vit_tpu_torch.train import loop

    factory = loop.make_tokenizer_train_step

    def make(model, **kw):
        step = factory(model, **kw)

        def hooked(state, images, usage):
            if "images" not in into:
                into["images"] = images.clone()
            return step(state, images, usage)

        return hooked

    loop.make_tokenizer_train_step = make
    try:
        yield
    finally:
        loop.make_tokenizer_train_step = factory


def frames_from_clips(images: torch.Tensor, paths: "list[Path]") -> dict:
    """The tokenizer's DMLab batch (bs / 8 items of 8 frames) against its
    clips: item b's frames must each equal, bit for bit, a frame / 255 of
    the clip its shuffled index names (index mod clips); which frames
    follows the loader threads' global draws (ROADMAP Queue C, hazard 8)."""
    order = first_order(len(paths) * 1000)
    items = images.shape[0] // 8
    matched = 0
    for b in range(items):
        # divided on the host as the dataset divides (a CUDA division by a
        # scalar multiplies by its reciprocal, which rounds differently)
        clip = torch.from_numpy(np.load(paths[int(order[b]) % len(paths)])[
            "video"].astype(np.float32) / 255.0).to(images.device)
        for f in images[8 * b:8 * b + 8]:
            matched += int(bool((clip == f).flatten(1).all(1).any()))
    return dict(frames=items * 8, matched=matched)


def data_shards(root: Path) -> dict:
    """npy/cls/json shards written by the port's ShardWriter, streamed
    back through StreamingWebDataset and StreamingBatcher: at one worker in
    ``iterate_shard``'s order, batch for batch; at four workers with a
    shuffle buffer, every sample once an epoch; the shard split of two
    shards taking every full shard once."""
    from vit_tpu_torch.data import wds

    rng = np.random.default_rng(5)
    items = [{"__key__": f"s{i:05d}",
              "npy": rng.standard_normal((4, 3)).astype(np.float32),
              "cls": int(rng.integers(0, 100)), "json": {"i": i}}
             for i in range(SHARD_SAMPLES)]
    with wds.ShardWriter(str(root / "shards" / "d-%04d.tar"),
                         maxcount=SHARD_MAXCOUNT) as w:
        for item in items:
            w.write(item)
    shards = w.paths
    want = [s for p in sorted(shards) for s in wds.iterate_shard(p)]

    def row(sample):
        return sample["npy"], np.int32(sample["cls"]), np.int32(
            sample["json"]["i"])

    batches = list(wds.StreamingBatcher(
        wds.StreamingWebDataset(shards, workers=1, shuffle_buffer=0,
                                transform=row), 8))
    ordered = len(batches) == SHARD_SAMPLES // 8 and all(
        np.array_equal(b[0], np.stack([s["npy"] for s in want[8 * k:8 * k + 8]]))
        and b[1].tolist() == [s["cls"] for s in want[8 * k:8 * k + 8]]
        and b[2].tolist() == [s["json"]["i"] for s in want[8 * k:8 * k + 8]]
        for k, b in enumerate(batches))
    shuffled = wds.StreamingWebDataset(shards, workers=4, shuffle_buffer=10,
                                       transform=row)
    epochs = [sorted(int(i) for _, _, i in shuffled) for _ in range(2)]
    covered = all(e == list(range(SHARD_SAMPLES)) for e in epochs)
    split = [wds.StreamingWebDataset(shards, shard_id=k, num_shards=2)
             .shard_paths for k in range(2)]
    out = dict(shards=len(shards), samples=SHARD_SAMPLES,
               ordered_batches_equal=ordered, shuffled_epochs_cover=covered,
               split=[len(x) for x in split])
    require(ordered and covered and sorted(split[0] + split[1])
            == sorted(shards)[:-1], f"tar shards: {out}")
    return out


def write_jpegs(root: Path) -> Path:
    """ImageNet folders (JPEG_TRAIN train and JPEG_VAL val images of
    JPEG_SIZE px in 4 classes) and the same train images as jpg + cls
    shards, encoded by Pillow."""
    from PIL import Image

    from vit_tpu_torch.data import wds

    rng = np.random.default_rng(9)
    with wds.ShardWriter(str(root / "jpg" / "i-%04d.tar"),
                         maxcount=32) as w:
        for split, n in (("train", JPEG_TRAIN), ("val", JPEG_VAL)):
            for i in range(n):
                arr = rng.integers(0, 256, (JPEG_SIZE, JPEG_SIZE + 32, 3),
                                   np.uint8)
                folder = root / "imagenet" / split / f"n{i % 4:04d}"
                folder.mkdir(parents=True, exist_ok=True)
                Image.fromarray(arr).save(folder / f"{i}.JPEG")
                if split == "train":
                    w.write({"__key__": f"k{i:05d}", "jpg": arr,
                             "cls": i % 4})
    return root


def refusals(found: dict) -> dict:
    """For each decoder this machine lacks, the entries refuse its paths
    before anything is built, naming the package."""
    from vit_tpu_torch.train_titok import check_ported as titok_check
    from vit_tpu_torch.train_titok import parse_args as titok_args
    from vit_tpu_torch.train_vit import check_ported as vit_check
    from vit_tpu_torch.train_vit import parse_args as vit_args

    cases = []
    if not found["cv2"]:
        cases.append(("cv2", titok_check, titok_args(
            ["--dataset", "minecraft", "--image_size", "128"])))
    if not found["grain"]:
        cases.append(("grain", vit_check, vit_args(
            ["--dataset", "imagenet", "--loader_backend", "grain"])))
    if not found["PIL"]:
        cases.append(("PIL", vit_check, vit_args(
            ["--dataset", "wds", "--wds_shards", "x"])))
        if not found["native"]:
            cases.append(("PIL", titok_check, titok_args(
                ["--dataset", "imagenet"])))
    out = {}
    for package, check, args in cases:
        try:
            check(args)
            message = ""
        except NotImplementedError as e:
            message = str(e)
        out[f"{args.dataset}/{args.loader_backend}"] = message
        require(package in message, f"no refusal naming {package}: "
                f"{message!r}")
    return out


def phase_data(card: str, work: Path) -> dict:
    """The port's data layer on fixtures written here: ``train_videogpt``
    at its defaults (``--dataset dmlab``: VideoGPT-B over the random
    TiTok-S, bs 32, S 1024) and ``train_titok --dataset dmlab --image_size
    64`` at TiTok-B (bs 64, the random ConvNeXt-S perceptual loss), each
    for DATA_STEPS steps through its ``main`` with the kernels' launches
    counted; the first batch on the card against the numpy batch of the
    same clips, bit for bit (the tokenizer's frames by clip membership);
    each loader's batches a second alone; the step time and the wait for
    the batch beside the same entry on its synthetic stream; the tar
    shards; and, where the machine has a JPEG decoder, ``train_vit
    --dataset imagenet`` and ``--dataset wds --wds_streaming true`` and
    ``train_titok --dataset imagenet`` for two steps each; for each
    missing decoder the refusal naming it. Returns the launches."""
    from vit_tpu_torch.data.video import (get_dmlab_image_loaders,
                                          get_dmlab_video_loaders)

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    paths = write_dmlab(work / "dmlab")
    written = time.perf_counter() - t0

    def dirs(name):
        return ("--ckpt_dir", str(work / name / "ckpt"),
                "--run_dir", str(work / name / "runs"))

    out = dict(fixtures=dict(dmlab_clips=len(paths), clip=list(DMLAB_SHAPE),
                             compressed=False, seconds=written))
    runs = []

    # train_videogpt at its defaults on the clips: one epoch of 3 batches
    first: dict = {}
    gpt = run_videogpt_main("--data_dir", str(work / "dmlab"), "--no_wandb",
                            "--log_every", "1", "--epochs", "1",
                            *dirs("gpt_dmlab"), first=first)
    order = first_order(len(paths))
    videos = np.stack([np.load(paths[i])["video"]
                       for i in order[:VIDEO_BS]])
    offset = int(np.random.default_rng((0, 0xC407, 0)).integers(
        0, DMLAB_SHAPE[0] - VIDEOGPT["max_frames"]))
    want = torch.from_numpy(np.ascontiguousarray(
        videos[:, offset:offset + VIDEOGPT["max_frames"]], np.float32) / 255.0)
    gpt_equal = bool(torch.equal(first["videos"].cpu(), want))
    del videos, want, first
    require(gpt_equal, "train_videogpt's first DMLab batch on the card "
            "differs from the numpy batch")
    require(len(gpt["steps"]) == DATA_STEPS, f"{gpt['cmd']}: {gpt['lines']}")
    require_launched(gpt, ("attention_packed_fwd", "vq_nearest",
                           "attention_fwd", "attention_bwd"))
    gpt_syn = run_videogpt_main(*GPT_ENTRY, "--steps_per_epoch",
                                str(DATA_STEPS), "--epochs", "1",
                                *dirs("gpt_syn"))
    runs += [gpt, gpt_syn]
    out["train_videogpt"] = dict(
        cmd=gpt["cmd"], seconds=gpt["seconds"], first_batch_equal=gpt_equal,
        step_losses=[l for _, l, _ in gpt["steps"]],
        step_times=[t for _, _, t in gpt["steps"]],
        load_times=load_times(work / "gpt_dmlab" / "runs"),
        launches={n: v for n, v in gpt["launches"].items() if v},
        synthetic_step_times=[t for _, _, t in gpt_syn["steps"]],
        synthetic_load_times=load_times(work / "gpt_syn" / "runs"),
        loader=loader_rate(get_dmlab_video_loaders(
            VIDEO_BS, str(work / "dmlab"))[0], 10 ** 9, LOADER_EPOCHS))
    del gpt["state"], gpt_syn["state"]
    torch.cuda.empty_cache()

    # train_titok on the clips at image 64, TiTok-B
    titok_flags = ("--bs", "64", "--perceptual_weights", "random",
                   "--no_wandb", "--log_every", "1", "--image_size", "64",
                   "--epochs", "1")
    seen: dict = {}
    with first_images(seen):
        tok = run_titok_main(*titok_flags, "--dataset", "dmlab",
                             "--data_dir", str(work / "dmlab"),
                             "--max_epoch_steps", str(DATA_STEPS),
                             *dirs("titok_dmlab"))
    member = frames_from_clips(seen.pop("images"), paths)
    require(member["matched"] == member["frames"],
            f"train_titok's first DMLab batch: {member}")
    require(len(tok["steps"]) == DATA_STEPS, f"{tok['cmd']}: {tok['lines']}")
    require_launched(tok, ("attention_packed_fwd", "attention_packed_bwd",
                           "convnext_tail_fwd", "convnext_tail_bwd",
                           "vq_nearest"))
    tok_syn = run_titok_main(*titok_flags, "--dataset", "synthetic",
                             "--steps_per_epoch", str(DATA_STEPS),
                             *dirs("titok_syn"))
    runs += [tok, tok_syn]
    out["train_titok"] = dict(
        entry_summary(tok), first_batch_frames=member,
        load_times=load_times(work / "titok_dmlab" / "runs"),
        synthetic_step_times=[t for _, _, t in tok_syn["steps"]],
        synthetic_load_times=load_times(work / "titok_syn" / "runs"),
        loader=loader_rate(get_dmlab_image_loaders(
            64, str(work / "dmlab"))[0], LOADER_BATCHES))
    torch.cuda.empty_cache()

    out["shards"] = data_shards(work)
    found = measured["decoders"]
    out["refusals"] = refusals(found)
    if found["PIL"]:
        write_jpegs(work)
        jpeg_runs = {}
        for name, flags in (
                ("vit_imagenet", ("--dataset", "imagenet", "--data_dir",
                                  str(work / "imagenet"))),
                ("vit_wds", ("--dataset", "wds", "--wds_streaming", "true",
                             "--wds_shards", str(work / "jpg" / "*.tar"))),
        ):
            jpeg_runs[name] = run_vit_main(*flags, "--no_wandb", "--epochs",
                                           "1", "--log_every", "1",
                                           *dirs(name))
            require_launched(jpeg_runs[name], ("attention_packed_fwd",
                                               "attention_packed_bwd"))
        jpeg_runs["titok_imagenet"] = run_titok_main(
            "--dataset", "imagenet", "--data_dir", str(work / "imagenet"),
            "--bs", "64", "--perceptual_weights", "random", "--no_wandb",
            "--log_every", "1", "--epochs", "1", *dirs("titok_imagenet"))
        require_launched(jpeg_runs["titok_imagenet"],
                         ("attention_packed_fwd", "vq_nearest"))
        runs += list(jpeg_runs.values())
        out["jpeg"] = {k: dict(cmd=r["cmd"], seconds=r["seconds"],
                               decoder=[line for line in r["lines"]
                                        if line.startswith("DECODER:")],
                               step_times=[t for _, _, t in r["steps"]],
                               launches={n: v for n, v in r["launches"]
                                         .items() if v})
                       for k, r in jpeg_runs.items()}
    from vit_tpu_torch.data import native

    emit("data", card=card, decoders=found,
         native_build_error=native.build_error[-600:], **out)
    torch.cuda.empty_cache()
    return {n: sum(r["launches"][n] for r in runs) for n in runs[0]["launches"]}


def run_vit_main(*flags: str) -> dict:
    """``vit_tpu_torch.train_vit.main(flags)`` in this process (defaults:
    ViT-L/16 @256, dropout 0.15, bs 64), its output captured, the launch
    counts set to 0 just before it and read just after."""
    from vit_tpu_torch.train_vit import main as vit_main

    buf = io.StringIO()
    prev = signal.getsignal(signal.SIGTERM)
    t0 = time.perf_counter()
    reset_launches()
    try:
        with contextlib.redirect_stdout(buf):
            vit_main(list(flags))
        torch.cuda.synchronize()
    finally:
        signal.signal(signal.SIGTERM, prev)
    lines = buf.getvalue().splitlines()
    steps = [re.match(r"e=\d+ i=(\d+) loss=(\S+) acc=\S+ load_time=\S+ "
                      r"step_time=(\S+)", line) for line in lines]
    steps = [(int(m.group(1)), float(m.group(2)), float(m.group(3)))
             for m in steps if m]
    require(steps and all(np.isfinite(l) for _, l, _ in steps)
            and any(line.startswith("epoch 0: val_loss=") for line in lines),
            f"train_vit's lines: {lines[-30:]}")
    torch.cuda.empty_cache()
    return dict(cmd="-m vit_tpu_torch.train_vit " + " ".join(flags),
                seconds=time.perf_counter() - t0, lines=lines, steps=steps,
                launches=read_launches())


REPRO_STEPS = 2   # cut from 3 to keep the run in its time; the second step
                  # already starts from updated parameters and moments
REPRO_ENTRY = ("--dataset", "synthetic", "--bs", "64", "--perceptual_weights",
               "random", "--no_wandb", "--log_every", "1", "--epochs", "1")


def repro_run(steps: int, work: str, record) -> "list[str]":
    """``train_titok.main`` at TiTok-B for ``steps`` steps; ``record(step,
    grads, params)`` after each step, the gradients copied before the
    update. Returns the entry's printed lines."""
    from vit_tpu_torch.train.state import TrainState
    from vit_tpu_torch.train_titok import main as titok_main

    apply = TrainState.apply_gradients
    count = [0]

    def recording(self, grads):
        g = [t.detach().float().clone() for t in grads]
        out = apply(self, grads)
        record(count[0], dict(zip(self.names, g)),
               {n: p.detach().float().clone()
                for n, p in zip(self.names, self.params)})
        count[0] += 1
        return out

    TrainState.apply_gradients = recording
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            titok_main([*REPRO_ENTRY, "--steps_per_epoch", str(steps),
                        "--ckpt_dir", os.path.join(work, "ckpt"),
                        "--run_dir", os.path.join(work, "runs"),
                        "--ckpt_every", str(10 ** 9)])
        torch.cuda.synchronize()
    finally:
        TrainState.apply_gradients = apply
    return buf.getvalue().splitlines()


def differ(a: dict, b: dict) -> dict:
    """Which tensors of two {name: tensor} differ in any bit, and by how
    much at most."""
    names = [n for n in a if not torch.equal(a[n], b[n])]
    worst = max(((a[n] - b[n]).abs().max().item() for n in names),
                default=0.0)
    return dict(count=len(names), of=len(a), names=names[:12],
                max_abs=worst)


def phase_repro(card: str) -> None:
    """Two ``REPRO_STEPS``-step ``train_titok`` runs at TiTok-B (bs 64, the
    random perceptual loss) from one seed: every gradient and parameter
    after every step bit for bit (ROADMAP Queue C #3, repaired by the
    codebook lookup's ``F.embedding``)."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    first, steps = [], []

    def keep(step, grads, params):
        first.append((grads, params))

    def compare(step, grads, params):
        g0, p0 = first[step]
        steps.append(dict(step=step, grads=differ(g0, grads),
                          params=differ(p0, params)))

    reset_launches()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_repro_") as work:
        lines = [repro_run(REPRO_STEPS, os.path.join(work, run), record)
                 for run, record in (("a", keep), ("b", compare))]
    launches = read_launches()
    del first
    bit_equal = all(r["grads"]["count"] == 0 and r["params"]["count"] == 0
                    for r in steps)
    worst = max(max(r["grads"]["max_abs"], r["params"]["max_abs"])
                for r in steps)
    losses = [[float(m.group(1)) for m in (re.search(r" loss=(\S+)", line)
                                           for line in run) if m]
              for run in lines]
    emit("repro", card=card, seconds=time.perf_counter() - t0,
         bit_equal=bit_equal, largest_difference=worst, steps=steps,
         losses=losses, launches={n: v for n, v in launches.items() if v})
    require(bit_equal and len(steps) == REPRO_STEPS
            and launches["vq_nearest"] > 0,
            f"two runs from one seed part: {steps}")
    torch.cuda.empty_cache()


# -- pretrain: the 32-wide attention kernels, MAE-B and Puzzle-B -------------

MAE_BS = 64       # train_mae.py's and train_puzzle.py's --bs
MAE_IMAGE = 256   # and --image_size (patch 16): MAE-B's S 65 encoder (head_dim
                  # 64) and S 257 decoder (16 heads × 32), Puzzle-B's S 256
MAE_DEC = (MAE_BS, 257, 16, 32)   # the decoder's attention: B, S, heads, d
# MAE-B at image 512: the decoder's S 1025 (> 768) takes K6 and K7/K8 at
# head_dim 32; the encoder keeps 257 tokens (K1/K2 at 64)
MAE_HIRES_IMAGE, MAE_HIRES_BS = 512, 8
MAE_FP32_BS = 16  # the fp32 (--mixed false) MAE-B step's batch
HD32 = {"attention_packed_fwd": "attention_packed_fwd_d32",
        "attention_packed_bwd": "attention_packed_bwd_d32",
        "attention_fwd": "attention_fwd_d32",
        "attention_bwd": "attention_bwd_d32"}
PRETRAIN_ENTRY = ("--dataset", "synthetic", "--no_wandb", "--epochs", "1",
                  "--steps_per_epoch", "3", "--log_every", "1")


def hd32_packed(gen) -> dict:
    """K1 and K2 at head_dim 32, at the MAE-B decoder's shape (64, 257, 16
    heads × 32): bf16 without a bias and with one, with dropout 0.15, each
    against its plain version within the packed kernels' limits (K1's
    max/mean abs and ``WGMMA_FWD_MEAN_REL``, K2's ``BWD_*`` and
    ``WGMMA_BWD_MEAN_REL``) and the controls that must fail them; the fp32
    forms (with the bias, with and without dropout) within ``FP32_REL``, the
    float64 forward within ``F32_FWD_MEAN_REL``, ``F32_BWD_MEAN_REL``, and
    the two-part controls; the dropout mask bit for bit (``mask_probe`` at
    d 32); times, bounds and SDPA's times. Returns the kernels line's
    entries."""
    b, s, h, d = MAE_DEC
    width = h * d

    def randn(*shape, scale=1.0):
        return scale * torch.randn(*shape, device="cuda", generator=gen)

    fwd_rows, bwd_rows, k1_max, k2_max = [], [], 0.0, 0.0
    for case, bias_scale, rate in (("no bias", 0.0, 0.0), ("bias", 0.3, 0.0),
                                   ("bias, dropout", 0.3, VIT_DROPOUT)):
        qkv = randn(b, s, 3 * width).bfloat16()
        bias = randn(3 * width, scale=bias_scale)
        dout = randn(b, s, width).bfloat16()
        drop = dict(dropout_rate=rate, seed=random_seed(gen)) if rate else {}
        out, m, l = k_attn.attention_packed_fwd(qkv, bias, h, False, True,
                                                **drop)
        torch.cuda.synchronize()
        ref, m_ref, l_ref = k_attn.attention_packed_fwd_ref(qkv, bias, h,
                                                            False, True, **drop)
        diff = (out.float() - ref.float()).abs()
        row = dict(case=case, B=b, S=s, H=h, d=d, rate=rate,
                   max_abs=diff.max().item(), mean_abs=diff.mean().item(),
                   mean_rel=rel_errors(out, ref)["mean_rel"],
                   m_rel=((m - m_ref).abs().max() / m_ref.abs().max()).item(),
                   l_rel=((l - l_ref).abs() / l_ref).max().item())
        if rate:
            row.update(dropped_fraction(drop["seed"], b, h, s, False, rate))
        require(bool(torch.isfinite(out).all())
                and row["max_abs"] <= K1_MAX_ABS
                and row["mean_abs"] <= K1_MEAN_ABS
                and row["mean_rel"] <= WGMMA_FWD_MEAN_REL
                and row["m_rel"] <= K1_STATS_REL
                and row["l_rel"] <= K1_STATS_REL
                and row.get("sigmas_from_rate", 0.0) <= DROP_SIGMAS,
                f"K1 at head_dim 32 disagrees with its plain version: {row}")
        fwd_rows.append(row)
        k1_max = max(k1_max, row["max_abs"])
        del ref, m_ref, l_ref, diff
        dqkv, dbias = k_attn.attention_packed_bwd(qkv, bias, dout, m, l, h,
                                                  False, **drop)
        torch.cuda.synchronize()
        dqkv_ref, dbias_ref = k_attn.attention_packed_bwd_ref(
            qkv, bias, dout, m, l, h, False, **drop)
        brow = dict(case=case, dqkv=rel_errors(dqkv, dqkv_ref),
                    dbias=rel_errors(dbias, dbias_ref))
        for key in ("dqkv", "dbias"):
            require(bool(torch.isfinite(dqkv).all()
                         and torch.isfinite(dbias).all())
                    and brow[key]["max_rel"] <= BWD_MAX_REL
                    and brow[key]["mean_rel"] <= BWD_MEAN_REL
                    and brow[key]["mean_rel"] <= WGMMA_BWD_MEAN_REL,
                    f"K2 at head_dim 32 disagrees with its plain version: "
                    f"{brow}")
        bwd_rows.append(brow)
        k2_max = max(k2_max, brow["dqkv"]["max_abs"])
        del qkv, bias, dout, out, m, l, dqkv, dbias, dqkv_ref, dbias_ref
    torch.cuda.empty_cache()
    probe = mask_probe(4, h, s, False, VIT_DROPOUT, gen, True, d)

    # controls and times on the biased bf16 case, with statistics (the
    # training path's call)
    qkv = randn(b, s, 3 * width).bfloat16()
    bias = randn(3 * width, scale=0.3)
    dout = randn(b, s, width).bfloat16()
    q, k, v = k_attn.split_heads(qkv, h, bias)
    dh = dout.reshape(b, s, h, d).transpose(1, 2)
    _, m, l = k_attn.attention_packed_fwd(qkv, bias, h, False, True)
    controls = dict(fwd=normalised_p_control(q, k, v, False),
                    bwd=rounded_ph_control(q, k, v, dh, m, l))
    k1 = dict(ms=median_ms(lambda: k_attn.attention_packed_fwd(
                  qkv, bias, h, False, True)),
              plain_ms=median_ms(lambda: k_attn.attention_packed_fwd_ref(
                  qkv, bias, h, False, True), 5),
              sdpa_ms=median_ms(lambda: F.scaled_dot_product_attention(
                  q, k, v)),
              sdpa_backend=sdpa_backend(q, k, v, False),
              bound=attention_bound(b, h, s, False, False,
                                    extra_bytes=3 * width * 4, d=d))
    k2 = dict(ms=median_ms(lambda: k_attn.attention_packed_bwd(
                  qkv, bias, dout, m, l, h, False)),
              plain_ms=median_ms(lambda: k_attn.attention_packed_bwd_ref(
                  qkv, bias, dout, m, l, h, False), 5),
              sdpa=sdpa_backward_ms(q, k, v, dh, False),
              bound=attention_bound(b, h, s, False, True,
                                    extra_bytes=3 * width * 8, d=d))
    del qkv, bias, dout, q, k, v, dh, m, l
    torch.cuda.empty_cache()

    fp32 = {}
    for arm, rate in (("bias", 0.0), ("bias, dropout", VIT_DROPOUT)):
        qkv = randn(b, s, 3 * width)
        bias = randn(3 * width, scale=0.3)
        dout = randn(b, s, width)
        drop = dict(dropout_rate=rate, seed=random_seed(gen) if rate else None)
        out, m, l = k_attn.attention_packed_fwd(qkv, bias, h, False, True,
                                                **drop)
        dqkv, dbias = k_attn.attention_packed_bwd(qkv, bias, dout, m, l, h,
                                                  False, **drop)
        torch.cuda.synchronize()
        ref, m_ref, l_ref = k_attn.attention_packed_fwd_ref(qkv, bias, h,
                                                            False, True, **drop)
        dqkv_ref, dbias_ref = k_attn.attention_packed_bwd_ref(
            qkv, bias, dout, m_ref, l_ref, h, False, **drop)
        qh, kh, vh = k_attn.split_heads(qkv, h, bias)
        exact = exact_attention_fwd(qh, kh, vh, False, **drop)
        row = dict(**f32_fwd_check(
                       "K1 d32", (out.reshape(b, s, h, d).transpose(1, 2), m,
                                  l),
                       (ref.reshape(b, s, h, d).transpose(1, 2), m_ref, l_ref),
                       exact),
                   dqkv=f32_bwd_check("K2 d32", dqkv, dqkv_ref),
                   dbias=f32_bwd_check("K2 d32 dbias", dbias, dbias_ref))
        if not rate:
            dh = dout.reshape(b, s, h, d).transpose(1, 2)
            row["controls"] = dict(
                fwd=two_part_fwd_control(qh, kh, vh, False, exact),
                bwd=two_part_control(qh, kh, vh, dh, m, l, False))
            del ref, m_ref, l_ref, dqkv_ref, dbias_ref, exact
            row.update(
                fwd_ms=median_ms(lambda: k_attn.attention_packed_fwd(
                    qkv, bias, h, False, True)),
                fwd_plain_ms=median_ms(lambda: k_attn.attention_packed_fwd_ref(
                    qkv, bias, h, False, True), 3),
                sdpa_fwd_ms=median_ms(lambda: F.scaled_dot_product_attention(
                    qh, kh, vh)),
                bwd_ms=median_ms(lambda: k_attn.attention_packed_bwd(
                    qkv, bias, dout, m, l, h, False)),
                bwd_plain_ms=median_ms(lambda: k_attn.attention_packed_bwd_ref(
                    qkv, bias, dout, m, l, h, False), 3),
                sdpa_bwd=sdpa_backward_ms(qh, kh, vh, dh, False),
                fwd_bound=attention_bound(b, h, s, False, False,
                                          extra_bytes=3 * width * 4, elem=4,
                                          peak=PEAK_SPLIT_FLOPS, d=d),
                bwd_bound=attention_bound(b, h, s, False, True,
                                          extra_bytes=3 * width * 8, elem=4,
                                          peak=PEAK_SPLIT_FLOPS, d=d))
            del dh
        fp32[arm] = row
        del qkv, bias, dout, out, m, l, dqkv, dbias, qh, kh, vh
        torch.cuda.empty_cache()
    build = {n: r for n, r in hopper_attention_ptxas().items()
             if head_width(n) == d}
    emit("pretrain", name="attention_packed_fwd_d32/attention_packed_bwd_d32",
         shape=f"({b}, S {s}, 3·{h}·{d}) bf16 and fp32, the MAE-B decoder's",
         k1_parity=fwd_rows, k2_parity=bwd_rows, mask_probe=probe,
         tolerance=dict(k1_max_abs=K1_MAX_ABS, k1_mean_abs=K1_MEAN_ABS,
                        wgmma_fwd_mean_rel=WGMMA_FWD_MEAN_REL,
                        stats_rel=K1_STATS_REL, bwd_max_rel=BWD_MAX_REL,
                        bwd_mean_rel=BWD_MEAN_REL,
                        wgmma_bwd_mean_rel=WGMMA_BWD_MEAN_REL,
                        fp32_rel=FP32_REL, f32_fwd_mean_rel=F32_FWD_MEAN_REL,
                        f32_bwd_mean_rel=F32_BWD_MEAN_REL),
         mean_limit_controls=controls, k1=k1, k2=k2, fp32=fp32,
         build={n: r for n, r in build.items()
                if packed_form(n) or fp32_form(n)})
    t = fp32["bias"]
    return {
        HD32["attention_packed_fwd"]: dict(
            max_abs_err=k1_max, ms=k1["ms"], plain_ms=k1["plain_ms"],
            bound_ms=k1["bound"]["bound_ms"],
            bound_by=k1["bound"]["bound_by"], library_ms=k1["sdpa_ms"],
            head_dim=d, shape=f"({b}, {s}, {h} h × {d}) bf16, bias, stats",
            dropout=dict(fwd_rows[-1], mask_probe=probe),
            fp32=dict(max_abs_err=t["out"]["max_abs"], ms=t["fwd_ms"],
                      plain_ms=t["fwd_plain_ms"],
                      bound_ms=t["fwd_bound"]["bound_ms"],
                      bound_by=t["fwd_bound"]["bound_by"],
                      library_ms=t["sdpa_fwd_ms"])),
        HD32["attention_packed_bwd"]: dict(
            max_abs_err=k2_max, ms=k2["ms"], plain_ms=k2["plain_ms"],
            bound_ms=k2["bound"]["bound_ms"],
            bound_by=k2["bound"]["bound_by"],
            library_ms=k2["sdpa"]["backward_ms"], head_dim=d,
            shape=f"({b}, {s}, {h} h × {d}) bf16, bias",
            dropout=bwd_rows[-1],
            fp32=dict(max_abs_err=t["dqkv"]["max_abs"], ms=t["bwd_ms"],
                      plain_ms=t["bwd_plain_ms"],
                      bound_ms=t["bwd_bound"]["bound_ms"],
                      bound_by=t["bwd_bound"]["bound_by"],
                      library_ms=t["sdpa_bwd"]["backward_ms"]))}


def hd32_unpacked(gen) -> dict:
    """K6 and K7/K8 at head_dim 32 at one S > 768: MAE-B @512's decoder
    attention (8, 16 heads, S 1025) on the packed projection's strided
    views, a causal S 800 and K7's range (S 513), each against its plain
    version within the unpacked kernels' limits and their controls; the
    dropout arm (rate 0.1, causal S 1025) and its mask bit for bit; the fp32
    forms within ``FP32_REL``, the float64 forward and ``F32_BWD_MEAN_REL``;
    times, bounds, SDPA's. Returns the kernels line's entries."""
    d, h = 32, 16
    b, s = MAE_HIRES_BS, MAE_HIRES_IMAGE ** 2 // 256 + 1
    k6_rows, k8_rows, k6_max, k8_max = [], [], 0.0, 0.0
    for bb, ss, causal, packed, rate in [(b, s, False, True, 0.0),
                                         (2, 800, True, False, 0.0),
                                         (2, 513, True, False, 0.0),
                                         (2, s, True, False, GPT_DROPOUT)]:
        q, k, v = head_views(bb, h, ss, gen, packed, d)
        dout = torch.randn(bb, ss, h, d, device="cuda",
                           generator=gen).bfloat16().transpose(1, 2)
        drop = dict(dropout_rate=rate, seed=random_seed(gen)) if rate else {}
        out, m, l = k_attn.attention_fwd(q, k, v, causal, True, **drop)
        grads = k_attn.attention_bwd(q, k, v, dout, m, l, causal, **drop)
        torch.cuda.synchronize()
        ref, m_ref, l_ref = k_attn.attention_fwd_ref(q, k, v, causal, True,
                                                     **drop)
        refs = k_attn.attention_bwd_ref(q, k, v, dout, m, l, causal, **drop)
        row = dict(B=bb, S=ss, H=h, d=d, causal=causal, strided=packed,
                   rate=rate, **rel_errors(out, ref),
                   m_rel=((m - m_ref).abs().max() / m_ref.abs().max()).item(),
                   l_rel=((l - l_ref).abs() / l_ref).max().item())
        require(bool(torch.isfinite(out).all())
                and row["max_rel"] <= BWD_MAX_REL
                and row["mean_rel"] <= BWD_MEAN_REL
                and row["mean_rel"] <= WGMMA_FWD_MEAN_REL
                and row["m_rel"] <= K1_STATS_REL
                and row["l_rel"] <= K1_STATS_REL,
                f"K6 at head_dim 32 disagrees with its plain version: {row}")
        brow = dict(B=bb, S=ss, causal=causal, rate=rate,
                    **{n: rel_errors(g, r)
                       for n, g, r in zip(("dq", "dk", "dv"), grads, refs)})
        for n, g in zip(("dq", "dk", "dv"), grads):
            require(bool(torch.isfinite(g).all())
                    and brow[n]["max_rel"] <= BWD_MAX_REL
                    and brow[n]["mean_rel"] <= BWD_MEAN_REL
                    and brow[n]["mean_rel"] <= WGMMA_BWD_MEAN_REL,
                    f"K7/K8 at head_dim 32 disagrees with its plain version: "
                    f"{brow}")
            k8_max = max(k8_max, brow[n]["max_abs"])
        k6_rows.append(row)
        k8_rows.append(brow)
        k6_max = max(k6_max, row["max_abs"])
        del q, k, v, dout, out, m, l, grads, ref, refs
    torch.cuda.empty_cache()
    probe = mask_probe(2, h, s, True, GPT_DROPOUT, gen, False, d)

    q, k, v = head_views(b, h, s, gen, True, d)
    dout = torch.randn(b, s, h, d, device="cuda",
                       generator=gen).bfloat16().transpose(1, 2)
    _, m, l = k_attn.attention_fwd(q, k, v, False, emit_stats=True)
    controls = dict(fwd=normalised_p_control(q, k, v, False),
                    bwd=rounded_ph_control(q, k, v, dout, m, l))
    k6 = dict(ms=median_ms(lambda: k_attn.attention_fwd(q, k, v, False,
                                                        emit_stats=True)),
              plain_ms=median_ms(lambda: k_attn.attention_fwd_ref(
                  q, k, v, False, emit_stats=True), 5),
              sdpa_ms=median_ms(lambda: F.scaled_dot_product_attention(
                  q, k, v)),
              sdpa_backend=sdpa_backend(q, k, v, False),
              bound=attention_bound(b, h, s, False, False, d=d))
    k8 = dict(ms=median_ms(lambda: k_attn.attention_bwd(q, k, v, dout, m, l,
                                                        False)),
              plain_ms=median_ms(lambda: k_attn.attention_bwd_ref(
                  q, k, v, dout, m, l, False), 5),
              sdpa=sdpa_backward_ms(q, k, v, dout, False),
              bound=attention_bound(b, h, s, False, True, d=d))
    del q, k, v, dout, m, l
    torch.cuda.empty_cache()

    # the fp32 forms at the same shape, contiguous operands
    q, k, v = head_views(b, h, s, gen, False, d, torch.float32)
    dout = torch.randn(b, h, s, d, device="cuda", generator=gen)
    out, m, l = k_attn.attention_fwd(q, k, v, False, True)
    grads = k_attn.attention_bwd(q, k, v, dout, m, l, False)
    torch.cuda.synchronize()
    exact = exact_attention_fwd(q, k, v, False)
    fp32 = dict(**f32_fwd_check("K6 d32", (out, m, l), k_attn.attention_fwd_ref(
        q, k, v, False, True), exact))
    for n, g, r in zip(("dq", "dk", "dv"), grads,
                       k_attn.attention_bwd_ref(q, k, v, dout, m, l, False)):
        fp32[n] = f32_bwd_check(f"K7/K8 d32 {n}", g, r)
    fp32["controls"] = dict(fwd=two_part_fwd_control(q, k, v, False, exact),
                            bwd=two_part_control(q, k, v, dout, m, l, False))
    del exact, out, grads
    fp32.update(
        fwd_ms=median_ms(lambda: k_attn.attention_fwd(q, k, v, False, True)),
        fwd_plain_ms=median_ms(lambda: k_attn.attention_fwd_ref(
            q, k, v, False, True), 3),
        sdpa_fwd_ms=median_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
        bwd_ms=median_ms(lambda: k_attn.attention_bwd(q, k, v, dout, m, l,
                                                      False)),
        bwd_plain_ms=median_ms(lambda: k_attn.attention_bwd_ref(
            q, k, v, dout, m, l, False), 3),
        sdpa_bwd=sdpa_backward_ms(q, k, v, dout, False),
        fwd_bound=attention_bound(b, h, s, False, False, elem=4,
                                  peak=PEAK_SPLIT_FLOPS, d=d),
        bwd_bound=attention_bound(b, h, s, False, True, elem=4,
                                  peak=PEAK_SPLIT_FLOPS, d=d))
    del q, k, v, dout, m, l
    torch.cuda.empty_cache()
    build = {n: r for n, r in hopper_attention_ptxas().items()
             if head_width(n) == d and not packed_form(n)}
    emit("pretrain", name="attention_fwd_d32/attention_bwd_d32",
         shape=f"({b}, {h}, S {s}, {d}) bf16 and fp32, MAE-B @"
               f"{MAE_HIRES_IMAGE}'s decoder", k6_parity=k6_rows,
         k8_parity=k8_rows, mask_probe=probe, mean_limit_controls=controls,
         k6=k6, k8=k8, fp32=fp32, build=build)
    return {
        HD32["attention_fwd"]: dict(
            max_abs_err=k6_max, ms=k6["ms"], plain_ms=k6["plain_ms"],
            bound_ms=k6["bound"]["bound_ms"],
            bound_by=k6["bound"]["bound_by"], library_ms=k6["sdpa_ms"],
            head_dim=d, shape=f"({b}, {h}, {s}, {d}) bf16, strided, stats",
            dropout=dict(k6_rows[-1], mask_probe=probe),
            fp32=dict(max_abs_err=fp32["out"]["max_abs"], ms=fp32["fwd_ms"],
                      plain_ms=fp32["fwd_plain_ms"],
                      bound_ms=fp32["fwd_bound"]["bound_ms"],
                      bound_by=fp32["fwd_bound"]["bound_by"],
                      library_ms=fp32["sdpa_fwd_ms"])),
        HD32["attention_bwd"]: dict(
            max_abs_err=k8_max, ms=k8["ms"], plain_ms=k8["plain_ms"],
            bound_ms=k8["bound"]["bound_ms"],
            bound_by=k8["bound"]["bound_by"],
            library_ms=k8["sdpa"]["backward_ms"], head_dim=d,
            shape=f"({b}, {h}, {s}, {d}) bf16, strided",
            dropout=k8_rows[-1],
            fp32=dict(max_abs_err=max(fp32[n]["max_abs"]
                                      for n in ("dq", "dk", "dv")),
                      ms=fp32["bwd_ms"], plain_ms=fp32["bwd_plain_ms"],
                      bound_ms=fp32["bwd_bound"]["bound_ms"],
                      bound_by=fp32["bwd_bound"]["bound_by"],
                      library_ms=fp32["sdpa_bwd"]["backward_ms"]))}


def pretrain_images(image: int, bs: int) -> torch.Tensor:
    """bs images in [0, 1] from a numpy seed, on the card."""
    rng = np.random.default_rng(6)
    return torch.from_numpy(rng.uniform(
        0, 1, (bs, image, image, 3)).astype(np.float32)).to("cuda")


def pretrain_loss(model, images, noise) -> "tuple[float, float]":
    """The MAE or Puzzle loss on ``noise``'s masks and the global gradient
    norm, in training mode; no optimizer."""
    from vit_tpu_torch.models.mae import MAE, mae_loss
    from vit_tpu_torch.models.puzzle import puzzle_loss

    model.train()
    out, mask = model(images, noise)
    if isinstance(model, MAE):
        cfg = model.config
        loss = mae_loss(out, images, mask, cfg.patch_size, cfg.norm_pix)
    else:
        loss = puzzle_loss(out, mask)[0]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss.item(), torch.sqrt(sum((g.float() ** 2).sum()
                                       for g in grads)).item()


def pretrain_step(name: str, model, step_fn, image: int, bs: int,
                  want: dict, card: str, tol: "tuple[float, float]" = (
                      STEP_LOSS_REL, STEP_GRAD_NORM_REL),
                  time_it: bool = True) -> dict:
    """One step of ``step_fn`` (``make_mae_train_step`` or
    ``make_puzzle_train_step``) at ``train_mae.py``'s optimizer, from one
    noise draw: its launches by head width (``want``, {wrapper: {d: n}}),
    then the same weights' loss and gradient norm through the kernels and
    through the plain versions on the same noise within ``tol``, and its
    time on the card (CUDA events, median of 5 after 3). Returns the
    step's launches by head width and its fp32 launches."""
    images = pretrain_images(image, bs)
    noise = torch.rand(bs, (image // 16) ** 2, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(3))
    state = TrainState.create(model, make_optimizer(
        1.5e-4, 5000, 500000, 1.5e-5, 0.05, clip_norm=None))
    torch.cuda.synchronize()
    reset_launches()   # the main path's run starts here
    _, metrics = step_fn(state, images, noise=noise)
    torch.cuda.synchronize()
    by_d, fp32 = read_head_dim_launches(), read_fp32_launches()
    require(by_d == want, f"{name}: one step launched {by_d}, want {want}")
    step_loss = metrics["train/loss"].item()
    # lr is 0 at the warmup's first step: the weights are unchanged
    loss, norm = pretrain_loss(model, images, noise)
    with plain_versions():
        p_loss, p_norm = pretrain_loss(model, images, noise)
    rel = dict(loss=abs(loss - p_loss) / abs(p_loss),
               grad_norm=abs(norm - p_norm) / abs(p_norm),
               step_loss=abs(step_loss - p_loss) / abs(p_loss))
    row = dict(config=dict(image_size=image, bs=bs,
                           dtype=str(model.config.dtype)),
               params=sum(p.numel() for p in model.parameters()),
               launches_by_head_dim=by_d, step_loss=step_loss, loss=loss,
               plain_loss=p_loss, grad_norm=norm, plain_grad_norm=p_norm,
               rel_diff=rel, tolerance=dict(loss_rel=tol[0],
                                            grad_norm_rel=tol[1]))
    require(np.isfinite(step_loss) and rel["loss"] <= tol[0]
            and rel["step_loss"] <= tol[0] and rel["grad_norm"] <= tol[1],
            f"{name}: kernel step vs plain step: {rel}")
    if time_it:
        torch.cuda.reset_peak_memory_stats()
        ms = median_ms(lambda: step_fn(state, images, noise=noise), 5)
        row.update(card=card, step_ms=ms, images_per_s=bs / ms * 1e3,
                   peak_gb=torch.cuda.max_memory_allocated() / 2**30)
    emit("pretrain", step=name, **row)
    del state, images, noise
    torch.cuda.empty_cache()
    return by_d, fp32


def widths(counts: dict) -> dict:
    """{wrapper: {d: n}} with the zero counts dropped."""
    return {name: {d: n for d, n in c.items() if n}
            for name, c in counts.items() if any(c.values())}


def run_pretrain_main(module: str, *flags: str, hook=None) -> dict:
    """``vit_tpu_torch.<module>.main(flags)`` in this process, its output
    captured, the launch counts set to 0 just before it and read just after
    (by head width too)."""
    import importlib

    entry = importlib.import_module(f"vit_tpu_torch.{module}")
    buf = io.StringIO()
    prev = signal.getsignal(signal.SIGTERM)
    t0 = time.perf_counter()
    reset_launches()
    try:
        with contextlib.redirect_stdout(buf):
            logs = entry.main(list(flags))
        torch.cuda.synchronize()
    finally:
        signal.signal(signal.SIGTERM, prev)
    lines = buf.getvalue().splitlines()
    losses = [r["loss"] for r in logs["train"]]
    require(losses and all(np.isfinite(x) for x in losses) and logs["valid"],
            f"{module}: {lines[-30:]}")
    run = dict(cmd=f"-m vit_tpu_torch.{module} " + " ".join(flags),
               seconds=time.perf_counter() - t0, lines=lines,
               step_losses=losses,
               step_times=[r["step_time"] for r in logs["train"]],
               valid=logs["valid"], launches=read_launches(),
               by_head_dim=read_head_dim_launches())
    torch.cuda.empty_cache()
    return run


def require_widths(run: dict, want: "tuple[int, ...]") -> None:
    """K1 and K2 launched at each head width of ``want`` in the run."""
    missing = [(name, d) for name in ("attention_packed_fwd",
                                      "attention_packed_bwd")
               for d in want if run["by_head_dim"][name][d] == 0]
    require(not missing, f"{run['cmd']}: no launches at {missing}")


def phase_pretrain(card: str) -> "tuple[dict, dict, dict]":
    """The MAE and Puzzle pretraining paths (``train_mae.py``,
    ``train_puzzle.py``) and the fine-tuning hand-off (``train_vit.py
    --init_from``). The 32-wide attention kernels against their plain
    versions (``hd32_packed``, ``hd32_unpacked``); the MAE-B step at bs 64,
    image 256 (K1/K2 12 + 12 at d 64, S 65, and 8 + 8 at d 32, S 257), the
    Puzzle-B step (12 + 12 at d 64, S 256), MAE-B @512 at bs 8 (the decoder's
    S 1025: K6 and K7/K8 8 + 8 at d 32) and MAE-B at fp32 (``--mixed
    false``, bs 16: every launch an fp32 form) against the plain versions
    from one noise draw; then ``python -m vit_tpu_torch.train_mae`` and
    ``train_puzzle`` at their defaults for 3 steps and a validation pass
    (MAE's writes "best"), and ``train_vit --init_from`` that MAE
    checkpoint at ViT-B/16 @256, whose classifier's logits right after the
    hand-off equal those of one that ``load_encoder_into_vit`` built from
    the same checkpoint. Returns the kernels line's entries, the path's
    launches (the 64-wide under the wrappers' names, the 32-wide under
    ``HD32``'s) and the 32-wide fp32 launches."""
    from vit_tpu_torch import train_vit
    from vit_tpu_torch.models.mae import MAE, MAEConfig, load_encoder_into_vit
    from vit_tpu_torch.models.puzzle import Puzzle, PuzzleConfig
    from vit_tpu_torch.train.step import (make_mae_train_step,
                                          make_puzzle_train_step)

    gen = torch.Generator(device="cuda").manual_seed(22)
    summary = {**hd32_packed(gen), **hd32_unpacked(gen)}
    total = {name: dict.fromkeys(k_attn.HEAD_DIMS, 0) for name in HD32}

    def add(by_d):
        for name, counts in by_d.items():
            for d, n in counts.items():
                total[name][d] += n

    def packed(enc: int, dec: int) -> dict:
        want = {name: dict.fromkeys(k_attn.HEAD_DIMS, 0) for name in HD32}
        for name in ("attention_packed_fwd", "attention_packed_bwd"):
            want[name].update({64: enc, 32: dec})
        return want

    mae_cfg = MAEConfig(MAE_IMAGE)
    enc, dec = mae_cfg.enc_config.n_layers, mae_cfg.dec_config.n_layers
    steps = {}
    for name, cfg, want in [
            ("MAE-B", mae_cfg, packed(enc, dec)),
            ("Puzzle-B", PuzzleConfig(MAE_IMAGE), packed(enc, 0))]:
        model = (MAE if name.startswith("MAE") else Puzzle)(cfg,
                                                            device="cuda")
        init_params_(model, torch.Generator(device="cuda").manual_seed(0))
        fn = (make_mae_train_step if name.startswith("MAE")
              else make_puzzle_train_step)(model)
        steps[name] = pretrain_step(name, model, fn, MAE_IMAGE, MAE_BS, want,
                                    card)[0]
        add(steps[name])
        del model, fn
    hires = packed(enc, 0)
    hires["attention_fwd"][32] = hires["attention_bwd"][32] = dec
    model = MAE(MAEConfig(MAE_HIRES_IMAGE), device="cuda")
    init_params_(model, torch.Generator(device="cuda").manual_seed(0))
    add(pretrain_step(f"MAE-B @{MAE_HIRES_IMAGE}", model,
                      make_mae_train_step(model), MAE_HIRES_IMAGE,
                      MAE_HIRES_BS, hires, card)[0])
    model = MAE(MAEConfig(MAE_IMAGE, dtype=torch.float32), device="cuda")
    init_params_(model, torch.Generator(device="cuda").manual_seed(0))
    by_d, fp32 = pretrain_step("MAE-B fp32", model, make_mae_train_step(model),
                               MAE_IMAGE, MAE_FP32_BS, packed(enc, dec), card,
                               (FP32_STEP_REL, FP32_STEP_REL), time_it=False)
    require(all(fp32[n] == sum(by_d[n].values()) for n in by_d),
            f"MAE-B fp32: launches that were not fp32 forms: {by_d} vs {fp32}")
    add(by_d)
    fp32_d32 = {HD32[n]: by_d[n][32] for n in by_d}
    del model
    torch.cuda.empty_cache()

    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pretrain_") as tmp:
        runs["train_mae"] = run_pretrain_main(
            "train_mae", *PRETRAIN_ENTRY, "--ckpt_dir", f"{tmp}/mae",
            "--run_dir", f"{tmp}/runs")
        require_widths(runs["train_mae"], (32, 64))
        require(Path(tmp, "mae", "best", "state.pt").exists(),
                "train_mae wrote no 'best' checkpoint")
        runs["train_puzzle"] = run_pretrain_main(
            "train_puzzle", *PRETRAIN_ENTRY, "--ckpt_dir", f"{tmp}/puzzle",
            "--run_dir", f"{tmp}/runs")
        require_widths(runs["train_puzzle"], (64,))
        # the classifier's logits right after the hand-off, against one that
        # load_encoder_into_vit builds from the same checkpoint
        probe = pretrain_images(MAE_IMAGE, 8)
        seen = {}
        init_from = train_vit.init_from

        def recording(model, directory):
            source = init_from(model, directory)
            with torch.no_grad():
                seen["logits"] = model.eval()(probe)
            model.train()
            return source

        train_vit.init_from = recording
        try:
            runs["train_vit"] = run_pretrain_main(
                "train_vit", *PRETRAIN_ENTRY, "--init_from", f"{tmp}/mae",
                "--transformer", "B", "--image_size", str(MAE_IMAGE),
                "--ckpt_dir", f"{tmp}/vit", "--run_dir", f"{tmp}/runs")
        finally:
            train_vit.init_from = init_from
        require_widths(runs["train_vit"], (64,))
        require(any(line.startswith(f"INIT encoder from MAE checkpoint "
                                    f"{tmp}/mae")
                    for line in runs["train_vit"]["lines"]),
                "train_vit printed no INIT line")
        ref = ViTClassifier(ViTConfig(MAE_IMAGE, 3, 16, "B", 1, 0.15), 1000,
                            device="cuda")
        init_params_(ref, torch.Generator(device="cuda").manual_seed(0))
        ref.load_state_dict(load_encoder_into_vit(
            load_params(f"{tmp}/mae"), ref.state_dict()))
        with torch.no_grad():
            ref_logits = ref.eval()(probe)
        handoff = dict(logits_equal=bool(torch.equal(seen["logits"],
                                                     ref_logits)),
                       max_abs=(seen["logits"] - ref_logits).abs().max()
                       .item())
        require(handoff["logits_equal"],
                f"train_vit --init_from: logits differ from "
                f"load_encoder_into_vit's classifier: {handoff}")
        del ref, probe, seen
    for run in runs.values():
        add(run["by_head_dim"])
    emit("pretrain", entries={k: dict(
        cmd=r["cmd"], seconds=r["seconds"], step_losses=r["step_losses"],
        step_times=r["step_times"], valid=r["valid"],
        launches_by_head_dim=widths(r["by_head_dim"]), tail=r["lines"][-4:])
        for k, r in runs.items()}, handoff=handoff, card=card)
    torch.cuda.empty_cache()
    launches = {name: total[name][64] for name in HD32}
    launches.update({HD32[name]: total[name][32] for name in HD32})
    return summary, launches, fp32_d32


TATITOK_S = dict(image_size=256, patch_size=16, latent_tokens=256,
                 codebook_size=16384, latent_dim=12, transformer="small")
TATITOK_BS = 32          # train_tatitok.py's --bs
TATITOK_FP32_BS = 8      # the fp32 step's batch, cut from 32: its plain
                         # versions run on the card too
# TATiTok-S at image 256: S 513 in the encoder (256 patches, the class
# token, 256 latents) and the decoder; K1/K2 once a layer of each 8-layer
# stack; ConvNeXt-S as the flagship step's (K3 66, K4 33); K5 once
TATITOK_STEP_LAUNCHES = dict(STEP_LAUNCHES, attention_packed_fwd=16,
                             attention_packed_bwd=16)
# remat recomputes each block's forward in the backward: K1 again
TATITOK_REMAT = ("everything", "dots")
TATITOK_ENTRY = ("--dataset", "synthetic", "--no_wandb", "--image_size",
                 "256", "--perceptual_weights", "random", "--micro_steps",
                 "2", "--clustering_vq", "--log_every", "2")
TATITOK_PREEMPT_AT = 3
TATITOK_PRIOR = ("--dataset", "synthetic", "--no_wandb", "--latent_tokens",
                 "64", "--epochs", "1", "--steps_per_epoch", "2",
                 "--log_every", "1")


def tatitok_kernels(gen) -> dict:
    """(a) K5 at TATiTok-S's train step, N 8192 (32 × 256 latents) × C
    16384 × D 12 with L2 normalisation, held to fp64 scores by ``k5_hold``
    (its tuned D-12 form had been held on the card at C ≤ 2048 only), and
    K1 and K2 at its attention, (32, 513, 8 heads × 64) with a bias,
    within the limits of ``packed_kernels``; their times, bounds and
    library calls. Returns the kernels line's ``tatitok`` arm of each."""
    n, c = TATITOK_BS * 256, TATITOK_S["codebook_size"]
    k5 = k5_hold(n, c, 12, True, gen)
    z = torch.randn(n, 12, device="cuda", generator=gen)
    cb = (torch.rand(c, 12, device="cuda", generator=gen) * 2 - 1) / c
    k5_ms = median_ms(lambda: k_vq.nearest_code(z, cb, l2_normalize=True))
    k5_plain = median_ms(lambda: k_vq.nearest_code_ref(
        z, cb, l2_normalize=True), reps=5)
    k5_bound = bound(2 * n * c * 12, (n + c) * 12 * 4 + n * 4,
                     peak=PEAK_FP32_FLOPS)
    k1 = k1_row(TATITOK_BS, 513, 8, False, gen)
    k2 = k2_row(TATITOK_BS, 513, 8, False, gen)
    qkv = torch.randn(TATITOK_BS, 513, 3 * 512, device="cuda",
                      generator=gen).bfloat16()
    bias = torch.randn(3 * 512, device="cuda", generator=gen)
    dout = torch.randn(TATITOK_BS, 513, 512, device="cuda",
                       generator=gen).bfloat16()
    k1_ms = median_ms(lambda: k_attn.attention_packed_fwd(
        qkv, bias, 8, False, emit_stats=True))
    k1_plain = median_ms(lambda: k_attn.attention_packed_fwd_ref(
        qkv, bias, 8, False, emit_stats=True), reps=5)
    _, m, l = k_attn.attention_packed_fwd(qkv, bias, 8, False,
                                          emit_stats=True)
    k2_ms = median_ms(lambda: k_attn.attention_packed_bwd(
        qkv, bias, dout, m, l, 8, False))
    k2_plain = median_ms(lambda: k_attn.attention_packed_bwd_ref(
        qkv, bias, dout, m, l, 8, False), reps=5)
    heads = k_attn.split_heads(qkv, 8, bias)
    sdpa = median_ms(lambda: F.scaled_dot_product_attention(*heads))
    dh = dout.reshape(TATITOK_BS, 513, 8, 64).transpose(1, 2)
    sdpa_bwd = sdpa_backward_ms(*heads, dh, False)["backward_ms"]
    k1_bound = attention_bound(TATITOK_BS, 8, 513, False, False,
                               extra_bytes=3 * 512 * 4)
    k2_bound = attention_bound(TATITOK_BS, 8, 513, False, True,
                               extra_bytes=3 * 512 * 8)
    arms = {
        "vq_nearest": dict(shape=[n, c, 12], l2_normalize=True, parity=k5,
                           ms=k5_ms, plain_ms=k5_plain,
                           bound_ms=k5_bound["bound_ms"],
                           bound_by=k5_bound["bound_by"],
                           plan=k_vq.plan(n, c, 12, torch.cuda.
                                          get_device_properties(0)
                                          .multi_processor_count)),
        "attention_packed_fwd": dict(shape=[TATITOK_BS, 513, 8, 64],
                                     parity=k1, ms=k1_ms, plain_ms=k1_plain,
                                     bound_ms=k1_bound["bound_ms"],
                                     bound_by=k1_bound["bound_by"],
                                     library_ms=sdpa),
        "attention_packed_bwd": dict(shape=[TATITOK_BS, 513, 8, 64],
                                     parity=k2, ms=k2_ms, plain_ms=k2_plain,
                                     bound_ms=k2_bound["bound_ms"],
                                     bound_by=k2_bound["bound_by"],
                                     library_ms=sdpa_bwd)}
    emit("tatitok", part="kernels", arms=arms)
    del z, cb, qkv, bias, dout, m, l, heads, dh
    torch.cuda.empty_cache()
    return arms


@contextlib.contextmanager
def remat_switch(policy: "str | None"):
    """VIT_TPU_REMAT_POLICY set to ``policy`` (None: left as it is) for the
    block only."""
    saved = os.environ.get("VIT_TPU_REMAT_POLICY")
    if policy is not None:
        os.environ["VIT_TPU_REMAT_POLICY"] = policy
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("VIT_TPU_REMAT_POLICY", None)
        else:
            os.environ["VIT_TPU_REMAT_POLICY"] = saved


def tatitok_config(**kw):
    from vit_tpu_torch.models.tatitok import TATiTokConfig

    return TATiTokConfig(**{**TATITOK_S, **kw})


def tatitok_first_step(model, perceptual, images, policy=None) -> dict:
    """One step of the entry's optimizer from the model's weights, through
    the kernels, then from the same weights through the plain versions:
    launches, metrics, gradient norms and the step's peak memory."""
    from vit_tpu_torch.train.optim import wd_exclude_mask
    from vit_tpu_torch.train.step import make_tatitok_train_step

    def opt(m):
        return make_optimizer(1e-4, 10000, 1_000_000, 1e-5, 1e-4,
                              clip_norm=1.0, weight_decay_mask=wd_exclude_mask(
                                  list(m.named_parameters())))

    with remat_switch(policy):
        plain = copy.deepcopy(model)
        out = {}
        for name, m in (("kernels", model), ("plain", plain)):
            state = TrainState.create(m, opt(m))
            usage = torch.zeros(m.config.codebook_size, device="cuda")
            step = make_tatitok_train_step(m, perceptual_loss_fn=perceptual)
            ctx = contextlib.nullcontext if name == "kernels" else \
                plain_versions
            with ctx():
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                if name == "kernels":
                    reset_launches()   # the main path's run starts here
                _, _, metrics, recon = step(state, images, usage)
                torch.cuda.synchronize()
            out[name] = dict(
                metrics={k: v.item() for k, v in metrics.items()},
                grad_norm=state.opt_state.grad_norm.item(),
                peak_gb=torch.cuda.max_memory_allocated() / 2**30,
                finite=bool(torch.isfinite(recon).all()))
            if name == "kernels":
                out["launches"] = read_launches()
                out["step"], out["state"], out["usage"] = step, state, usage
        del plain
    return out


def tatitok_step(card: str) -> dict:
    """(b) One TATiTok-S step at train_tatitok.py's defaults (image 256,
    bs 32, the entry's masked AdamW) with the random ConvNeXt-S perceptual
    loss: launches (``TATITOK_STEP_LAUNCHES``), loss, perceptual loss and
    gradient norm against the plain versions from the same weights
    (``STEP_LOSS_REL``, ``STEP_GRAD_NORM_REL``); its CUDA-event median and
    peak memory, and the median at bs 16 (a micro-step of the entry's
    run); the same step under remat ("everything", "dots"): loss and
    gradient norm against the plain remat-off step within the same limits,
    K1 once more a layer, a lower peak and its median; an fp32 step
    (``--mixed false``) at bs ``TATITOK_FP32_BS``, cut from 32, every launch
    an fp32 form, within ``FP32_STEP_REL`` of its plain versions. Returns
    the launches of the first step."""
    from vit_tpu_torch.models.tatitok import TATiTok
    from vit_tpu_torch.utils.init import init_tatitok_

    model = TATiTok(tatitok_config())
    init_tatitok_(model, torch.Generator().manual_seed(0))
    weights = copy.deepcopy(model.state_dict())
    model = model.cuda().train()
    net = ConvNeXt(dtype=torch.bfloat16)
    init_convnext_(net, torch.Generator().manual_seed(1))
    perceptual = PerceptualLoss(net).cuda()
    images = torch.from_numpy(np.random.default_rng(2).uniform(
        0, 1, (TATITOK_BS, 256, 256, 3)).astype(np.float32)).cuda()

    def rel(a: dict, b: dict) -> dict:
        return {k: abs(x - y) / abs(y) for k, x, y in (
            ("train/loss", a["metrics"]["train/loss"],
             b["metrics"]["train/loss"]),
            ("train/perceptual_loss", a["metrics"]["train/perceptual_loss"],
             b["metrics"]["train/perceptual_loss"]),
            ("grad_norm", a["grad_norm"], b["grad_norm"]))}

    def ok(r: dict) -> bool:
        return (r["train/loss"] <= STEP_LOSS_REL
                and r["train/perceptual_loss"] <= STEP_LOSS_REL
                and r["grad_norm"] <= STEP_GRAD_NORM_REL)

    first = tatitok_first_step(model, perceptual, images)
    launches = first["launches"]
    r = rel(first["kernels"], first["plain"])
    step, state, usage = first.pop("step"), first.pop("state"), \
        first.pop("usage")
    torch.cuda.reset_peak_memory_stats()
    step_ms = median_ms(lambda: step(state, images, usage), reps=5)
    peak = torch.cuda.max_memory_allocated() / 2**30
    step16_ms = median_ms(lambda: step(state, images[:16], usage), reps=5)
    emit("tatitok", part="step", what="TATiTok-S, image 256, bs 32, first "
         "step kernels vs plain versions", card=card, launches=launches,
         kernels=first["kernels"], plain=first["plain"], rel_diff=r,
         step_ms=step_ms, images_per_s=TATITOK_BS / step_ms * 1e3,
         peak_gb=peak, step_bs16_ms=step16_ms,
         tolerance=dict(loss_rel=STEP_LOSS_REL,
                        grad_norm_rel=STEP_GRAD_NORM_REL))
    require(launches == TATITOK_STEP_LAUNCHES,
            f"TATiTok-S step launched {launches}, expected "
            f"{TATITOK_STEP_LAUNCHES}")
    require(first["kernels"]["finite"] and all(
        np.isfinite(v) for v in first["kernels"]["metrics"].values()),
        f"TATiTok-S step: non-finite {first['kernels']}")
    require(ok(r), f"TATiTok-S step, kernels vs plain versions: {r}")
    del step, state, usage, model
    torch.cuda.empty_cache()

    remat = {}
    for policy in TATITOK_REMAT:
        m = TATiTok(tatitok_config(remat=True))
        m.load_state_dict(weights)
        m = m.cuda().train()
        arm = tatitok_first_step(m, perceptual, images, policy)
        step, st, use = arm.pop("step"), arm.pop("state"), arm.pop("usage")
        with remat_switch(policy):
            ms = median_ms(lambda: step(st, images, use), reps=5)
        remat[policy] = dict(launches=arm["launches"],
                             kernels=arm["kernels"],
                             rel_diff_plain_no_remat=rel(arm["kernels"],
                                                         first["plain"]),
                             step_ms=ms,
                             peak_gb=arm["kernels"]["peak_gb"])
        del m, arm, step, st, use
        torch.cuda.empty_cache()
    emit("tatitok", part="remat", card=card, arms=remat,
         no_remat=dict(step_ms=step_ms,
                       first_step_peak_gb=first["kernels"]["peak_gb"]))
    for policy, arm in remat.items():
        require(arm["launches"] == dict(
            TATITOK_STEP_LAUNCHES, attention_packed_fwd=32),
            f"remat {policy}: launched {arm['launches']}")
        require(ok(arm["rel_diff_plain_no_remat"]),
                f"remat {policy} vs the plain remat-off step: {arm}")
        require(arm["peak_gb"] < first["kernels"]["peak_gb"],
                f"remat {policy}: peak {arm['peak_gb']} GB not below "
                f"{first['kernels']['peak_gb']} GB")

    m = TATiTok(tatitok_config(dtype=torch.float32))
    m.load_state_dict(weights)
    m = m.cuda().train()
    net32 = ConvNeXt(dtype=torch.float32)
    net32.load_state_dict(net.state_dict())
    fp32 = tatitok_first_step(m, PerceptualLoss(net32).cuda(),
                              images[:TATITOK_FP32_BS])
    got32 = read_fp32_launches()
    r32 = rel(fp32["kernels"], fp32["plain"])
    emit("tatitok", part="fp32", what=f"TATiTok-S fp32 step at bs "
         f"{TATITOK_FP32_BS} (cut from {TATITOK_BS})", card=card,
         launches=fp32["launches"], fp32_launches=got32,
         kernels=fp32["kernels"], plain=fp32["plain"], rel_diff=r32,
         tolerance=dict(rel=FP32_STEP_REL))
    require(not [k for k, v in fp32["launches"].items()
                 if v and got32.get(k) != v],
            f"fp32 TATiTok step: launches that were not fp32 forms: "
            f"{fp32['launches']} vs {got32}")
    require(all(v <= FP32_STEP_REL for v in r32.values()),
            f"fp32 TATiTok step vs plain versions: {r32}")
    for k, v in fp32["launches"].items():
        launches[k] += v
    del m, fp32, net, net32, perceptual, images, weights
    torch.cuda.empty_cache()
    return launches


def tatitok_steps(lines: list) -> "list[tuple[int, float, float]]":
    """(s, loss, step_time) of each step line of the train_tatitok entry."""
    out = []
    for line in lines:
        mt = re.match(r"e=\d+ s=(\d+) loss=(\S+) recon=\S+ quant=\S+ "
                      r"usage=\S+ step_time=(\S+)", line)
        if mt:
            out.append((int(mt.group(1)), float(mt.group(2)),
                        float(mt.group(3))))
    return out


def run_tatitok_main(*flags: str, kill_at: "int | None" = None,
                     seen: "dict | None" = None) -> dict:
    """``vit_tpu_torch.train_tatitok.main(flags)`` in this process, its
    output captured, the kernels' launch counts set to 0 just before it and
    read just after; SIGTERM to this process during train step ``kill_at``
    (counted from 1); ``seen`` gets the clustering usage EMA the step
    starts from."""
    import vit_tpu_torch.train_tatitok as tt

    factory = tt.make_tatitok_train_step

    def make(model, **kw):
        step = factory(model, **kw)
        calls = [0]
        if seen is not None and model.config.clustering_vq:
            seen["embed_prob"] = model.quantize.embed_prob.clone()

        def hooked(*args):
            calls[0] += 1
            if calls[0] == kill_at:
                os.kill(os.getpid(), signal.SIGTERM)
            return step(*args)

        return hooked

    buf = io.StringIO()
    prev = signal.getsignal(signal.SIGTERM)
    t0 = time.perf_counter()
    reset_launches()
    tt.make_tatitok_train_step = make
    try:
        with contextlib.redirect_stdout(buf):
            state = tt.main(list(flags))
        torch.cuda.synchronize()
    finally:
        tt.make_tatitok_train_step = factory
        signal.signal(signal.SIGTERM, prev)
    lines = buf.getvalue().splitlines()
    run = dict(cmd="-m vit_tpu_torch.train_tatitok " + " ".join(flags),
               seconds=time.perf_counter() - t0, lines=lines,
               steps=tatitok_steps(lines), launches=read_launches(),
               state=state)
    require(run["steps"] and all(np.isfinite(l) for _, l, _ in run["steps"]),
            f"train_tatitok's step lines: {lines[-30:]}")
    torch.cuda.empty_cache()
    return run


def tatitok_entry(work: Path) -> dict:
    """(c) ``python -m vit_tpu_torch.train_tatitok`` on the synthetic
    stream at image 256 (bs 32 in two micro-steps of 16,
    ``--clustering_vq``, the random perceptual loss, a log every 2 steps):
    SIGTERM during micro-step ``TATITOK_PREEMPT_AT`` (inside an
    accumulation) saves "last" at that step with the usage EMA; ``--resume``
    continues from it with that EMA to step 6. Returns both runs'
    launches."""
    ckpt = work / "tatitok"
    common = (*TATITOK_ENTRY, "--ckpt_dir", str(ckpt), "--run_dir",
              str(work / "runs"))
    cut = run_tatitok_main(*common, "--steps_per_epoch", "100000",
                           kill_at=TATITOK_PREEMPT_AT)
    require(any(line.startswith(f"PREEMPTED: saving 'last' at step "
                                f"{TATITOK_PREEMPT_AT}")
                for line in cut["lines"]),
            f"train_tatitok did not save at the SIGTERM: {cut['lines'][-6:]}")
    saved = torch.load(ckpt / "last" / "state.pt", map_location="cpu",
                       weights_only=True)
    prob = saved["extra"]["vq_stats"]["embed_prob"]
    mini = int(saved["opt_state"]["mini_step"])
    seen: dict = {}
    resumed = run_tatitok_main(*common, "--steps_per_epoch", "6",
                               "--epochs", "1", "--resume", seen=seen)
    require(any(line.startswith(f"RESUMED at step {TATITOK_PREEMPT_AT}")
                for line in resumed["lines"]),
            f"train_tatitok --resume: {resumed['lines'][:6]}")
    require(bool(torch.equal(seen["embed_prob"].cpu(), prob)),
            "train_tatitok --resume did not restore the usage EMA")
    require(int(resumed["state"].step) == 6
            and resumed["state"].opt_state.mini_step == 0,
            f"train_tatitok --resume ended at step "
            f"{int(resumed['state'].step)}")
    for run in (cut, resumed):
        require_launched(run, ("attention_packed_fwd", "attention_packed_bwd",
                               "convnext_tail_fwd", "convnext_tail_bwd",
                               "vq_nearest"))
    emit("tatitok", part="entry", saved_step=int(saved["step"]),
         saved_mini_step=mini, usage_ema_sum=float(prob.sum()),
         runs={k: dict(cmd=r["cmd"], seconds=r["seconds"],
                       steps=r["steps"], tail=r["lines"][-4:],
                       launches={n: v for n, v in r["launches"].items()
                                 if v})
               for k, r in (("cut", cut), ("resumed", resumed))})
    return {n: cut["launches"][n] + resumed["launches"][n]
            for n in cut["launches"]}


def tatitok_prior(work: Path) -> dict:
    """(d) A TATiTok-S at image 64 with 64 latent tokens (2 entry steps),
    then ``train_videogpt --tokenizer_ckpt`` that directory for 2 steps:
    VideoGPT-B at its default S 1024 (16 frames × 64 codes) over codebook
    16384; (e) a Bytedance folder written from that tokenizer's weights,
    whose ``load_tokenizer`` (fp32, from its config.yaml) gives the codes
    of a direct fp32 ``encode`` of the same weights; without PyYAML, the
    refusal naming it. Returns the runs' launches."""
    from vit_tpu_torch.models.pretrained import (load_tokenizer,
                                                 write_bytedance_folder)
    from vit_tpu_torch.models.tatitok import TATiTok

    tok_dir = work / "tatitok64"
    tok_run = run_tatitok_main(*TATITOK_PRIOR, "--ckpt_dir", str(tok_dir),
                               "--run_dir", str(work / "runs"))
    gpt = run_videogpt_main(
        *GPT_ENTRY, "--tokenizer_ckpt", str(tok_dir), "--epochs", "1",
        "--steps_per_epoch", "2", "--condition_frames", "15", "--ckpt_dir",
        str(work / "gpt_tatitok"), "--run_dir", str(work / "runs"))
    cfg = gpt["state"].params[0].shape[0]   # tok_embed: codes + SOS
    require(cfg == 16384 + 1, f"the prior's vocabulary is {cfg - 1}")
    require_launched(gpt, ("attention_packed_fwd", "vq_nearest",
                           "attention_fwd", "attention_bwd"))
    tok = load_tokenizer(str(tok_dir), torch.bfloat16, "cuda")
    folder = write_bytedance_folder(tok.model, work / "oned_tokenizer")
    frames = torch.from_numpy(np.random.default_rng(5).uniform(
        0, 1, (64, 64, 64, 3)).astype(np.float32)).cuda()
    reset_launches()
    try:
        loaded = load_tokenizer(str(folder), torch.bfloat16, "cuda")
    except NotImplementedError as e:
        require("PyYAML" in str(e), f"the Bytedance refusal: {e}")
        bytedance = dict(pyyaml=False, refusal=str(e))
        print("tatitok: no PyYAML here; the Bytedance folder is refused "
              "naming it", flush=True)
    else:
        codes = loaded.encode_indices(frames)
        direct = TATiTok(tatitok_config(**{
            k: getattr(tok.model.config, k) for k in TATITOK_S},
            dtype=torch.float32))
        direct.load_state_dict(tok.model.state_dict())
        with torch.no_grad():
            want = direct.cuda().eval().encode(frames)[1][
                "min_encoding_indices"]
        bytedance = dict(pyyaml=True, dtype=str(loaded.model.config.dtype),
                         codes_equal=bool(torch.equal(codes, want)))
        require(bytedance["codes_equal"],
                "the Bytedance folder's codes differ from a direct encode")
    byte_launches = read_launches()
    emit("tatitok", part="prior", tokenizer=dict(
        cmd=tok_run["cmd"], seconds=tok_run["seconds"],
        steps=tok_run["steps"]), videogpt=dict(
        cmd=gpt["cmd"], seconds=gpt["seconds"], steps=gpt["steps"],
        launches={n: v for n, v in gpt["launches"].items() if v}),
        bytedance=bytedance)
    return {n: tok_run["launches"][n] + gpt["launches"][n]
            + byte_launches[n] for n in gpt["launches"]}


def phase_tatitok(card: str) -> "tuple[dict, dict]":
    """The Bytedance stack: (a) the kernels at TATiTok-S's shapes, (b) its
    train step with and without remat and in fp32, (c) the train_tatitok
    entry across a SIGTERM and ``--resume``, (d) VideoGPT-B over a TATiTok
    tokenizer and (e) a Bytedance folder. Returns the kernels line's
    ``tatitok`` arms and the paths' launches."""
    t0 = time.perf_counter()
    arms = tatitok_kernels(torch.Generator(device="cuda").manual_seed(23))
    launches = tatitok_step(card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tatitok_") as tmp:
        for more in (tatitok_entry(Path(tmp)), tatitok_prior(Path(tmp))):
            for n, v in more.items():
                launches[n] += v
    emit("tatitok", part="done", seconds=time.perf_counter() - t0,
         launches=launches)
    return arms, launches


# ViT-VQGAN-B and the enhancing ViT-VQGAN at train_vit_vqgan.py's and
# train_enhancing_vitvqgan.py's defaults: image 128, patch 16, one latent a
# patch (S 64 in the encoder and the decoder, no extra token), codebook
# 2048 × 12, bs 32. Each step launches K1/K2 once a layer of its two
# 12-layer stacks (the enhancing QKV without a bias), ConvNeXt-S's K3 66
# and K4 33 times, K5 once: the flagship step's counts.
VQGAN_B = dict(image_size=128, patch_size=16, codebook_size=2048,
               latent_dim=12)
FAMILY_BS = 32
FAMILY_STEP_LAUNCHES = STEP_LAUNCHES
# LlamaGen-TiTok-S at train_llamagen_titok.py's defaults: 256 codes in, 256
# latents, S 512 in both 6-layer stacks (8 heads × 64), codebook 16384 × 12
# (K5 at N 8192), CE over 16384 codes; LlamaGen VQ-16 encodes 32 images of
# 256 into 8192 latents of 8 against its 16384 codes.
LLAMAGEN_ENTRY = ("--dataset", "synthetic", "--no_wandb", "--log_every", "2")
LLAMAGEN_PREEMPT_AT = 2
VQ16_CODES = (FAMILY_BS * 256, 16384, 8)


def families_kernels(gen) -> dict:
    """(a) K1 and K2 at the families' attention, against their plain
    versions within ``packed_kernels``' limits: (32, 64, 12 heads × 64) with
    a bias (ViT-VQGAN) and without (the enhancing QKV), and (32, 512, 8 ×
    64) with a bias (LlamaGen-TiTok-S); K5 at LlamaGen VQ-16's encode, N
    8192 × C 16384 × D 8 with L2 normalisation (its tuned D-8 form had been
    held at C ≤ 2048 only), by ``k5_hold``. Their times beside their bounds,
    the plain versions and SDPA. Returns the kernels line's ``families``
    arm of each."""
    k1_rows = [k1_row(FAMILY_BS, s, h, False, gen, biased)
               for s, h, biased in ((64, 12, True), (64, 12, False),
                                    (512, 8, True))]
    k2_rows = [k2_row(FAMILY_BS, s, h, False, gen, biased)
               for s, h, biased in ((64, 12, True), (64, 12, False),
                                    (512, 8, True))]
    n, c, d = VQ16_CODES
    k5 = k5_hold(n, c, d, True, gen)
    z = torch.randn(n, d, device="cuda", generator=gen)
    cb = torch.randn(c, d, device="cuda", generator=gen)
    k5_bound = bound(2 * n * c * d, (n + c) * d * 4 + n * 4,
                     peak=PEAK_FP32_FLOPS)
    vq = dict(shape=[n, c, d], l2_normalize=True, parity=k5,
              ms=median_ms(lambda: k_vq.nearest_code(z, cb)),
              dev_ms=device_ms(lambda: k_vq.nearest_code(z, cb)),
              plain_ms=median_ms(lambda: k_vq.nearest_code_ref(z, cb),
                                 reps=5),
              bound_ms=k5_bound["bound_ms"], bound_by=k5_bound["bound_by"],
              plan=k_vq.plan(n, c, d, torch.cuda.get_device_properties(0)
                             .multi_processor_count))
    fwd, bwd = {}, {}
    for s, h in ((64, 12), (512, 8)):
        width = h * 64
        qkv = torch.randn(FAMILY_BS, s, 3 * width, device="cuda",
                          generator=gen).bfloat16()
        bias = torch.zeros(3 * width, device="cuda") if s == 64 else \
            torch.randn(3 * width, device="cuda", generator=gen)
        dout = torch.randn(FAMILY_BS, s, width, device="cuda",
                           generator=gen).bfloat16()
        _, m, l = k_attn.attention_packed_fwd(qkv, bias, h, False,
                                              emit_stats=True)
        heads = k_attn.split_heads(qkv, h, bias)
        dh = dout.reshape(FAMILY_BS, s, h, 64).transpose(1, 2)
        b1 = attention_bound(FAMILY_BS, h, s, False, False,
                             extra_bytes=3 * width * 4)
        b2 = attention_bound(FAMILY_BS, h, s, False, True,
                             extra_bytes=3 * width * 8)
        key = f"S{s}"

        def k1():
            return k_attn.attention_packed_fwd(qkv, bias, h, False,
                                               emit_stats=True)

        def k2():
            return k_attn.attention_packed_bwd(qkv, bias, dout, m, l, h,
                                               False)

        def sdpa():
            return F.scaled_dot_product_attention(*heads)

        # single calls' events include the wrapper's host time, which at S
        # 64 is most of a call: "dev_ms" times the card alone
        fwd[key] = dict(
            shape=[FAMILY_BS, s, h, 64], biased=s != 64, ms=median_ms(k1),
            dev_ms=device_ms(k1),
            plain_ms=median_ms(lambda: k_attn.attention_packed_fwd_ref(
                qkv, bias, h, False, emit_stats=True), reps=5),
            bound_ms=b1["bound_ms"], bound_by=b1["bound_by"],
            library_ms=median_ms(sdpa), library_dev_ms=device_ms(sdpa))
        bwd[key] = dict(
            shape=[FAMILY_BS, s, h, 64], biased=s != 64, ms=median_ms(k2),
            dev_ms=device_ms(k2),
            plain_ms=median_ms(lambda: k_attn.attention_packed_bwd_ref(
                qkv, bias, dout, m, l, h, False), reps=5),
            bound_ms=b2["bound_ms"], bound_by=b2["bound_by"],
            library_ms=sdpa_backward_ms(*heads, dh, False)["backward_ms"])
    fwd["parity"], bwd["parity"] = k1_rows, k2_rows
    arms = {"attention_packed_fwd": fwd, "attention_packed_bwd": bwd,
            "vq_nearest": vq}
    emit("families", part="kernels", arms=arms)
    del z, cb, qkv, bias, dout, m, l, heads, dh
    torch.cuda.empty_cache()
    return arms


def family_first_step(model, perceptual, images) -> dict:
    """One L1 tokenizer step (the ViT-VQGAN entries' optimizer) from the
    model's weights through the kernels, then from the same weights
    through the plain versions: launches, metrics, gradient norms, the
    step's peak memory; the kernels' step, state and usage for timing."""
    plain = copy.deepcopy(model)
    out = {}
    for name, m in (("kernels", model), ("plain", plain)):
        state = TrainState.create(m, make_optimizer(
            1e-4, 5000, 500_000, 1e-5, 1e-4, clip_norm=1.0))
        usage = torch.zeros(m.config.codebook_size, device="cuda")
        step = make_tokenizer_train_step(m, perceptual_loss_fn=perceptual,
                                         pixel_loss="l1")
        ctx = contextlib.nullcontext if name == "kernels" else plain_versions
        with ctx():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            if name == "kernels":
                reset_launches()   # the main path's run starts here
            _, _, metrics, recon = step(state, images, usage)
            torch.cuda.synchronize()
        out[name] = dict(
            metrics={k: v.item() for k, v in metrics.items()},
            grad_norm=state.opt_state.grad_norm.item(),
            peak_gb=torch.cuda.max_memory_allocated() / 2**30,
            finite=bool(torch.isfinite(recon).all()))
        if name == "kernels":
            out["launches"] = read_launches()
            out["step"], out["state"], out["usage"] = step, state, usage
    del plain
    return out


def family_step(card: str, name: str, model, perceptual, images,
                profiled: bool = False) -> dict:
    """(b, c) The first step of ``model`` against the plain versions: loss,
    perceptual loss and gradient norm within ``STEP_LOSS_REL`` and
    ``STEP_GRAD_NORM_REL``, launches ``FAMILY_STEP_LAUNCHES``; then its
    CUDA-event median and peak memory, and with ``profiled`` one step under
    ``torch.profiler`` (its busy time and idle share; reading back a
    step's ~10k kernels takes the profiler about ten seconds). Returns the
    launches."""
    first = family_first_step(model, perceptual, images)
    k, p = first["kernels"], first["plain"]
    r = {key: abs(a - b) / abs(b) for key, a, b in (
        ("train/loss", k["metrics"]["train/loss"], p["metrics"]["train/loss"]),
        ("train/perceptual_loss", k["metrics"]["train/perceptual_loss"],
         p["metrics"]["train/perceptual_loss"]),
        ("grad_norm", k["grad_norm"], p["grad_norm"]))}
    step, state, usage = first.pop("step"), first.pop("state"), \
        first.pop("usage")
    torch.cuda.reset_peak_memory_stats()
    step_ms = median_ms(lambda: step(state, images, usage), reps=5)
    peak = torch.cuda.max_memory_allocated() / 2**30
    emit("families", part=f"{name}_step", what=f"{name}, image 128, bs 32, "
         "first step kernels vs plain versions", card=card,
         launches=first["launches"], kernels=k, plain=p, rel_diff=r,
         step_ms=step_ms, images_per_s=FAMILY_BS / step_ms * 1e3,
         peak_gb=peak, profile=(profile_window(
             lambda: step(state, images, usage)) if profiled else None),
         tolerance=dict(loss_rel=STEP_LOSS_REL,
                        grad_norm_rel=STEP_GRAD_NORM_REL))
    require(first["launches"] == FAMILY_STEP_LAUNCHES,
            f"{name} step launched {first['launches']}, expected "
            f"{FAMILY_STEP_LAUNCHES}")
    require(k["finite"] and all(np.isfinite(v)
                                for v in k["metrics"].values()),
            f"{name} step: non-finite {k}")
    require(r["train/loss"] <= STEP_LOSS_REL
            and r["train/perceptual_loss"] <= STEP_LOSS_REL
            and r["grad_norm"] <= STEP_GRAD_NORM_REL,
            f"{name} step, kernels vs plain versions: {r}")
    del step, state, usage
    torch.cuda.empty_cache()
    return first["launches"]


def family_steps(lines: list) -> "list[tuple[int, float, float]]":
    """(step, loss, step_time) of each step line of the ViT-VQGAN loop
    (``e=.. i=..``) or of train_llamagen_titok (``e=.. s=..``)."""
    out = []
    for line in lines:
        mt = re.match(r"e=\d+ [is]=(\d+) loss=(\S+) .*step_time=(\S+)", line)
        if mt:
            out.append((int(mt.group(1)), float(mt.group(2)),
                        float(mt.group(3))))
    return out


def run_family_main(module: str, *flags: str,
                    kill_at: "int | None" = None) -> dict:
    """``vit_tpu_torch.<module>.main(flags)`` in this process, its output
    captured, the kernels' launch counts set to 0 just before it and read
    just after; with ``kill_at``, SIGTERM to this process during
    train_llamagen_titok's train step ``kill_at`` (counted from 1)."""
    import importlib

    mod = importlib.import_module(f"vit_tpu_torch.{module}")
    factory = getattr(mod, "make_llamagen_titok_train_step", None)
    if kill_at is not None:
        def make(model, **kw):
            step = factory(model, **kw)
            calls = [0]

            def hooked(*args):
                calls[0] += 1
                if calls[0] == kill_at:
                    os.kill(os.getpid(), signal.SIGTERM)
                return step(*args)

            return hooked

        mod.make_llamagen_titok_train_step = make
    buf = io.StringIO()
    prev = signal.getsignal(signal.SIGTERM)
    t0 = time.perf_counter()
    reset_launches()
    try:
        with contextlib.redirect_stdout(buf):
            state = mod.main(list(flags))
        torch.cuda.synchronize()
    finally:
        if kill_at is not None:
            mod.make_llamagen_titok_train_step = factory
        signal.signal(signal.SIGTERM, prev)
    lines = buf.getvalue().splitlines()
    run = dict(cmd=f"-m vit_tpu_torch.{module} " + " ".join(flags),
               seconds=time.perf_counter() - t0, lines=lines,
               steps=family_steps(lines), launches=read_launches(),
               state=state)
    require(run["steps"] and all(np.isfinite(l) for _, l, _ in run["steps"]),
            f"{module}'s step lines: {lines[-30:]}")
    torch.cuda.empty_cache()
    return run


def families_entries(work: Path) -> dict:
    """(d) ``python -m vit_tpu_torch.train_vit_vqgan`` at its defaults
    (ViT-VQGAN-B, image 128, bs 32, --dataset imagenet) on the JPEG
    fixtures, 3 steps, writing "best"; (e) ``python -m
    vit_tpu_torch.train_llamagen_titok`` at its defaults (LlamaGen-TiTok-S)
    over (e.a) synthetic codes across a SIGTERM at step
    ``LLAMAGEN_PREEMPT_AT`` and ``--resume`` to step 4, (e.b) (d)'s
    checkpoint (its 64 codes of 2048, synthetic images of 128) and (e.c) a
    LlamaGen VQ-16 ``.pt`` in LlamaGen's layout from random weights (256
    codes of 16384 from images of 256), each decoding true and predicted
    codes at its first step; (f) that VQ's codes through K5 against the
    plain version on the same latents, judged by ``k5_judge``. Returns the
    runs' launches."""
    from vit_tpu_torch.models.llamagen_vq import (LlamaGenVQ,
                                                  llamagen_state_dict,
                                                  load_llamagen_vq,
                                                  vq16_config)
    from vit_tpu_torch.utils.init import init_llamagen_vq_

    runs = {}
    jpegs = write_jpegs(work / "jpegs")
    vq_dir = work / "vit_vqgan"
    runs["vit_vqgan"] = run_family_main(
        "train_vit_vqgan", "--data_dir", str(jpegs / "imagenet"),
        "--no_wandb", "--log_every", "1", "--epochs", "1",
        "--max_epoch_steps", "3", "--ckpt_dir", str(vq_dir), "--run_dir",
        str(work / "runs"))
    require((vq_dir / "best" / "state.pt").exists()
            and (vq_dir / "best_config.json").exists(),
            "train_vit_vqgan wrote no 'best' checkpoint")
    ckpt = work / "llamagen"
    common = (*LLAMAGEN_ENTRY, "--run_dir", str(work / "runs"))
    runs["codes_cut"] = run_family_main(
        "train_llamagen_titok", *common, "--ckpt_dir", str(ckpt),
        "--steps_per_epoch", "100000", kill_at=LLAMAGEN_PREEMPT_AT)
    require(any(line.startswith(f"PREEMPTED: saving 'last' at step "
                                f"{LLAMAGEN_PREEMPT_AT}")
                for line in runs["codes_cut"]["lines"]),
            f"train_llamagen_titok did not save at the SIGTERM: "
            f"{runs['codes_cut']['lines'][-6:]}")
    runs["codes_resumed"] = run_family_main(
        "train_llamagen_titok", *common, "--ckpt_dir", str(ckpt),
        "--steps_per_epoch", "4", "--epochs", "1", "--resume")
    require(any(line.startswith(f"RESUMED at step {LLAMAGEN_PREEMPT_AT}")
                for line in runs["codes_resumed"]["lines"])
            and int(runs["codes_resumed"]["state"].step) == 4,
            f"train_llamagen_titok --resume: "
            f"{runs['codes_resumed']['lines'][:6]}")
    runs["vit_vqgan_codes"] = run_family_main(
        "train_llamagen_titok", *common, "--vq_ckpt", str(vq_dir),
        "--vq_latent_tokens", "64", "--vq_codebook_size", "2048",
        "--steps_per_epoch", "2", "--epochs", "1", "--image_every", "1",
        "--ckpt_dir", str(work / "llamagen_vq"))
    vq = LlamaGenVQ(vq16_config())
    init_llamagen_vq_(vq, torch.Generator().manual_seed(3))
    pt = work / "vq_ds16_c2i.pt"
    torch.save({"model": llamagen_state_dict(vq)}, pt)
    del vq
    runs["llamagen_codes"] = run_family_main(
        "train_llamagen_titok", *common, "--vq_ckpt", str(pt),
        "--steps_per_epoch", "2", "--epochs", "1", "--image_every", "1",
        "--ckpt_dir", str(work / "llamagen_pt"))
    for run in runs.values():
        require_launched(run, ("attention_packed_fwd", "attention_packed_bwd",
                               "vq_nearest"))

    vq = load_llamagen_vq(str(pt), "cuda")
    images = torch.from_numpy(np.random.default_rng(5).uniform(
        0, 1, (FAMILY_BS, 256, 256, 3)).astype(np.float32)).cuda()
    with torch.no_grad():
        z = vq.quant_conv(vq.encoder(images.permute(0, 3, 1, 2)))
        z = z.permute(0, 2, 3, 1).reshape(-1, 8).contiguous()
        codes = k5_judge(z, vq.codebook, True)
        same = bool(torch.equal(vq.encode(images).reshape(-1),
                                k_vq.nearest_code(z, vq.codebook)))
        encode_ms = median_ms(lambda: vq.encode(images), reps=3)
    require(same, "LlamaGen VQ-16's encode differs from K5 on its latents")
    emit("families", part="entries", codes=dict(
        vq16_encode=codes, encode_equals_k5=same, encode_bs32_ms=encode_ms),
         runs={k: dict(cmd=r["cmd"], seconds=r["seconds"], steps=r["steps"],
                       tail=r["lines"][-4:],
                       launches={n: v for n, v in r["launches"].items()
                                 if v})
               for k, r in runs.items()})
    del vq, images, z
    torch.cuda.empty_cache()
    out = {}
    for run in runs.values():
        for n, v in run["launches"].items():
            out[n] = out.get(n, 0) + v
    return out


def phase_families(card: str) -> "tuple[dict, dict]":
    """The other tokenizer families: (a) the kernels at their shapes, (b)
    a ViT-VQGAN-B and (c) an enhancing ViT-VQGAN step against the plain
    versions, (d) the train_vit_vqgan entry, (e) train_llamagen_titok over
    its three code sources and (f) VQ-16's codes. Returns the kernels
    line's ``families`` arms and the paths' launches."""
    from vit_tpu_torch.models.enhancing_vqgan import (EnhancingViTVQGAN,
                                                      EnhancingVQGANConfig)
    from vit_tpu_torch.models.vit_vqgan import ViTVQGAN, ViTVQGANConfig
    from vit_tpu_torch.utils.init import init_enhancing_

    t0 = time.perf_counter()
    arms = families_kernels(torch.Generator(device="cuda").manual_seed(24))
    net = ConvNeXt(dtype=torch.bfloat16)
    init_convnext_(net, torch.Generator().manual_seed(1))
    perceptual = PerceptualLoss(net).cuda()
    images = torch.from_numpy(np.random.default_rng(2).uniform(
        0, 1, (FAMILY_BS, 128, 128, 3)).astype(np.float32)).cuda()
    launches = {}
    for name, build, init in (
            ("vit_vqgan_b", lambda: ViTVQGAN(ViTVQGANConfig(
                **VQGAN_B, transformer="B")), init_params_),
            ("enhancing", lambda: EnhancingViTVQGAN(EnhancingVQGANConfig(
                **VQGAN_B)), init_enhancing_)):
        model = build()
        init(model, torch.Generator().manual_seed(0))
        model = model.cuda().train()
        for n, v in family_step(card, name, model, perceptual, images,
                                profiled=name == "vit_vqgan_b").items():
            launches[n] = launches.get(n, 0) + v
        del model
        torch.cuda.empty_cache()
    del net, perceptual, images
    with tempfile.TemporaryDirectory(prefix="chip_smoke_families_") as tmp:
        for n, v in families_entries(Path(tmp)).items():
            launches[n] = launches.get(n, 0) + v
    emit("families", part="done", seconds=time.perf_counter() - t0,
         launches=launches)
    return arms, launches

# The serve_export phase: every family exported through the CLI from a
# checkpoint it writes at random init, served over HTTP and held against a
# direct call of the live model (the int8 twin for an int8 export). The
# fidelity fields of an int8 tokenizer within the JAX test's bounds
# (tests/test_quant.py:157-164).
SERVE_MIN_AGREEMENT, SERVE_MIN_PSNR_DB = 0.5, 20.0
SERVE_FAMILY_BS = 2
VIT_L_CLASSIFIER = (256, 16, "L", 0.15)   # train_vit.py's defaults
# the other families at their entries' defaults
SERVE_FAMILIES = {
    "vit_vqgan": dict(VQGAN_B, transformer="B"),
    "enhancing": dict(VQGAN_B),
    "tatitok": dict(image_size=64, patch_size=16, latent_tokens=256,
                    codebook_size=16384, latent_dim=12, transformer="small"),
    "llamagen_titok": dict(vq_codebook_size=16384, vq_latent_tokens=256,
                           latent_tokens=256, codebook_size=16384,
                           latent_dim=12, transformer="S"),
}


def write_checkpoint(directory: Path, model, config) -> Path:
    """``model``'s weights as a "best" checkpoint (``Checkpointer.save`` of
    a fresh ``TrainState``), as a training run writes it."""
    Checkpointer(str(directory)).save(
        TrainState.create(model, make_optimizer(1e-4, 1, 10, 1e-5, 0.0)),
        config=config, tag="best")
    return directory


def cli_export(ckpt: Path, out: Path, model: str, *flags: str) -> dict:
    """``python -m vit_tpu_torch.export_tokenizer``'s ``main`` on the card;
    returns the manifest."""
    from vit_tpu_torch.export_tokenizer import main as export_main

    with contextlib.redirect_stdout(io.StringIO()):
        export_main(["--ckpt", str(ckpt), "--out", str(out), "--model",
                     model, "--device", "cuda", *flags])
    return json.loads((out / "manifest.json").read_text())


def require_fidelity(manifest: dict, what: str) -> dict:
    fields = {k: v for k, v in manifest.items() if k.startswith("quant_")}
    require(fields.get("quant_encode_index_agreement", 0)
            > SERVE_MIN_AGREEMENT, f"{what}: {fields}")
    if manifest["model"] == "llamagen_titok":
        require(fields.get("quant_decode_logit_argmax_agreement", 0)
                > SERVE_MIN_AGREEMENT, f"{what}: {fields}")
    else:
        require(fields.get("quant_decode_psnr_db_vs_fp", 0)
                > SERVE_MIN_PSNR_DB, f"{what}: {fields}")
    return fields


def launched() -> dict:
    """``read_launches()``'s kernels that launched."""
    return {k: v for k, v in read_launches().items() if v}


def add_launches(total: dict, more: dict) -> dict:
    for k, v in more.items():
        total[k] = total.get(k, 0) + v
    return total


def serve_tokenizer(url: str, live, name: str, x: np.ndarray,
                    what: str) -> dict:
    """/encode then /decode of ``x`` over HTTP against the live model's
    encode and decode on the same rows; returns the requests' launches
    and the codes."""
    from vit_tpu_torch.serve.export import _codec

    enc, dec = _codec(live, name)
    reset_launches()
    idx = post(url + "/encode", x)
    rec = post(url + "/decode", idx)
    launches = launched()
    with torch.inference_mode():
        want_idx = enc(torch.from_numpy(x).cuda()).cpu().numpy()
        want_rec = dec(torch.from_numpy(idx).cuda()).float().cpu().numpy()
    require(np.array_equal(idx, want_idx),
            f"{what}: served codes differ from the live model's")
    require(np.array_equal(rec, want_rec),
            f"{what}: served decode differs from the live model's")
    require(bool(np.isfinite(rec).all()), f"{what}: decode not finite")
    require(launches.get("attention_packed_fwd", 0) > 0
            and launches.get("vq_nearest", 0) > 0,
            f"{what}: K1 or K5 never launched: {launches}")
    return dict(launches=launches, codes=idx)


def http_times(url: str, x: np.ndarray, idx: np.ndarray) -> dict:
    """Median latencies of /encode of ``x`` and /decode of ``idx``."""
    row = dict(encode_ms=host_median_ms(lambda: post(url + "/encode", x),
                                        reps=3),
               decode_ms=host_median_ms(lambda: post(url + "/decode", idx),
                                        reps=3))
    row["encode_decode_images_per_s"] = len(x) / (
        row["encode_ms"] + row["decode_ms"]) * 1e3
    return row


def phase_serve_export(card: str) -> dict:
    """``python -m vit_tpu_torch.export_tokenizer`` from checkpoints of
    random weights, each export served over HTTP and held against the
    live model (or, for the classifier, held to the fp model's top-1):
    TiTok-B at the flagship width fp and int8 (``--bs 0``), requests of 8
    and 64 images (timed in turns), the classifier (ViT-L/16 @256) int8,
    VideoGPT-B's greedy rollout at bs 1 fp and int8 (timed), and ViT-VQGAN-B,
    TATiTok-S and LlamaGen-TiTok-S int8 and the enhancing ViT-VQGAN fp at
    their entries' defaults; the int8 tokenizers' fidelity fields; K1, K5
    and K6 launched on the int8 paths; the fp and int8 ``weights.npz``
    sizes. Returns the served requests' launches."""
    from vit_tpu_torch.models.enhancing_vqgan import (EnhancingViTVQGAN,
                                                      EnhancingVQGANConfig)
    from vit_tpu_torch.models.llamagen_titok import (LlamaGenTiTok,
                                                     LlamaGenTiTokConfig)
    from vit_tpu_torch.models.tatitok import TATiTok, TATiTokConfig
    from vit_tpu_torch.models.vit_vqgan import ViTVQGAN, ViTVQGANConfig
    from vit_tpu_torch.serve.export import _quantized
    from vit_tpu_torch.utils.init import (init_enhancing_,
                                          init_llamagen_titok_,
                                          init_tatitok_)

    t0 = time.perf_counter()
    rng = np.random.default_rng(25)
    launches, sizes, fidelity, parts = {}, {}, {}, {}

    def build(cls, cfg, init=init_params_, *args):
        model = cls(cfg, *args, device="cuda")
        with torch.no_grad():
            init(model, torch.Generator(device="cuda").manual_seed(25))
        return model.eval()

    def npz_mb(out: Path) -> float:
        return (out / "weights.npz").stat().st_size / 2 ** 20

    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
        work = Path(tmp)
        # TiTok-B: fp and int8 at bs 8 and 64, timed in turns
        cfg = TiTokConfig(**FLAGSHIP)
        model = build(TiTok, cfg)
        ckpt = write_checkpoint(work / "titok", model, cfg)
        twins = {"fp": model, "int8": _quantized(model, "titok", "int8")}
        x64 = rng.uniform(0, 1, (64, 128, 128, 3)).astype(np.float32)
        # one export a kind at --bs 0 (any batch, as it comes) serves the
        # bs-8 and bs-64 requests alike, unpadded
        titok, outs = {}, {}
        for kind in ("fp", "int8"):
            outs[kind] = work / f"titok_{kind}"
            man = cli_export(ckpt, outs[kind], "titok", "--bs", "0",
                             *(("--quantize", "int8") if kind == "int8"
                               else ()))
            if kind == "int8":
                fidelity["titok_b"] = require_fidelity(man, "TiTok-B int8")
            sizes[f"titok_b_{kind}"] = npz_mb(outs[kind])
        parts["titok_exports"] = time.perf_counter() - t0
        with serving(str(outs["fp"]), batch_window_ms=0) as url_fp, \
                serving(str(outs["int8"]), batch_window_ms=0) as url_q:
            urls = {"fp": url_fp, "int8": url_q}
            for bs in (8, 64):
                rows = {}
                for kind in urls:
                    rows[kind] = serve_tokenizer(
                        urls[kind], twins[kind], "titok", x64[:bs],
                        f"TiTok-B {kind} bs {bs}")
                    add_launches(launches, rows[kind]["launches"])
                times = {kind: [] for kind in urls}
                for kind in ("fp", "int8", "int8", "fp"):
                    times[kind].append(http_times(urls[kind], x64[:bs],
                                                  rows[kind]["codes"]))
                titok[f"bs{bs}"] = {kind: dict(
                    launches=rows[kind]["launches"], http=times[kind])
                    for kind in urls}
        parts["titok"] = time.perf_counter() - t0
        del model, twins
        torch.cuda.empty_cache()

        # the classifier: ViT-L/16 @256, int8, bs 8
        size, patch, preset, rate = VIT_L_CLASSIFIER
        cfg = ViTConfig(size, 3, patch, preset, 1, rate)
        model = build(ViTClassifier, cfg, init_params_, VIT_CLASSES)
        ckpt = write_checkpoint(work / "vit", model, cfg)
        out = work / "vit_int8"
        cli_export(ckpt, out, "vit_classifier", "--bs", "8", "--quantize",
                   "int8")
        sizes["vit_l16_int8"] = npz_mb(out)
        x = rng.uniform(0, 1, (8, size, size, 3)).astype(np.float32)
        with serving(str(out), batch_window_ms=0) as url:
            reset_launches()
            logits = post(url + "/predict", x)
            vit_launches = launched()
        add_launches(launches, vit_launches)
        with torch.inference_mode():
            fp_logits = model(torch.from_numpy(x).cuda()).cpu().numpy()
        classifier = dict(
            launches=vit_launches,
            logits_max_rel_vs_fp=float(np.abs(logits - fp_logits).max()
                                       / np.abs(fp_logits).max()),
            argmax_agreement_vs_fp=float((logits.argmax(-1)
                                          == fp_logits.argmax(-1)).mean()))
        require(logits.shape == (8, VIT_CLASSES)
                and bool(np.isfinite(logits).all())
                and classifier["argmax_agreement_vs_fp"]
                > SERVE_MIN_AGREEMENT,
                f"served int8 logits against the live fp model: {classifier}")
        require(vit_launches.get("attention_packed_fwd") == 24,
                f"ViT-L int8 predict launched {vit_launches}")
        parts["classifier"] = time.perf_counter() - t0
        del model
        torch.cuda.empty_cache()

        # VideoGPT-B: the greedy rollout at bs 1, fp and int8 in turns
        cfg = VideoGPTConfig(**VIDEOGPT)
        model = build(VideoGPT, cfg)
        ckpt = write_checkpoint(work / "videogpt", model, cfg)
        twins = {"fp": model, "int8": _quantized(model, "videogpt", "int8")}
        frame = VIDEOGPT["frame_size"]
        cond = rng.integers(0, VIDEOGPT["codebook_size"],
                            (1, ROLLOUT_COND * frame), dtype=np.int32)
        outs = {}
        for kind in ("fp", "int8"):
            outs[kind] = work / f"videogpt_{kind}"
            cli_export(ckpt, outs[kind], "videogpt", "--bs", "1",
                       "--cond_frames", str(ROLLOUT_COND),
                       "--gen_frames", str(ROLLOUT_GEN),
                       *(("--quantize", "int8") if kind == "int8" else ()))
            sizes[f"videogpt_b_{kind}"] = npz_mb(outs[kind])
        rollout = {}
        with serving(str(outs["fp"]), batch_window_ms=0) as url_fp, \
                serving(str(outs["int8"]), batch_window_ms=0) as url_q:
            urls = {"fp": url_fp, "int8": url_q}
            for kind in ("fp", "int8"):   # a rollout takes seconds
                reset_launches()
                t = time.perf_counter()
                got = post(urls[kind] + "/generate", cond)
                ms = (time.perf_counter() - t) * 1e3
                row = dict(latency_ms=ms, generated_tokens_per_s=(
                    ROLLOUT_GEN * frame / ms * 1e3), launches=launched())
                require(row["launches"].get("attention_fwd")
                        == cfg.trans_config.n_layers,
                        f"{kind} rollout launched {row['launches']}")
                add_launches(launches, row["launches"])
                direct = generate(twins[kind], torch.from_numpy(cond),
                                  ROLLOUT_GEN * frame).cpu().numpy()
                require(np.array_equal(got, direct), f"served {kind} "
                        "rollout differs from a direct generate")
                rollout[kind] = row
        parts["videogpt"] = time.perf_counter() - t0
        del model, twins
        torch.cuda.empty_cache()

        # the other families at their entries' defaults, bs 2
        families = {}
        builds = {
            "vit_vqgan": (ViTVQGANConfig, ViTVQGAN, init_params_),
            "enhancing": (EnhancingVQGANConfig, EnhancingViTVQGAN,
                          init_enhancing_),
            "tatitok": (TATiTokConfig, TATiTok, init_tatitok_),
            "llamagen_titok": (LlamaGenTiTokConfig, LlamaGenTiTok,
                               init_llamagen_titok_),
        }
        for name, fields in SERVE_FAMILIES.items():
            cfg_cls, cls, init = builds[name]
            cfg = cfg_cls(**fields)
            model = build(cls, cfg, init)
            ckpt = write_checkpoint(work / name, model, cfg)
            kind = "fp" if name == "enhancing" else "int8"
            out = work / f"{name}_{kind}"
            man = cli_export(ckpt, out, name, "--bs", str(SERVE_FAMILY_BS),
                             *(("--quantize", "int8") if kind == "int8"
                               else ()))
            live = model if kind == "fp" else _quantized(model, name, "int8")
            if name == "llamagen_titok":
                x = rng.integers(0, cfg.vq_codebook_size,
                                 (SERVE_FAMILY_BS, cfg.vq_latent_tokens),
                                 dtype=np.int32)
            else:
                x = rng.uniform(0, 1, (SERVE_FAMILY_BS, cfg.image_size,
                                       cfg.image_size, 3)).astype(np.float32)
            with serving(str(out), batch_window_ms=0) as url:
                row = serve_tokenizer(url, live, name, x, name)
            add_launches(launches, row["launches"])
            families[name] = dict(launches=row["launches"],
                                  quantize=man["quantize"],
                                  weights_mb=npz_mb(out))
            if kind == "int8":
                fidelity[name] = require_fidelity(man, name)
            del model, live
            torch.cuda.empty_cache()

    emit("serve_export", card=card, titok_b=titok, classifier_vit_l16=classifier,
         videogpt_b_rollout_bs1=rollout, families=families,
         fidelity=fidelity, weights_mb=sizes, seconds_at=parts,
         tolerance=dict(min_agreement=SERVE_MIN_AGREEMENT,
                        min_psnr_db=SERVE_MIN_PSNR_DB),
         seconds=time.perf_counter() - t0)
    return launches


def entry_phases(card: str, converge_epochs: "int | None"
                 ) -> "tuple[dict, dict]":
    """The train_titok and train_videogpt entries' phases; their launches
    summed, and the fp32 launches."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_titok_") as tmp:
        launches, fp32_launches = phase_train_titok_entry(card, Path(tmp))
        converge = phase_train_titok_converge(card, Path(tmp),
                                              converge_epochs)
        gpt = phase_train_videogpt_entry(card, Path(tmp),
                                         Path(tmp) / "converge" / "ckpt")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_data_") as tmp:
        data = phase_data(card, Path(tmp))
    phase_repro(card)
    return ({n: launches[n] + converge[n] + gpt[n] + data[n]
             for n in launches}, fp32_launches)


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--converge_epochs", type=int,
                        default=SMOKE_CONVERGE_EPOCHS,
                        help="epochs of the S-scale run (25: the whole run)")
    parser.add_argument("--entries_only", action="store_true",
                        help="only the build and the train_titok and "
                             "train_videogpt phases; no kernels line and no "
                             "closing line")
    parser.add_argument("--pretrain_only", action="store_true",
                        help="only the build and the pretrain phase; no "
                             "kernels line and no closing line")
    parser.add_argument("--tatitok_only", action="store_true",
                        help="only the build and the tatitok phase; no "
                             "kernels line and no closing line")
    parser.add_argument("--families_only", action="store_true",
                        help="only the build and the families phase; no "
                             "kernels line and no closing line")
    parser.add_argument("--serve_only", action="store_true",
                        help="only the build and the serve_export phase; "
                             "no kernels line and no closing line")
    args = parser.parse_args(argv)
    card = phase_device()
    phase_build()
    if args.entries_only:
        entry_phases(card, args.converge_epochs)
        return
    if args.pretrain_only:
        phase_pretrain(card)
        return
    if args.tatitok_only:
        phase_tatitok(card)
        return
    if args.families_only:
        phase_families(card)
        return
    if args.serve_only:
        phase_serve_export(card)
        return
    fma_summary, fma_launches = phase_fma_probe(card)
    summary = phase_kernels()
    for name, arm in fp32_kernels(
            torch.Generator(device="cuda").manual_seed(7)).items():
        summary[name]["fp32"] = arm
    hd32_summary, pretrain_launches, hd32_fp32 = phase_pretrain(card)
    summary.update(hd32_summary)
    tatitok_arms, tatitok_launches = phase_tatitok(card)
    for name, arm in tatitok_arms.items():
        summary[name]["tatitok"] = arm
    families_arms, families_launches = phase_families(card)
    for name, arm in families_arms.items():
        summary[name]["families"] = arm

    cfg = TiTokConfig(**FLAGSHIP)
    model = TiTok(cfg)
    init_params_(model, torch.Generator().manual_seed(0))
    emit("model", params=sum(p.numel() for p in model.parameters()),
         config=FLAGSHIP, dtype="bfloat16 compute, float32 params")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        launches = phase_slice(Path(tmp), model)
        phase_timing(model, card)
        weights = copy.deepcopy(model.state_dict())
        perceptual, images = train_inputs(model)
        train_launches = phase_train(model, perceptual, images, card)
        fused_launches = phase_train_fused(model, weights, perceptual,
                                           images, card)
        int8_launches = phase_train_int8(model, weights, perceptual, images,
                                         card)
        perceptual_launches = phase_perceptual(perceptual.net.state_dict(),
                                               card)
        del model, weights, perceptual, images
        torch.cuda.empty_cache()
        gpt, tokens, gpt_launches, gpt_dropout = phase_videogpt_train(card)
        rollout_launches = phase_videogpt_rollout(Path(tmp), gpt, tokens,
                                                  card)
        del gpt, tokens
        torch.cuda.empty_cache()
    vit_launches, vit_dropout = phase_vit(card)
    fp32_path_launches, fp32_launches = phase_fp32(card)
    phase_train_vit_entry(card)
    phase_train_vit_entry(card, "--mixed", "false")
    titok_launches, titok_fp32 = entry_phases(card, args.converge_epochs)
    serve_launches = phase_serve_export(card)
    for name, n in titok_fp32.items():
        fp32_launches[name] = fp32_launches.get(name, 0) + n
    # the other paths' attention launches are all 64-wide
    for path in (train_launches, fused_launches, gpt_launches,
                 rollout_launches, int8_launches, perceptual_launches,
                 vit_launches, fp32_path_launches, titok_launches,
                 pretrain_launches, tatitok_launches, families_launches,
                 serve_launches):
        for name, n in path.items():
            launches[name] = launches.get(name, 0) + n
    dropout_launches = {name: gpt_dropout[name] + vit_dropout[name]
                        for name in gpt_dropout}

    sources = {
        # K1 and K2: the kBias instantiations of K6's and K7/K8's kernels
        "attention_packed_fwd": ("vit_tpu_torch/csrc/attention_fwd.cu",
                                 "vit_tpu/kernels/attention.py:623"),
        "attention_packed_bwd": ("vit_tpu_torch/csrc/attention_bwd.cu",
                                 "vit_tpu/kernels/attention.py:824"),
        "convnext_tail_fwd": ("vit_tpu_torch/csrc/convnext_tail.cu",
                              "vit_tpu/kernels/convnext_block.py:89"),
        "convnext_tail_bwd": ("vit_tpu_torch/csrc/convnext_tail.cu",
                              "vit_tpu/kernels/convnext_block.py:109"),
        "vq_nearest": ("vit_tpu_torch/csrc/vq_nearest.cu",
                       "vit_tpu/kernels/vq.py:36"),
        "attention_fwd": ("vit_tpu_torch/csrc/attention_fwd.cu",
                          "vit_tpu/kernels/attention.py:76"),
        # one kernel pair for both unpacked backwards: K8 (S > 768, the
        # path's) and K7 (S ≤ 768, held at S 513 in the kernel phase)
        "attention_bwd": ("vit_tpu_torch/csrc/attention_bwd.cu",
                          "vit_tpu/kernels/attention.py:284"),
        "ln_matmul_fwd": ("vit_tpu_torch/csrc/ln_matmul.cu",
                          "vit_tpu/kernels/ln_matmul.py:60"),
        "ln_matmul_dgelu": ("vit_tpu_torch/csrc/ln_bwd.cu",
                            "vit_tpu/kernels/ln_matmul.py:148"),
        "ln_bwd": ("vit_tpu_torch/csrc/ln_bwd.cu",
                   "vit_tpu/kernels/ln_matmul.py:78"),
        "fc_grad": ("vit_tpu_torch/csrc/fc_grad.cu",
                    "vit_tpu/kernels/fc_grad.py:74"),
        "depthwise_fwd": ("vit_tpu_torch/csrc/depthwise.cu",
                          "vit_tpu/kernels/depthwise.py:24"),
        "depthwise_bwd": ("vit_tpu_torch/csrc/depthwise.cu",
                          "vit_tpu/kernels/depthwise.py:77"),
        "convnext_tail_fwd_q8": ("vit_tpu_torch/csrc/convnext_tail_q8.cu",
                                 "vit_tpu/kernels/convnext_block.py:148"),
        "convnext_tail_bwd_q8": ("vit_tpu_torch/csrc/convnext_tail_q8.cu",
                                 "vit_tpu/kernels/convnext_block.py:172"),
    }
    # the head_dim-32 instantiations of K1, K2, K6 and K7/K8 (the MAE-B
    # decoder's heads), in the same sources
    for name, d32 in HD32.items():
        sources[d32] = sources[name]
    also = {"attention_bwd": "vit_tpu/kernels/attention.py:201",
            HD32["attention_bwd"]: "vit_tpu/kernels/attention.py:201"}
    missing = [name for name in sources if launches.get(name, 0) == 0]
    require(not missing, f"kernels of the paths never launched: {missing}")
    # each attention kernel's dropout branch: ViT-L's K1/K2, VideoGPT's K6/K8
    missing = [name for name, n in dropout_launches.items() if n == 0]
    require(not missing, f"dropout branches never launched: {missing}")
    # each fp32 form on the fp32 paths
    missing = [name for name in FP32_FORMS if fp32_launches.get(name, 0) == 0]
    missing += [name for name, n in hd32_fp32.items()
                if n == 0 and name in (HD32["attention_packed_fwd"],
                                       HD32["attention_packed_bwd"])]
    require(not missing, f"fp32 forms never launched: {missing}")
    require(fma_launches > 0, "P was never launched")
    sources["fma_probe"] = ("vit_tpu_torch/csrc/fma_probe.cu",
                            "scripts/bench_vpu.py:32")
    launches["fma_probe"] = fma_launches
    summary["fma_probe"] = fma_summary
    # K5's runtime-D form on a path: the --latent_dim 6 entry run's steps
    summary["vq_nearest"]["any_dim_launches"] = measured[
        "k5_any_dim_launches"]
    require(measured["k5_any_dim_launches"] > 0,
            "K5's runtime-D form never launched on a path")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": launches[name],
         **summary[name],
         **({"dropout_launches": dropout_launches[name]}
            if name in dropout_launches else {}),
         **({"fp32_launches": fp32_launches[name]}
            if name in FP32_FORMS else {}),
         **({"fp32_launches": hd32_fp32[name]} if name in hd32_fp32 else {}),
         **({"dx_only_launches": launches["depthwise_bwd_dx_only"]}
            if name == "depthwise_bwd" else {}),
         **({"also_replaces": also[name]} if name in also else {})}
        for name in sources]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
