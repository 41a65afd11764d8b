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
over HTTP. Phases, one JSON line each:

  1. device   — fails without CUDA; card name and power limit; TF32 off;
  2. build    — compiles the CUDA kernels from ``vit_tpu_torch/csrc``, one
                nvcc per source in parallel; registers and spills per kernel;
  3. kernels  — each kernel against its plain PyTorch version on the card,
                at the paths' shapes and a few edge shapes, with timings, the
                bound the card's peaks set for the same work, and the time of
                one PyTorch library call computing the same function (or,
                as named, the product inside it) where there is one
                (``F.scaled_dot_product_attention`` for the attention
                kernels, with the backend it picked; ``F.linear`` for K9a,
                ``torch.mm`` for K10);
  4. slice    — export → load → HTTP server; concurrent /encode requests,
                /decode of the indices; checks shapes, ranges, a 400, that
                every kernel launched during those requests, that the served
                codes equal a direct call of the kernels, and that the same
                weights run through the plain versions agree: latents and
                images within bf16 noise, every differing code a near-tie;
  5. timing   — encode and decode latency per request and images/s at bs 8
                and bs 64;
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
  8. videogpt_train — the VideoGPT-B step at bs 32 (tokenize 512 frames,
                next-token CE, AdamW): the launches of one step (K6 12,
                K7/K8 12, K1 6, K5 1); the tokenizer's codes against the
                plain versions' (every differing code a near-tie); loss and
                gradient norm of the first step against the plain versions,
                on the same codes; 20 steps on one batch lower
                the loss; step time, tokens/s and peak memory of the full
                step and of the AR step alone on random tokens; a profile of
                one step;
  9. videogpt_rollout — export → load → HTTP /generate at bs 1 and bs 8: 512
                conditioning codes in, 1024 out, the prefix intact, every
                code in range, equal to a direct generate call, 12 K6
                launches per rollout (the prefill); the prefill's logits
                against the plain versions and the first generated code equal
                or a near-tie; generated tokens/s per request; the device's
                busy time in one rollout against the host's.

Then the kernels' summary line, the card's name and power limit, and as the
last line ``{"ok": true, "device": {...}}``. Any failure raises, so the
script exits non-zero without that line. It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import re
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

from vit_tpu_torch.kernels import _build  # noqa: E402
from vit_tpu_torch.kernels import attention as k_attn  # noqa: E402
from vit_tpu_torch.kernels import convnext_block as k_cnx  # noqa: E402
from vit_tpu_torch.kernels import fc_grad as k_fc  # noqa: E402
from vit_tpu_torch.kernels import ln_matmul as k_lnmm  # noqa: E402
from vit_tpu_torch.kernels import vq as k_vq  # noqa: E402
from vit_tpu_torch.data.synthetic import SyntheticVideoLoader  # noqa: E402
from vit_tpu_torch.losses.perceptual import ConvNeXt, PerceptualLoss  # noqa: E402
from vit_tpu_torch.models.pretrained import FrozenTokenizer  # noqa: E402
from vit_tpu_torch.models.titok import TiTok, TiTokConfig  # noqa: E402
from vit_tpu_torch.models.videogpt import (VideoGPT,  # noqa: E402
                                           VideoGPTConfig, generate,
                                           init_cache)
from vit_tpu_torch.serve.export import (export_tokenizer,  # noqa: E402
                                        export_videogpt, load_exported)
from vit_tpu_torch.serve.server import make_server  # noqa: E402
from vit_tpu_torch.train.optim import make_optimizer  # noqa: E402
from vit_tpu_torch.train.state import TrainState  # noqa: E402
from vit_tpu_torch.train.step import (make_tokenizer_train_step,  # noqa: E402
                                      make_videogpt_train_step)
from vit_tpu_torch.utils.init import init_convnext_, init_params_  # noqa: E402

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
K5_TIE_GAP = 1e-6   # the kernel's fp32 scores of order 1e-3 against fp64
K5_PLAIN_ULPS = 8   # the plain version's fp32 distance, in ulps of its terms
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
NO_FUSED = dict(ln_matmul_fwd=0, ln_matmul_dgelu=0, ln_bwd=0, fc_grad=0)
STEP_LAUNCHES = dict(attention_packed_fwd=24, attention_packed_bwd=24,
                     convnext_tail_fwd=66, convnext_tail_bwd=33, vq_nearest=1,
                     attention_fwd=0, attention_bwd=0, **NO_FUSED)
# The same step under VIT_TPU_FUSED_LN=1 VIT_TPU_FUSED_FC=1: K9a at the qkv
# and fc1 sites of the 24 layers (encoder and decoder), K9b at fc1, K9c in
# both sites' backward, K10 at fc2 (fc1's gradient comes from K9a's
# backward); and under VIT_TPU_FUSED_LN=0 VIT_TPU_FUSED_FC=1: K10 at fc1
# and fc2.
FUSED_STEP_LAUNCHES = dict(STEP_LAUNCHES, ln_matmul_fwd=48, ln_matmul_dgelu=24,
                           ln_bwd=48, fc_grad=24)
FC_STEP_LAUNCHES = dict(STEP_LAUNCHES, fc_grad=48)
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
                           **NO_FUSED)
# The prefill's last-position logits with the kernels and through the plain
# versions: bf16 noise through 12 layers, as the TiTok-B slice's latents.
PREFILL_MAX_REL = 2e-2
ROLLOUT_COND, ROLLOUT_GEN = 8, 8    # frames in, frames out
# Published peaks of one H100 SXM (NVIDIA's data sheet; dense, at 700 W):
# the bound of a kernel is the larger of its operations over the peak rate
# for their type and its bytes (each input read once, each output written
# once) over the memory rate.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


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
    k_attn.launches = k_attn.bwd_launches = 0
    k_attn.unpacked_launches = k_attn.unpacked_bwd_launches = 0
    k_cnx.launches = k_cnx.bwd_launches = 0
    k_vq.launches = 0
    k_lnmm.launches = k_lnmm.dgelu_launches = k_lnmm.ln_bwd_launches = 0
    k_fc.launches = 0


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
                ln_bwd=k_lnmm.ln_bwd_launches, fc_grad=k_fc.launches)


def bound(flop: float, nbytes: float, peak: float = PEAK_BF16_FLOPS) -> dict:
    """The least time the card could take: operations over the peak rate
    for their type, or bytes over the memory rate, whichever is larger."""
    ops_ms = flop / peak * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return dict(bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                flop=flop, bytes=nbytes)


def attention_bound(b: int, h: int, s: int, causal: bool, backward: bool,
                    extra_bytes: float = 0.0) -> dict:
    """Attention over (b, h, s, 64) bf16 operands: 2 products of 2·64 FLOP
    per unmasked (query, key) pair forward, 5 backward; q, k, v (and dO)
    read and out (dq, dk, dv) written once in bf16, m and l in fp32."""
    pairs = s * (s + 1) // 2 if causal else s * s
    tile = b * h * s * 64 * 2
    stats = 2 * b * h * s * 4
    if backward:
        return bound(10 * 64 * pairs * b * h,
                     4 * tile + stats + 3 * tile + extra_bytes)
    return bound(4 * 64 * pairs * b * h, 3 * tile + tile + stats + extra_bytes)


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
    import vit_tpu_torch.quantize.vq as quant_vq

    routes = [(k_attn, "attention_packed_fwd", k_attn.attention_packed_fwd_ref),
              (k_attn, "attention_packed_bwd", k_attn.attention_packed_bwd_ref),
              (k_attn, "attention_fwd", k_attn.attention_fwd_ref),
              (k_attn, "attention_bwd", k_attn.attention_bwd_ref),
              (k_cnx, "convnext_tail_fwd", k_cnx.convnext_tail_fwd_ref),
              (k_cnx, "convnext_tail_bwd", k_cnx.convnext_tail_bwd_ref),
              (quant_vq, "nearest_code", k_vq.nearest_code_ref),
              (k_lnmm, "ln_matmul_fwd", k_lnmm.ln_matmul_fwd_ref),
              (k_lnmm, "ln_matmul_dgelu", k_lnmm.ln_matmul_dgelu_ref),
              (k_lnmm, "ln_bwd", k_lnmm.ln_bwd_ref),
              (k_fc, "matmul_dw_db", k_fc.matmul_dw_db_ref)]
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
    return card


def phase_build() -> None:
    t0 = time.perf_counter()
    lib = _build.load()
    seconds = time.perf_counter() - t0
    log = Path(lib._name + ".log")
    # ptxas's report per kernel, the mangled name cut to the kernel's own
    # name and its template argument: registers, shared memory, spills
    ptxas, name = {}, None
    for line in (log.read_text().splitlines() if log.exists() else []):
        entry = re.search(r"Compiling entry function '.*?([a-z_]+_kernel)"
                          r"(?:ILi(\d+)E)?", line)
        if entry:
            name = entry.group(1) + (f"<{entry.group(2)}>"
                                     if entry.group(2) else "")
        elif name and ("registers" in line or "spill" in line):
            ptxas[name] = (ptxas.get(name, "") + " "
                           + line.split(":", 1)[-1].strip()).strip()
    emit("build", seconds=seconds, library=Path(lib._name).name, ptxas=ptxas)


def phase_kernels() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    summary = {}

    # K1: bf16 with bias; the serving and train steps' shapes, a ragged
    # causal tile, longest S, and the VideoGPT step's frozen TiTok-S encode
    # (bs 32 · 16 frames, S 128, 6 heads, no stats on the path). With stats
    # the output must be the same bits, m and l fp32-close.
    k1_max, k1_rows = 0.0, []
    for b, s, h, causal in [(8, 320, 12, False), (TRAIN_BS, 320, 12, False),
                            (3, 77, 12, True), (2, 768, 12, False),
                            (VIDEO_BS * VIDEOGPT["max_frames"], 128, 6, False)]:
        width = h * 64
        qkv = torch.randn(b, s, 3 * width, device="cuda",
                          generator=gen).bfloat16()
        bias = 0.3 * torch.randn(3 * width, device="cuda", generator=gen)
        out = k_attn.flash_attention_packed(qkv, h, causal=causal,
                                            qkv_bias=bias)
        out_s, m, l = k_attn.attention_packed_fwd(qkv, bias, h, causal,
                                                  emit_stats=True)
        torch.cuda.synchronize()
        ref, m_ref, l_ref = k_attn.attention_packed_fwd_ref(
            qkv, bias, h, causal, emit_stats=True)
        diff = (out.float() - ref.float()).abs()
        row = dict(B=b, S=s, H=h, causal=causal, max_abs=diff.max().item(),
                   mean_abs=diff.mean().item(),
                   stats_out_identical=bool(torch.equal(out, out_s)),
                   m_rel=((m - m_ref).abs().max()
                          / m_ref.abs().max()).item(),
                   l_rel=((l - l_ref).abs() / l_ref).max().item())
        k1_rows.append(row)
        require(bool(torch.isfinite(out).all()), f"K1 non-finite at {row}")
        require(row["max_abs"] <= K1_MAX_ABS and row["mean_abs"] <= K1_MEAN_ABS,
                f"K1 disagrees with its plain version: {row}")
        require(row["stats_out_identical"] and row["m_rel"] <= K1_STATS_REL
                and row["l_rel"] <= K1_STATS_REL,
                f"K1's statistics disagree with the plain version: {row}")
        k1_max = max(k1_max, row["max_abs"])
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
                        stats_rel=K1_STATS_REL),
         ms_bs8=times[8][0], stats_ms_bs8=times[8][1],
         plain_ms_bs8=times[8][2], ms_bs64=times[64][0],
         stats_ms_bs64=times[64][1], plain_ms_bs64=times[64][2],
         sdpa_ms_bs64=lib_ms, sdpa_backend=sdpa_backend(q, k, v, False),
         bound_bs64=k1_bound, shape="(bs, S 320, 3·768) bf16, 12 heads")
    summary["attention_packed_fwd"] = dict(
        max_abs_err=k1_max, ms=times[64][1], plain_ms=times[64][2],
        bound_ms=k1_bound["bound_ms"], bound_by=k1_bound["bound_by"],
        library_ms=lib_ms)

    # K2: the flagship step's shape, a ragged causal one, the longest S, and
    # S not a multiple of 8; (m, l) from K1, the same for kernel and plain.
    k2_max, k2_rows = 0.0, []
    for b, s, causal in [(64, 320, False), (3, 77, True), (2, 768, False),
                         (2, 130, True)]:
        h, width = 12, 768
        qkv = torch.randn(b, s, 3 * width, device="cuda",
                          generator=gen).bfloat16()
        bias = 0.3 * torch.randn(3 * width, device="cuda", generator=gen)
        dout = torch.randn(b, s, width, device="cuda", generator=gen).bfloat16()
        _, m, l = k_attn.attention_packed_fwd(qkv, bias, h, causal,
                                              emit_stats=True)
        dqkv, dbias = k_attn.attention_packed_bwd(qkv, bias, dout, m, l, h,
                                                  causal)
        torch.cuda.synchronize()
        dqkv_ref, dbias_ref = k_attn.attention_packed_bwd_ref(
            qkv, bias, dout, m, l, h, causal)
        row = dict(B=b, S=s, H=h, causal=causal,
                   dqkv=rel_errors(dqkv, dqkv_ref),
                   dbias=rel_errors(dbias, dbias_ref))
        k2_rows.append(row)
        require(bool(torch.isfinite(dqkv).all() and torch.isfinite(dbias).all()),
                f"K2 non-finite at {row}")
        for key in ("dqkv", "dbias"):
            require(row[key]["max_rel"] <= BWD_MAX_REL
                    and row[key]["mean_rel"] <= BWD_MEAN_REL,
                    f"K2 disagrees with its plain version: {row}")
        k2_max = max(k2_max, row["dqkv"]["max_abs"])
    b, s = TRAIN_BS, 320
    qkv = torch.randn(b, s, 3 * 768, device="cuda", generator=gen).bfloat16()
    bias = torch.randn(3 * 768, device="cuda", generator=gen)
    dout = torch.randn(b, s, 768, device="cuda", generator=gen).bfloat16()
    _, m, l = k_attn.attention_packed_fwd(qkv, bias, 12, False, emit_stats=True)
    k2_ms = median_ms(lambda: k_attn.attention_packed_bwd(qkv, bias, dout, m,
                                                          l, 12, False))
    k2_plain = median_ms(lambda: k_attn.attention_packed_bwd_ref(
        qkv, bias, dout, m, l, 12, False))
    lib = sdpa_backward_ms(*k_attn.split_heads(qkv, 12, bias),
                           dout.reshape(b, s, 12, 64).transpose(1, 2), False)
    k2_bound = attention_bound(b, 12, s, False, True,
                               extra_bytes=3 * 768 * (4 + 4))  # fp32 bias in, dbias out
    emit("kernel", name="attention_packed_bwd", parity=k2_rows,
         tolerance=dict(max_rel=BWD_MAX_REL, mean_rel=BWD_MEAN_REL),
         ms_bs64=k2_ms, plain_ms_bs64=k2_plain, sdpa_bs64=lib,
         bound_bs64=k2_bound, shape="(64, S 320, 3·768) bf16, 12 heads")
    summary["attention_packed_bwd"] = dict(
        max_abs_err=k2_max, ms=k2_ms, plain_ms=k2_plain,
        bound_ms=k2_bound["bound_ms"], bound_by=k2_bound["bound_by"],
        library_ms=lib["backward_ms"])

    # K3 / K4: the three fused stages of ConvNeXt-S at bs 64, and ragged N.
    # γ of order 1 (not the init's 1e-6) so the tail shows in y.
    def tail_inputs(n, c):
        def r(*shape, scale=1.0):
            return scale * torch.randn(*shape, device="cuda", generator=gen)
        h = r(n, c).bfloat16()
        x = r(n, c).bfloat16()
        dy = r(n, c).bfloat16()
        params = (1.0 + r(c, scale=0.1), r(c, scale=0.1),
                  r(4 * c, c, scale=c ** -0.5), r(4 * c, scale=0.1),
                  r(c, 4 * c, scale=(4 * c) ** -0.5), r(c, scale=0.1),
                  r(c, scale=1.0))
        return h, x, dy, params

    tails = {"convnext_tail_fwd": dict(rows=[], max=0.0, ms={}, plain_ms={}),
             "convnext_tail_bwd": dict(rows=[], max=0.0, ms={}, plain_ms={})}
    shapes = [(n, c) for _, _, n, c in CNX_STAGES] + [(1000, 96), (777, 384)]
    for n, c in shapes:
        h, x, dy, (lns, lnb, w1, b1, w2, b2, gamma) = tail_inputs(n, c)
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
                    and row["mean_rel"] <= BWD_MEAN_REL,
                    f"{name} disagrees with its plain version: {row}")
            tails[name]["max"] = max(tails[name]["max"], row["max_abs"])
            if (n, c) in [(n_, c_) for _, _, n_, c_ in CNX_STAGES]:
                tails[name]["ms"][c] = median_ms(lambda: kernel(*args), 10)
                tails[name]["plain_ms"][c] = median_ms(lambda: plain(*args), 10)
        del h, x, dy
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
    for name, t in tails.items():
        emit("kernel", name=name, parity=t["rows"],
             tolerance=dict(max_rel=BWD_MAX_REL, mean_rel=BWD_MEAN_REL),
             ms_by_C=t["ms"], plain_ms_by_C=t["plain_ms"],
             bound_C384=tail_bounds[name],
             shape="(bs 64 · H · W, C) bf16 rows of ConvNeXt-S stages 0-2",
             summary_shape="C 384, N 12544 (27 of the 33 fused blocks)")
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
            z = torch.randn(n, 12, device="cuda", generator=gen)
            cb = (torch.rand(c, 12, device="cuda", generator=gen) * 2 - 1) / c
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
            # The plain version's fp32 distance ‖z‖² + ‖e‖² − 2z·e rounds
            # at the ulp of its largest term, (‖z‖ + ‖e‖)² at most.
            plain_bound = (K5_PLAIN_ULPS * 2.0 ** -24 * (
                z64.norm(dim=-1) + e64.norm(dim=-1).max()) ** 2)[bad]
            worst = (s64[bad, idx[bad]] - s64[bad, ref[bad]]).abs().max().item() \
                if len(bad) else 0.0
            k5_rows.append(dict(
                N=n, C=c, D=12, l2_normalize=l2, near_ties=len(bad),
                max_tie_gap=worst, kernel_max_regret=regret.max().item(),
                plain_max_regret_over_bound=(
                    (plain_regret / plain_bound).max().item() if len(bad)
                    else 0.0)))
            require(regret.max().item() <= K5_TIE_GAP,
                    f"K5 misses the fp64 nearest code: {k5_rows[-1]}")
            require(bool((plain_regret <= plain_bound).all()),
                    f"K5 disagrees beyond a near-tie: {k5_rows[-1]}")
            k5_gap = max(k5_gap, worst)
    for d in k_vq.SUPPORTED_DIMS:  # every instantiation the library ships
        z = torch.randn(333, d, device="cuda", generator=gen)
        cb = torch.randn(500, d, device="cuda", generator=gen)
        same = (k_vq.nearest_code(z, cb) == k_vq.nearest_code_ref(z, cb))
        require(bool(same.all()), f"K5 disagrees at D {d}")
    cb = torch.randn(64, 12, device="cuda", generator=gen)
    cb[40] = cb[7]
    cb[63] = cb[7]
    z = cb[7:8].repeat(33, 1).contiguous()
    for l2 in (True, False):
        require(k_vq.nearest_code(z, cb, l2_normalize=l2).unique().tolist()
                == [7], "K5 does not break ties toward the lowest index")
    times = {}
    for bs in (8, 64):
        z = torch.randn(bs * 256, 12, device="cuda", generator=gen)
        cb = (torch.rand(2048, 12, device="cuda", generator=gen) * 2 - 1) / 2048
        times[bs] = (median_ms(lambda: k_vq.nearest_code(z, cb)),
                     median_ms(lambda: k_vq.nearest_code_ref(z, cb)))
    # N 2048 rows against 2048 codes of D 12: N·C·D fp32 multiply-adds off
    # the tensor cores; z and the codebook read, the indices written.
    k5_bound = bound(2 * 2048 * 2048 * 12, (2048 + 2048) * 12 * 4 + 2048 * 4,
                     peak=PEAK_FP32_FLOPS)
    emit("kernel", name="vq_nearest", parity=k5_rows,
         tolerance=dict(tie_gap=K5_TIE_GAP), lowest_index_ties=True,
         dims_checked=list(k_vq.SUPPORTED_DIMS),
         ms_bs8=times[8][0], plain_ms_bs8=times[8][1],
         ms_bs64=times[64][0], plain_ms_bs64=times[64][1],
         bound_bs8=k5_bound, shape="(bs·256, 12) fp32 against (2048, 12)")
    summary["vq_nearest"] = dict(max_abs_err=k5_gap, ms=times[8][0],
                                 plain_ms=times[8][1],
                                 bound_ms=k5_bound["bound_ms"],
                                 bound_by=k5_bound["bound_by"],
                                 library_ms=None)
    summary.update(unpacked_kernels(gen))
    summary.update(fused_kernels(gen))
    return summary


def head_views(b: int, h: int, s: int, gen, packed: bool = True):
    """bf16 q, k, v (b, h, s, 64): the strided head views of one packed
    (b, s, 3·h·64) projection, as the model hands them over, or three
    contiguous tensors."""
    if packed:
        qkv = torch.randn(b, s, 3, h, 64, device="cuda",
                          generator=gen).bfloat16()
        return tuple(qkv.permute(2, 0, 3, 1, 4))
    return tuple(torch.randn(b, h, s, 64, device="cuda",
                             generator=gen).bfloat16() for _ in range(3))


def sdpa_backward_ms(q, k, v, dout, causal: bool) -> dict:
    """``F.scaled_dot_product_attention``'s backward alone (autograd.grad
    on a kept graph) and its forward + backward, on leaf copies of q, k, v."""
    q, k, v = (t.detach().clone().requires_grad_() for t in (q, k, v))

    def fwd():
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal)

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
                and row["mean_rel"] <= BWD_MEAN_REL,
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
                    and row[name]["mean_rel"] <= BWD_MEAN_REL,
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
    _, m, l = k_attn.attention_fwd(q, k, v, True, emit_stats=True)
    k8 = dict(ms=median_ms(lambda: k_attn.attention_bwd(q, k, v, dout, m, l,
                                                        True)),
              plain_ms=median_ms(lambda: k_attn.attention_bwd_ref(
                  q, k, v, dout, m, l, True), 5),
              sdpa=sdpa_backward_ms(q, k, v, dout, True))
    k6_bound = attention_bound(b, 12, s, True, False)
    k8_bound = attention_bound(b, 12, s, True, True)
    emit("kernel", name="attention_fwd", parity=k6_rows,
         tolerance=dict(max_rel=BWD_MAX_REL, mean_rel=BWD_MEAN_REL,
                        stats_rel=K1_STATS_REL),
         bound=k6_bound, shape="(32, 12, S 1024, 64) bf16 causal, strided",
         **k6)
    emit("kernel", name="attention_bwd", parity=k8_rows,
         tolerance=dict(max_rel=BWD_MAX_REL, mean_rel=BWD_MEAN_REL),
         bound=k8_bound, shape="(32, 12, S 1024, 64) bf16 causal, strided",
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
                   xhat=beyond_one_ulp(xhat, xhat_ref),
                   z_same_without_residuals=bool(torch.equal(z, z_only)))
        checks = [row["z"]]
        if gelu:
            row["zpre"] = rel_errors(zpre, zpre_ref)
            checks.append(row["zpre"])
        k9a_rows.append(row)
        require(bool(torch.isfinite(z).all()), f"K9a non-finite at {row}")
        require(all(e["max_rel"] <= BWD_MAX_REL and e["mean_rel"] <= BWD_MEAN_REL
                    for e in checks) and row["xhat"]["beyond_one_ulp"] == 0
                and row["z_same_without_residuals"],
                f"K9a disagrees with its plain version: {row}")
        k9a_max = max(k9a_max, row["z"]["max_abs"])
        if n == N_ROWS:
            site = "fc1" if gelu else "qkv"
            # each input read once, each output written once: x, W, b; z,
            # zpre (fc1) and x̂
            k9a[site] = dict(
                ms=median_ms(lambda: k_lnmm.ln_matmul_fwd(x, w, b, gelu)),
                serving_ms=median_ms(lambda: k_lnmm.ln_matmul_fwd(
                    x, w, b, gelu, residuals=False)),
                plain_ms=median_ms(lambda: k_lnmm.ln_matmul_fwd_ref(
                    x, w, b, gelu), 5),
                library_ms=median_ms(lambda: F.linear(xhat_ref, w)),
                bound=bound(2 * n * c * f,
                            2 * (2 * n * c + f * c + (f if bias else 0)
                                 + (2 if gelu else 1) * n * f)))
        del x, w, b, z, zpre, xhat, z_only, z_ref, zpre_ref, xhat_ref
    emit("kernel", name="ln_matmul_fwd", parity=k9a_rows,
         tolerance=dict(max_rel=BWD_MAX_REL, mean_rel=BWD_MEAN_REL,
                        xhat="one bf16 ulp"),
         library="F.linear on a precomputed bf16 x̂: the product alone",
         shape="x (20480, 768) bf16; qkv W (2304, 768), fc1 W (3072, 768)",
         **k9a)
    summary["ln_matmul_fwd"] = dict(
        max_abs_err=k9a_max, ms=k9a["fc1"]["ms"],
        plain_ms=k9a["fc1"]["plain_ms"],
        bound_ms=k9a["fc1"]["bound"]["bound_ms"],
        bound_by=k9a["fc1"]["bound"]["bound_by"],
        library_ms=k9a["fc1"]["library_ms"], shape="fc1 (20480, 768 → 3072)",
        library="F.linear on a precomputed bf16 x̂: the product alone")

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
                and row["mean_rel"] <= BWD_MEAN_REL,
                f"K9c disagrees with its plain version: {row}")
        k9c_max = max(k9c_max, row["max_abs"])
        if n == N_ROWS:
            k9c = dict(ms=median_ms(lambda: k_lnmm.ln_bwd(x, g)),
                       plain_ms=median_ms(lambda: k_lnmm.ln_bwd_ref(x, g)),
                       bound=bound(10 * n * c, 3 * 2 * n * c,
                                   peak=PEAK_FP32_FLOPS))
    emit("kernel", name="ln_bwd", parity=k9c_rows,
         tolerance=dict(max_rel=BWD_MAX_REL, mean_rel=BWD_MEAN_REL),
         library=None, shape="(20480, 768) bf16", **k9c)
    summary["ln_bwd"] = dict(
        max_abs_err=k9c_max, ms=k9c["ms"], plain_ms=k9c["plain_ms"],
        bound_ms=k9c["bound"]["bound_ms"], bound_by=k9c["bound"]["bound_by"],
        library_ms=None)

    # K10: fc2 (g 768 wide, x 3072), fc1 (g 3072, x 768), a ragged N. The
    # plain version is an fp32 product (TF32 off), the kernel's sums run in
    # another order over 20480 terms.
    k10_rows, k10_max, k10 = [], 0.0, {}
    for n, fo, fi in [(N_ROWS, 768, 3072), (N_ROWS, 3072, 768),
                      (N_ROWS + 1, 768, 3072)]:
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
                and row["deterministic"],
                f"K10 disagrees with its plain version: {row}")
        k10_max = max(k10_max, row["dw"]["max_abs"])
        if n == N_ROWS:
            site = "fc2" if fo < fi else "fc1"
            k10[site] = dict(
                ms=median_ms(lambda: k_fc.matmul_dw_db(g, x)),
                plain_ms=median_ms(lambda: k_fc.matmul_dw_db_ref(g, x), 5),
                library_ms=median_ms(lambda: torch.mm(g.t(), x)),
                bound=bound(2 * n * fo * fi,
                            2 * n * (fo + fi) + 4 * (fo * fi + fo)))
        del g, x, dw, db, dw2, db2, dw_ref, db_ref
    emit("kernel", name="fc_grad", parity=k10_rows,
         tolerance=dict(dw_max_rel=1e-3, db_max_rel=1e-4),
         library="torch.mm(g.t(), x) in bf16: dW alone, rounded to bf16, no db",
         shape="fc2: g (20480, 768), x (20480, 3072); fc1 transposed", **k10)
    summary["fc_grad"] = dict(
        max_abs_err=k10_max, ms=k10["fc2"]["ms"],
        plain_ms=k10["fc2"]["plain_ms"],
        bound_ms=k10["fc2"]["bound"]["bound_ms"],
        bound_by=k10["fc2"]["bound"]["bound_by"],
        library_ms=k10["fc2"]["library_ms"],
        shape="fc2: g (20480, 768), x (20480, 3072)",
        library="torch.mm(g.t(), x) in bf16: dW alone, rounded to bf16, no db")
    torch.cuda.empty_cache()
    return summary


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


def phase_timing(work: Path, model: TiTok, card: str) -> None:
    size = model.config.image_size
    rng = np.random.default_rng(1)
    for bs in (8, 64):
        d = work / f"t{bs}"
        export_tokenizer(model, str(d), bs=bs)
        x = rng.uniform(0, 1, (bs, size, size, 3)).astype(np.float32)
        served = load_exported(str(d), "cuda")
        xd = torch.from_numpy(x).cuda()
        idx = served["encode"](xd)
        direct = dict(
            encode_ms=host_median_ms(
                lambda: (served["encode"](xd), torch.cuda.synchronize())),
            decode_ms=host_median_ms(
                lambda: (served["decode"](idx), torch.cuda.synchronize())))
        with plain_versions():
            direct["plain_encode_ms"] = host_median_ms(
                lambda: (served["encode"](xd), torch.cuda.synchronize()))
            direct["plain_decode_ms"] = host_median_ms(
                lambda: (served["decode"](idx), torch.cuda.synchronize()))
        del served
        with serving(str(d), batch_window_ms=0) as url:
            idx_np = post(url + "/encode", x)
            http = dict(
                encode_ms=host_median_ms(lambda: post(url + "/encode", x)),
                decode_ms=host_median_ms(lambda: post(url + "/decode", idx_np)))
        http["encode_images_per_s"] = bs / http["encode_ms"] * 1e3
        http["decode_images_per_s"] = bs / http["decode_ms"] * 1e3
        http["encode_decode_images_per_s"] = bs / (
            http["encode_ms"] + http["decode_ms"]) * 1e3
        emit("timing", bs=bs, card=card, http_per_request=http,
             device_call=direct)
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

    launches, fused = first_step("1", "1")
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
                lat = model.enc(images)
                idx = model.quant(lat)[1]
                enc_launches = read_launches()
                rec = model.decode_indices(idx)
                torch.cuda.synchronize()
                dec_launches = read_launches()
                serve[name] = dict(
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


def loss_and_grad_norm(model: VideoGPT, tokens: torch.Tensor):
    """The step's loss and the global norm of its gradients, without the
    optimizer."""
    _, loss = model(tokens)
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
    return model.eval(), tokens, launches


def phase_videogpt_rollout(work: Path, model: VideoGPT, tokens: torch.Tensor,
                           card: str) -> dict:
    """The greedy rollout served over HTTP at bs 1 and bs 8: 8 frames of
    codes in, 16 out. Returns the launches of the served rollouts."""
    frame = VIDEOGPT["frame_size"]
    n_cond, n_gen = ROLLOUT_COND * frame, ROLLOUT_GEN * frame
    cond_all = tokens[:8, :ROLLOUT_COND].reshape(8, n_cond)
    cond_np = cond_all.cpu().numpy()
    launches, results = {}, {}
    for bs in (1, 8):
        d = work / f"videogpt_bs{bs}"
        export_videogpt(model, str(d), cond_frames=ROLLOUT_COND,
                        gen_frames=ROLLOUT_GEN, bs=bs)
        cond = cond_np[:bs]
        with serving(str(d), batch_window_ms=0) as url:
            reset_launches()   # the main path's run starts here
            served = post(url + "/generate", cond)
            launches[bs] = read_launches()
            latency = host_median_ms(lambda: post(url + "/generate", cond), 3)
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
        loaded = load_exported(str(d), "cuda")
        direct = loaded["generate"](cond).cpu().numpy()
        require(np.array_equal(served, direct),
                "the served rollout differs from a direct generate call")
        results[bs] = dict(latency_ms=latency,
                           generated_tokens_per_s=bs * n_gen / latency * 1e3,
                           launches=launches[bs])
        del loaded
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
    # frame (the prefill and 63 decode steps; a profile of all 511 steps
    # would hold some 10^6 events).
    cond8 = torch.from_numpy(cond_np)
    results[8]["profile_one_frame"] = profile_window(
        lambda: generate(model, cond8, frame))
    err = rel_errors(logits, plain)
    first, plain_first = logits.argmax(-1), plain.argmax(-1)
    rows = torch.arange(8, device="cuda")
    gap = (plain[rows, plain_first] - plain[rows, first]).max().item()
    emit("videogpt_rollout", card=card, cond_codes=n_cond, gen_codes=n_gen,
         bs1=results[1], bs8=results[8], prefill_logits=err,
         first_code_equal=int((first == plain_first).sum()),
         first_code_max_gap=gap,
         tolerance=dict(prefill_max_rel=PREFILL_MAX_REL))
    require(err["max_rel"] <= PREFILL_MAX_REL,
            f"prefill logits vs plain versions: {err}")
    require(gap <= 2 * err["max_abs"],
            f"a first generated code differs beyond a near-tie: gap {gap}")
    return {k: launches[1][k] + launches[8][k] for k in launches[1]}


def main() -> None:
    card = phase_device()
    phase_build()
    summary = phase_kernels()

    cfg = TiTokConfig(**FLAGSHIP)
    model = TiTok(cfg)
    init_params_(model, torch.Generator().manual_seed(0))
    emit("model", params=sum(p.numel() for p in model.parameters()),
         config=FLAGSHIP, dtype="bfloat16 compute, float32 params")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        launches = phase_slice(Path(tmp), model)
        phase_timing(Path(tmp), model, card)
        weights = copy.deepcopy(model.state_dict())
        perceptual, images = train_inputs(model)
        train_launches = phase_train(model, perceptual, images, card)
        fused_launches = phase_train_fused(model, weights, perceptual,
                                           images, card)
        del model, weights, perceptual, images
        torch.cuda.empty_cache()
        gpt, tokens, gpt_launches = phase_videogpt_train(card)
        rollout_launches = phase_videogpt_rollout(Path(tmp), gpt, tokens,
                                                  card)
    for path in (train_launches, fused_launches, gpt_launches,
                 rollout_launches):
        for name, n in path.items():
            launches[name] = launches.get(name, 0) + n

    sources = {
        "attention_packed_fwd": ("vit_tpu_torch/csrc/attention_packed_fwd.cu",
                                 "vit_tpu/kernels/attention.py:623"),
        "attention_packed_bwd": ("vit_tpu_torch/csrc/attention_packed_bwd.cu",
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
    }
    also = {"attention_bwd": "vit_tpu/kernels/attention.py:201"}
    missing = [name for name in sources if launches.get(name, 0) == 0]
    require(not missing, f"kernels of the paths never launched: {missing}")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": launches[name],
         **summary[name],
         **({"also_replaces": also[name]} if name in also else {})}
        for name in sources]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
