"""End-to-end smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two main paths at the flagship width (image 128, patch
16, 256 latent tokens, codebook 2048 × 12, ViT-B encoder and decoder,
S = 320), with random weights from a seed: the TiTok-B tokenizer served over
HTTP (images → /encode → indices → /decode → images), and the flagship
TiTok-B training step at bs 64 with the frozen ConvNeXt-S perceptual loss.
Phases, one JSON line each:

  1. device  — fails without CUDA; card name and power limit; TF32 off;
  2. build   — compiles the CUDA kernels from ``vit_tpu_torch/csrc``, one
               nvcc per source in parallel; registers and spills per kernel;
  3. kernels — each kernel against its plain PyTorch version on the card,
               at the paths' shapes and a few edge shapes, with timings;
  4. slice   — export → load → HTTP server; concurrent /encode requests,
               /decode of the indices; checks shapes, ranges, a 400, that
               every kernel launched during those requests, that the served
               codes equal a direct call of the kernels, and that the same
               weights run through the plain versions agree: latents and
               images within bf16 noise, every differing code a near-tie;
  5. timing  — encode and decode latency per request and images/s at bs 8
               and bs 64;
  6. train   — the flagship step (TiTok-B, bs 64, perceptual loss, clip,
               AdamW with a bf16 first moment): the launches of one step
               (K1 24, K2 24, K3 66, K4 33, K5 1); the same first step from
               a deep copy through the plain versions, loss, perceptual loss
               and gradient norm within bf16 noise; 20 steps on one batch
               with a short warmup lower the recon loss; images/s and peak
               memory with the kernels and with the plain versions.

Then the kernels' summary line, the card's name and power limit, and as the
last line ``{"ok": true, "device": {...}}``. Any failure raises, so the
script exits non-zero without that line. It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
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

ROOT = Path(__file__).resolve().parent
if not (ROOT / "vit_tpu_torch" / "__init__.py").exists():
    raise SystemExit(f"chip_smoke.py: no vit_tpu_torch package beside it in {ROOT}")
sys.path.insert(0, str(ROOT))

from vit_tpu_torch.kernels import _build  # noqa: E402
from vit_tpu_torch.kernels import attention as k_attn  # noqa: E402
from vit_tpu_torch.kernels import convnext_block as k_cnx  # noqa: E402
from vit_tpu_torch.kernels import vq as k_vq  # noqa: E402
from vit_tpu_torch.losses.perceptual import ConvNeXt, PerceptualLoss  # noqa: E402
from vit_tpu_torch.models.titok import TiTok, TiTokConfig  # noqa: E402
from vit_tpu_torch.serve.export import export_tokenizer, load_exported  # noqa: E402
from vit_tpu_torch.serve.server import make_server  # noqa: E402
from vit_tpu_torch.train.optim import make_optimizer  # noqa: E402
from vit_tpu_torch.train.state import TrainState  # noqa: E402
from vit_tpu_torch.train.step import make_tokenizer_train_step  # noqa: E402
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
STEP_LAUNCHES = dict(attention_packed_fwd=24, attention_packed_bwd=24,
                     convnext_tail_fwd=66, convnext_tail_bwd=33, vq_nearest=1)


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
    k_cnx.launches = k_cnx.bwd_launches = 0
    k_vq.launches = 0


def read_launches() -> dict:
    return dict(attention_packed_fwd=k_attn.launches,
                attention_packed_bwd=k_attn.bwd_launches,
                convnext_tail_fwd=k_cnx.launches,
                convnext_tail_bwd=k_cnx.bwd_launches,
                vq_nearest=k_vq.launches)


@contextlib.contextmanager
def plain_versions():
    """Route every kernel call site to the kernel's plain version, on
    whatever device the tensors are: the reference run. The autograd
    Functions look the kernels up in their modules when they run, so the
    forward, the backward and inference all follow."""
    import vit_tpu_torch.quantize.vq as quant_vq

    routes = [(k_attn, "attention_packed_fwd", k_attn.attention_packed_fwd_ref),
              (k_attn, "attention_packed_bwd", k_attn.attention_packed_bwd_ref),
              (k_cnx, "convnext_tail_fwd", k_cnx.convnext_tail_fwd_ref),
              (k_cnx, "convnext_tail_bwd", k_cnx.convnext_tail_bwd_ref),
              (quant_vq, "nearest_code", k_vq.nearest_code_ref)]
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
    ptxas = [line.strip() for line in
             (log.read_text().splitlines() if log.exists() else [])
             if "registers" in line or "spill" in line
             or "Compiling entry" in line]
    emit("build", seconds=seconds, library=Path(lib._name).name, ptxas=ptxas)


def phase_kernels() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    summary = {}

    # K1: bf16 with bias; the serving and train steps' shapes, a ragged
    # causal tile, longest S. With stats the output must be the same bits,
    # m and l fp32-close.
    k1_max, k1_rows = 0.0, []
    for b, s, causal in [(8, 320, False), (TRAIN_BS, 320, False),
                         (3, 77, True), (2, 768, False)]:
        h, width = 12, 768
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
    emit("kernel", name="attention_packed_fwd", parity=k1_rows,
         tolerance=dict(max_abs=K1_MAX_ABS, mean_abs=K1_MEAN_ABS,
                        stats_rel=K1_STATS_REL),
         ms_bs8=times[8][0], stats_ms_bs8=times[8][1],
         plain_ms_bs8=times[8][2], ms_bs64=times[64][0],
         stats_ms_bs64=times[64][1], plain_ms_bs64=times[64][2],
         shape="(bs, S 320, 3·768) bf16, 12 heads")
    summary["attention_packed_fwd"] = dict(max_abs_err=k1_max,
                                           ms=times[64][1],
                                           plain_ms=times[64][2])

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
    emit("kernel", name="attention_packed_bwd", parity=k2_rows,
         tolerance=dict(max_rel=BWD_MAX_REL, mean_rel=BWD_MEAN_REL),
         ms_bs64=k2_ms, plain_ms_bs64=k2_plain,
         shape="(64, S 320, 3·768) bf16, 12 heads")
    summary["attention_packed_bwd"] = dict(max_abs_err=k2_max, ms=k2_ms,
                                           plain_ms=k2_plain)

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
    for name, t in tails.items():
        emit("kernel", name=name, parity=t["rows"],
             tolerance=dict(max_rel=BWD_MAX_REL, mean_rel=BWD_MEAN_REL),
             ms_by_C=t["ms"], plain_ms_by_C=t["plain_ms"],
             shape="(bs 64 · H · W, C) bf16 rows of ConvNeXt-S stages 0-2",
             summary_shape="C 384, N 12544 (27 of the 33 fused blocks)")
        summary[name] = dict(max_abs_err=t["max"], ms=t["ms"][384],
                             plain_ms=t["plain_ms"][384])

    # K5: fp32, C 2048, D 12, at the encode's and the train step's N and a
    # ragged N. Scores z·e (− ‖e‖²/2 without normalisation) in fp64 judge
    # both: the kernel's code must be the fp64 best within K5_TIE_GAP on
    # every row, and where the plain version picks another code, that code
    # must be within the plain version's own rounding of the best.
    k5_gap, k5_rows = 0.0, []
    for n in (2048, TRAIN_BS * 256, 2053):
        for l2 in (True, False):
            z = torch.randn(n, 12, device="cuda", generator=gen)
            cb = (torch.rand(2048, 12, device="cuda", generator=gen) * 2 - 1
                  ) / 2048
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
                N=n, C=2048, D=12, l2_normalize=l2, near_ties=len(bad),
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
    emit("kernel", name="vq_nearest", parity=k5_rows,
         tolerance=dict(tie_gap=K5_TIE_GAP), lowest_index_ties=True,
         dims_checked=list(k_vq.SUPPORTED_DIMS),
         ms_bs8=times[8][0], plain_ms_bs8=times[8][1],
         ms_bs64=times[64][0], plain_ms_bs64=times[64][1],
         shape="(bs·256, 12) fp32 against (2048, 12)")
    summary["vq_nearest"] = dict(max_abs_err=k5_gap, ms=times[8][0],
                                 plain_ms=times[8][1])
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

    # Any ulp of difference in attention flips bf16 roundings of the residual
    # stream, so latents differ at bf16 level and codes whose two best
    # scores lie closer than that flip. Each disagreement must be such a
    # near-tie: with unit latents zk (kernels) and zp (plain), the plain
    # scores of the two codes differ by at most 2·|zk − zp|.
    lat_rel = ((kernel_lat - plain_lat).abs().max() / plain_lat.abs().max()).item()
    zk = torch.nn.functional.normalize(kernel_lat.reshape(-1, cfg.latent_dim), dim=-1)
    zp = torch.nn.functional.normalize(plain_lat.reshape(-1, cfg.latent_dim), dim=-1)
    e = torch.nn.functional.normalize(ref.quant.codebook.double(), dim=-1)
    ik = torch.from_numpy(served_idx.reshape(-1)).long().cuda()
    ip = torch.from_numpy(plain_idx.reshape(-1)).long().cuda()
    bad = (ik != ip).nonzero().flatten()
    gap = ((zp[bad] * e[ip[bad]]).sum(-1) - (zp[bad] * e[ik[bad]]).sum(-1))
    slack = 2 * (zk[bad] - zp[bad]).norm(dim=-1) + 1e-6
    unexplained = int((gap > slack).sum())
    agreement = float((served_idx == plain_idx).mean())
    rec_all = np.concatenate(recons)
    rec_rel = float(np.abs(rec_all - plain_rec).max() / np.abs(plain_rec).max())
    emit("slice", requests=len(batches), images=sum(map(len, batches)),
         launches=launches, encode_index_agreement=agreement,
         disagreeing_codes=len(bad), unexplained_disagreements=unexplained,
         latent_max_rel_err=lat_rel, decode_max_rel_err=rec_rel,
         tolerance=dict(max_rel_err=MAX_REL_ERR,
                        min_index_agreement=MIN_INDEX_AGREEMENT))
    require(unexplained == 0, f"{unexplained} code disagreements are not "
            "near-ties of the measured latent difference")
    require(lat_rel <= MAX_REL_ERR and rec_rel <= MAX_REL_ERR,
            f"kernels vs plain: latent {lat_rel:.3g}, decode {rec_rel:.3g}")
    require(agreement >= MIN_INDEX_AGREEMENT,
            f"served encode agrees with the plain run on {agreement:.4f}")
    total = {k: launches["encode"][k] + launches["decode"][k]
             for k in launches["encode"]}
    return total


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


def phase_train(model: TiTok, card: str) -> dict:
    """The flagship training step: launches, kernels vs plain versions,
    learning on one batch, and throughput. Returns the step's launches."""
    model = model.cuda().train()
    net = ConvNeXt(dtype=torch.bfloat16)
    init_convnext_(net, torch.Generator().manual_seed(1))
    perceptual = PerceptualLoss(net).cuda()
    size = model.config.image_size
    images = torch.from_numpy(np.random.default_rng(2).uniform(
        0, 1, (TRAIN_BS, size, size, 3)).astype(np.float32)).cuda()
    tx = make_optimizer(1e-4, 5000, 1_000_000, 1e-5, 1e-4, clip_norm=1.0)
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
    train_launches = phase_train(model, card)
    for name, n in train_launches.items():
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
                       "vit_tpu/kernels/vq.py:36")}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": launches[name],
         **summary[name]} for name in sources]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
