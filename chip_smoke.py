"""End-to-end smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, the TiTok-B tokenizer served over HTTP
(images → /encode → indices → /decode → images) at the flagship width
(image 128, patch 16, 256 latent tokens, codebook 2048 × 12, ViT-B encoder
and decoder, S = 320), with random weights from a seed. Phases, one JSON
line each:

  1. device  — fails without CUDA; card name and power limit; TF32 off;
  2. build   — compiles the CUDA kernels from ``vit_tpu_torch/csrc``;
  3. kernels — each kernel against its plain PyTorch version on the card,
               at the slice's shapes and a few edge shapes, with timings;
  4. slice   — export → load → HTTP server; concurrent /encode requests,
               /decode of the indices; checks shapes, ranges, a 400, that
               every kernel launched during those requests, that the served
               codes equal a direct call of the kernels, and that the same
               weights run through the plain versions agree: latents and
               images within bf16 noise, every differing code a near-tie;
  5. timing  — encode and decode latency per request and images/s at bs 8
               and bs 64.

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
from vit_tpu_torch.kernels import vq as k_vq  # noqa: E402
from vit_tpu_torch.models.titok import TiTok, TiTokConfig  # noqa: E402
from vit_tpu_torch.serve.export import export_tokenizer, load_exported  # noqa: E402
from vit_tpu_torch.serve.server import make_server  # noqa: E402
from vit_tpu_torch.utils.init import init_params_  # noqa: E402

FLAGSHIP = dict(image_size=128, patch_size=16, latent_tokens=256,
                codebook_size=2048, latent_dim=12, transformer="B")
K1_MAX_ABS, K1_MEAN_ABS = 2e-2, 2e-3   # bf16 p is rounded at other places
K5_TIE_GAP = 1e-6                      # fp32 sums in another order
# Kernels vs plain versions through the whole bf16 model: one ulp of
# difference in attention spreads through the residual stream's bf16
# roundings. Measured on an H100 with these random weights: latents 0.7%
# apart, 98.2% of codes equal; two plain attention variants (p normalised
# before or after the bf16 cast) agree on 98.3% of codes.
MAX_REL_ERR = 2e-2
MIN_INDEX_AGREEMENT = 0.95


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
    k_attn.launches = 0
    k_vq.launches = 0


@contextlib.contextmanager
def plain_versions():
    """Route the model's two kernel call sites to the kernels' plain
    versions, on whatever device the tensors are: the reference run."""
    import vit_tpu_torch.ops.attention as ops_attn
    import vit_tpu_torch.quantize.vq as quant_vq

    def attention_plain(qkv, n_heads, *, causal=False, qkv_bias=None):
        return k_attn.flash_attention_packed_ref(qkv, qkv_bias, n_heads, causal)

    saved = ops_attn.flash_attention_packed, quant_vq.nearest_code
    ops_attn.flash_attention_packed = attention_plain
    quant_vq.nearest_code = k_vq.nearest_code_ref
    try:
        yield
    finally:
        ops_attn.flash_attention_packed, quant_vq.nearest_code = saved


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
    emit("build", seconds=time.perf_counter() - t0, library=Path(lib._name).name)


def phase_kernels() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    summary = {}

    # K1: bf16 with bias; the slice's shape, a ragged causal tile, longest S
    k1_max, k1_rows = 0.0, []
    for b, s, causal in [(8, 320, False), (3, 77, True), (2, 768, False)]:
        h, width = 12, 768
        qkv = torch.randn(b, s, 3 * width, device="cuda",
                          generator=gen).bfloat16()
        bias = 0.3 * torch.randn(3 * width, device="cuda", generator=gen)
        out = k_attn.flash_attention_packed(qkv, h, causal=causal,
                                            qkv_bias=bias)
        torch.cuda.synchronize()
        ref = k_attn.flash_attention_packed_ref(qkv, bias, h, causal)
        diff = (out.float() - ref.float()).abs()
        row = dict(B=b, S=s, H=h, causal=causal, max_abs=diff.max().item(),
                   mean_abs=diff.mean().item())
        k1_rows.append(row)
        require(bool(torch.isfinite(out).all()), f"K1 non-finite at {row}")
        require(row["max_abs"] <= K1_MAX_ABS and row["mean_abs"] <= K1_MEAN_ABS,
                f"K1 disagrees with its plain version: {row}")
        k1_max = max(k1_max, row["max_abs"])
    times = {}
    for bs in (8, 64):
        qkv = torch.randn(bs, 320, 3 * 768, device="cuda",
                          generator=gen).bfloat16()
        bias = torch.randn(3 * 768, device="cuda", generator=gen)
        times[bs] = (
            median_ms(lambda: k_attn.flash_attention_packed(
                qkv, 12, qkv_bias=bias)),
            median_ms(lambda: k_attn.flash_attention_packed_ref(
                qkv, bias, 12, False)))
    emit("kernel", name="attention_packed_fwd", parity=k1_rows,
         tolerance=dict(max_abs=K1_MAX_ABS, mean_abs=K1_MEAN_ABS),
         ms_bs8=times[8][0], plain_ms_bs8=times[8][1],
         ms_bs64=times[64][0], plain_ms_bs64=times[64][1],
         shape="(bs, S 320, 3·768) bf16, 12 heads")
    summary["attention_packed_fwd"] = dict(max_abs_err=k1_max,
                                           ms=times[8][0],
                                           plain_ms=times[8][1])

    # K5: fp32, C 2048, D 12; identical indices except at near-ties
    k5_gap, k5_rows = 0.0, []
    for n in (2048, 2053):
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
            off = 0.0 if l2 else 0.5 * (e64 * e64).sum(-1)

            def score(rows, cols):
                o = off if l2 else off[cols]
                return (z64[rows] * e64[cols]).sum(-1) - o

            gap = (score(bad, idx[bad]) - score(bad, ref[bad])).abs()
            worst = gap.max().item() if len(bad) else 0.0
            k5_rows.append(dict(N=n, C=2048, D=12, l2_normalize=l2,
                                near_ties=len(bad), max_tie_gap=worst))
            require(worst <= K5_TIE_GAP,
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

    sources = {"attention_packed_fwd": ("vit_tpu_torch/csrc/attention_packed_fwd.cu",
                                        "vit_tpu/kernels/attention.py:623"),
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
