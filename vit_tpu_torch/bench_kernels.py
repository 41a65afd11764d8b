"""Time the bf16 kernels, the fp32 kernels that were redesigned on the
tensor cores (attention, K3, K4) with K9c, and ten train steps of one or
more checkouts of this repo on one card, in turns, so that two versions
are compared within one call.

    python -m vit_tpu_torch.bench_kernels --trees OLD . . OLD \
        [--out chiprun_out/bench_kernels.json] [--groups ...] [--steps ...]

Each entry of ``--trees`` is a checkout's root; each runs in a process of
its own that imports ``vit_tpu_torch`` from that checkout, builds its
kernels into that checkout's ``build/`` and times K1 (with statistics; and
without, at the serving bs 8), K2, K3 and K4 (at ConvNeXt-S's three fused
stages: C 96, 192 and 384, the last under the keys "K3" and "K4"; and as 20
back-to-back calls, "K3 C96 x20" and the like), K5, K6 (with statistics),
K8, K9a, K9b, K9c (also "K9c x20" and "K9c dev", and the library's
LayerNorm backward beside it, "K9c lib", "K9c lib x20", "K9c lib dev":
:func:`time_ln_bwd`), K10, K12a and K12b (at the three fused stages like
K3, "K12a C96", "K12a C96 x20", "K12a C96 dev", ...), the dropout arms of
K1/K2
(ViT-L's (64, 257, 16 heads) at rate 0.15) and K6/K8 (rate 0.1), K7 at (2,
12, 513) and K6 on the rollout's prefill (513 causal, bs 8 and 1), at
``chip_smoke.py``'s shapes: CUDA-event medians of 20 calls after 3, the
same seeded inputs in every process; K11a and K11b's dx-only and full forms
at ConvNeXt-S's four stages in bf16 and fp32 beside cuDNN's calls
(:func:`time_depthwise`, also on the card alone, "dev"), and one
perceptual-loss call (loss and image gradient) under each ``dw_impl``, its
wall time and, profiled, the card's busy time and K11's share of it
(:func:`perceptual_ms`), and K11's mean distances from its plain versions
("k11_mean_rel" in the JSON line, :func:`depthwise_mean_rel`); then K9c on
fp32 rows at (20480, 768) as the bf16 one ("K9c fp32", "K9c fp32 dev", "K9c
fp32 lib dev", ...), K3 and K4 on fp32 rows at the three fused stages
("K3 fp32 C96", "K4 fp32 C96 x20", "K4 fp32 C96 dev", ...) with the
weights' pre-split alone where the tree has one ("K3 fp32 split C96 dev",
...; :func:`time_tail_f32`), and the attention kernels on fp32 operands
(``--mixed false``) at ``chip_smoke.py``'s fp32 shapes: K1 and K2 at (64,
320, 12 heads) with statistics and at ViT-L's (64, 257, 16 heads) with
dropout 0.15, K6 and K8 at (32, 12, 1024) causal without and with dropout
0.1, K7 at (2, 12, 513) causal ("K1 fp32", "K2 fp32 dropout", ...; and 20
back to back, "K1 fp32 x20", ...). Each turn also reads the fp32 forwards'
mean distances (o, m and l; K1, K6 and their dropout arms, and K6 at K7's
shape) from the plain fp32 version and from the float64 forward
(:func:`exact_attention_fwd`), with the two-part control's (the plain
version on operands rounded to two bf16 parts) beside them ("fwd_mean_rel"
in its JSON line). Each turn then times ten train steps with the names of
that checkout's root ``chip_smoke.py``: the VideoGPT-B bs-32 step, the
flagship TiTok-B unfused bs-64 step, the same with the int8 perceptual
loss and the ViT-L/16 @256 bs-64 step at dropout 0.15 in bf16, the
VideoGPT-B, ViT-L/16 and flagship unfused steps at float32, then the
flagship step under ``VIT_TPU_FUSED_LN=1 VIT_TPU_FUSED_FC=1`` (set for that
step only) in bf16 and float32 and under ``VIT_TPU_FUSED_LN=0
VIT_TPU_FUSED_FC=1`` in bf16 ("TiTok-B fused-FC step") (``TiTok``,
``VideoGPT``, ``ConvNeXt``, ``PerceptualLoss``, ``FLAGSHIP``,
``VIT_CELLS``, ``train_inputs``, ``vit_batch``, the step makers,
``make_optimizer``, ``host_median_ms`` and the rest used in
``videogpt_step_ms``, ``titok_step_ms`` and ``vit_step_ms``), so every root
must carry one that defines them. The two unfused bf16 TiTok-B steps and
both fused ones are also profiled: the card's busy time and the ConvNeXt
tails' and K9a's kernel time in a step ("TiTok-B int8 step busy",
"TiTok-B int8 step K12a", "TiTok-B fused step K9a", ...), and every
kernel's launches and time ("step_kernels" in ``--out``). ``--groups``
picks what a turn times (``q8``: K12a and K12b alone, bf16 and fp32 rows,
at every fused width; ``queue``: K9a at qkv and fc1, single, x20, in its
serving form and beside ``F.linear``, K9b and K10, in both dtypes, and K5,
on the card alone; ``k10``: the bf16 K10 forced to each split count, its
with and without its ordered sum) and ``--steps`` which steps. TF32 is off for cuBLAS
and cuDNN. Prints one JSON line per turn and a table of each time by
checkout and turn."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

N_ROWS = 64 * 320          # the flagship step's rows: bs 64 · S 320
TAIL_ROWS, TAIL_C = 64 * 14 * 14, 384   # ConvNeXt-S stage 2 at bs 64
# (rows, C) of ConvNeXt-S's three fused stages at bs 64 (stage 2 last)
TAIL_STAGES = ((64 * 56 * 56, 96), (64 * 28 * 28, 192), (TAIL_ROWS, TAIL_C))


def median_ms(fn, reps: int = 20) -> float:
    import torch

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
    return sorted(times)[reps // 2]


def batched_ms(fn, calls: int = 20) -> float:
    """ms a call of ``fn`` called ``calls`` times back to back between two
    events (median of 5): the launches queue ahead of the card, so a kernel
    longer than its wrapper's host time is timed without that host time,
    which a single call's events include."""
    def run():
        for _ in range(calls):
            fn()
    return median_ms(run, 5) / calls


def time_kernels() -> dict:
    """{kernel: ms} of the bf16 kernels of the ``vit_tpu_torch`` on the
    path, at chip_smoke.py's timing shapes."""
    import torch

    from vit_tpu_torch.kernels import attention as k_attn
    from vit_tpu_torch.kernels import convnext_block as k_cnx
    from vit_tpu_torch.kernels import fc_grad as k_fc
    from vit_tpu_torch.kernels import ln_matmul as k_lnmm
    from vit_tpu_torch.kernels import vq as k_vq

    gen = torch.Generator(device="cuda").manual_seed(0)

    def r(*shape, scale=1.0):
        return scale * torch.randn(*shape, device="cuda", generator=gen)

    def seed():
        return k_attn.seed_vec(torch.randint(
            0, 2 ** 31 - 1, (1,), device="cuda", generator=gen,
            dtype=torch.int32))

    ms = {}
    qkv, bias = r(64, 320, 3 * 768).bfloat16(), r(3 * 768)
    dout = r(64, 320, 768).bfloat16()
    _, m, l = k_attn.attention_packed_fwd(qkv, bias, 12, False,
                                          emit_stats=True)
    ms["K1"] = median_ms(lambda: k_attn.attention_packed_fwd(
        qkv, bias, 12, False, emit_stats=True))
    ms["K1 bs8"] = median_ms(lambda: k_attn.attention_packed_fwd(
        qkv[:8], bias, 12, False))
    ms["K2"] = median_ms(lambda: k_attn.attention_packed_bwd(
        qkv, bias, dout, m, l, 12, False))
    qkv, bias = r(64, 257, 3 * 1024).bfloat16(), r(3 * 1024)
    dout = r(64, 257, 1024).bfloat16()
    drop = dict(dropout_rate=0.15, seed=seed())
    _, m, l = k_attn.attention_packed_fwd(qkv, bias, 16, False, True, **drop)
    ms["K1 dropout"] = median_ms(lambda: k_attn.attention_packed_fwd(
        qkv, bias, 16, False, True, **drop))
    ms["K2 dropout"] = median_ms(lambda: k_attn.attention_packed_bwd(
        qkv, bias, dout, m, l, 16, False, **drop))
    del qkv, dout, m, l

    for rows, c in TAIL_STAGES:
        h, x, dy = (r(rows, c).bfloat16() for _ in range(3))
        lns, lnb = 1.0 + r(c, scale=0.1), r(c, scale=0.1)
        w1, b1 = r(4 * c, c, scale=c ** -0.5), r(4 * c, scale=0.1)
        w2, b2 = r(c, 4 * c, scale=(4 * c) ** -0.5), r(c, scale=0.1)
        gamma = r(c, scale=0.5)
        fwd = (h, x, lns, lnb, w1, b1, w2, b2, gamma, 1e-6)
        bwd = (h, dy, lns, lnb, w1, b1, w2, gamma, 1e-6)
        # "K3"/"K4" alone: stage 2, the key earlier trees' output carries
        tag = "" if c == TAIL_C else f" C{c}"
        ms["K3" + tag] = median_ms(lambda: k_cnx.convnext_tail_fwd(*fwd))
        ms["K4" + tag] = median_ms(lambda: k_cnx.convnext_tail_bwd(*bwd))
        # back to back, so the card and not the wrapper's host time sets it
        ms[f"K3 C{c} x20"] = batched_ms(lambda: k_cnx.convnext_tail_fwd(*fwd))
        ms[f"K4 C{c} x20"] = batched_ms(lambda: k_cnx.convnext_tail_bwd(*bwd))
        ms.update(time_q8(fwd, bwd))
        del h, x, dy, fwd, bwd

    z = r(8 * 256, 12)
    cb = (torch.rand(2048, 12, device="cuda", generator=gen) * 2 - 1) / 2048
    ms["K5"] = median_ms(lambda: k_vq.nearest_code(z, cb))

    q, k, v = r(32, 1024, 3, 12, 64).bfloat16().permute(2, 0, 3, 1, 4)
    do = r(32, 1024, 12, 64).bfloat16().transpose(1, 2)
    _, m, l = k_attn.attention_fwd(q, k, v, True, emit_stats=True)
    ms["K6"] = median_ms(lambda: k_attn.attention_fwd(q, k, v, True,
                                                      emit_stats=True))
    ms["K8"] = median_ms(lambda: k_attn.attention_bwd(q, k, v, do, m, l,
                                                      True))
    drop = dict(dropout_rate=0.1, seed=seed())
    ms["K6 dropout"] = median_ms(lambda: k_attn.attention_fwd(
        q, k, v, True, True, **drop))
    _, m, l = k_attn.attention_fwd(q, k, v, True, True, **drop)
    ms["K8 dropout"] = median_ms(lambda: k_attn.attention_bwd(
        q, k, v, do, m, l, True, **drop))
    del q, k, v, do, m, l
    # K7's (2, 12, 513) and the rollout's prefill (513 causal at bs 8 and 1)
    q, k, v = r(3, 2, 12, 513, 64).bfloat16()
    do = r(2, 513, 12, 64).bfloat16().transpose(1, 2)
    _, m, l = k_attn.attention_fwd(q, k, v, True, emit_stats=True)
    ms["K7"] = median_ms(lambda: k_attn.attention_bwd(q, k, v, do, m, l,
                                                      True))
    q, k, v = r(8, 513, 3, 12, 64).bfloat16().permute(2, 0, 3, 1, 4)
    ms["K6 prefill bs8"] = median_ms(lambda: k_attn.attention_fwd(q, k, v,
                                                                  True))
    ms["K6 prefill bs1"] = median_ms(lambda: k_attn.attention_fwd(
        q[:1], k[:1], v[:1], True))
    del q, k, v, do, m, l

    ms.update(time_depthwise(r))

    x = (3 * r(N_ROWS, 768) + 1).bfloat16()
    w = r(3072, 768, scale=768 ** -0.5).bfloat16()
    b = r(3072, scale=0.3).bfloat16()
    ms["K9a"] = median_ms(lambda: k_lnmm.ln_matmul_fwd(x, w, b, True))
    zpre = r(N_ROWS, 3072, scale=2.0).bfloat16()
    dz = r(N_ROWS, 3072).bfloat16()
    ms["K9b"] = median_ms(lambda: k_lnmm.ln_matmul_dgelu(zpre, dz))
    g = r(N_ROWS, 768).bfloat16()
    ms.update(time_ln_bwd(x, g, "K9c"))
    x3 = r(N_ROWS, 3072).bfloat16()
    ms["K10"] = median_ms(lambda: k_fc.matmul_dw_db(g, x3))
    return ms


def time_queue() -> dict:
    """{row: ms} on the card alone (:func:`device_ms`) of the kernels that
    ROADMAP.md's Queue B ranks and no other group times there (the
    ``queue`` group): K9a at the flagship's two sites, qkv (20480, 768 →
    2304, no bias) and fc1 (→ 3072, bias and GELU), on bf16 and fp32 rows,
    also as 20 back-to-back calls, in its serving form (no residuals) and
    beside ``F.linear`` on x̂ ("K9a qkv dev", "K9a fp32 fc1 x20", "K9a qkv
    serving dev", "K9a fc1 lib dev", ...); K9b and K10 at
    :func:`time_kernels`' shapes ("K9b dev", "K10 fp32 dev", ...), K10 also
    as 20 back-to-back calls, at fc1 (g 3072 wide, x 768) and beside
    ``torch.mm`` for dW alone ("K10 fp32 x20", "K10 fp32 fc1 dev", "K10
    fp32 lib dev"), the bf16 K10 without its ordered sum where the tree
    has one (:func:`fc_grad_reduction_ms`: "K10 no-sum dev"; "K10 dev"
    less it is the sum's cost), and K5 at N 2048, 16384 (against 2048 codes) and 32768 (against
    1024) on the card alone and the host time of a call (:func:`host_ms`)
    ("K5 dev", "K5 N16384 dev", "K5 N32768 dev", "K5 host", ...)."""
    import torch
    import torch.nn.functional as F

    from vit_tpu_torch.kernels import fc_grad as k_fc
    from vit_tpu_torch.kernels import ln_matmul as k_lnmm
    from vit_tpu_torch.kernels import vq as k_vq

    gen = torch.Generator(device="cuda").manual_seed(0)

    def r(*shape, scale=1.0):
        return scale * torch.randn(*shape, device="cuda", generator=gen)

    ms = {}
    for dt, tag in ((torch.bfloat16, ""), (torch.float32, " fp32")):
        x = (3 * r(N_ROWS, 768) + 1).to(dt)
        xhat = k_lnmm.ln_matmul_fwd_ref(x, r(128, 768).to(dt))[2]
        for site, f, gelu in (("qkv", 2304, False), ("fc1", 3072, True)):
            w = r(f, 768, scale=768 ** -0.5).to(dt)
            b = r(f, scale=0.3).to(dt) if gelu else None
            key = f"K9a{tag} {site}"

            def call():
                k_lnmm.ln_matmul_fwd(x, w, b, gelu)

            ms[key + " dev"] = device_ms(call)
            ms[key + " x20"] = batched_ms(call)
            ms[key + " serving dev"] = device_ms(
                lambda: k_lnmm.ln_matmul_fwd(x, w, b, gelu, residuals=False))
            ms[key + " lib dev"] = device_ms(lambda: F.linear(xhat, w, b))
            del w, b
        zpre = r(N_ROWS, 3072, scale=2.0).to(dt)
        dz = r(N_ROWS, 3072).to(dt)
        ms[f"K9b{tag} dev"] = device_ms(
            lambda: k_lnmm.ln_matmul_dgelu(zpre, dz))
        g, x3 = r(N_ROWS, 768).to(dt), r(N_ROWS, 3072).to(dt)
        ms[f"K10{tag} dev"] = device_ms(lambda: k_fc.matmul_dw_db(g, x3))
        ms[f"K10{tag} x20"] = batched_ms(lambda: k_fc.matmul_dw_db(g, x3))
        ms[f"K10{tag} fc1 dev"] = device_ms(lambda: k_fc.matmul_dw_db(x3, g))
        ms[f"K10{tag} lib dev"] = device_ms(lambda: torch.mm(g.t(), x3))
        if dt == torch.bfloat16 and hasattr(k_fc, "splits_bf16"):
            ms["K10 no-sum dev"] = fc_grad_reduction_ms(g, x3)["no_sum_ms"]
        del x, xhat, zpre, dz, g, x3
        torch.cuda.empty_cache()
    # K5 at serving bs 8 (the key earlier trees carry), the train step's
    # and serving bs 64's N, and the VideoGPT step's against 1024 codes
    for n, c, key in ((8 * 256, 2048, "K5 dev"), (64 * 256, 2048, "K5 N16384 dev"),
                      (32 * 16 * 64, 1024, "K5 N32768 dev")):
        z = r(n, 12)
        cb = (torch.rand(c, 12, device="cuda", generator=gen) * 2 - 1) / c
        ms[key] = device_ms(lambda: k_vq.nearest_code(z, cb))
        # the wrapper's host time: the call a host-bound path waits on
        ms[key.replace(" dev", " host")] = host_ms(
            lambda: k_vq.nearest_code(z, cb))
    return ms


def never_last(tiles: int, device):
    """Counts for the bf16 K10's ``fc_grad`` entry that start far below
    zero, so that no block of a tile finds itself the last and none adds
    the partials: the kernel as it runs, without its ordered sum (dW left
    unwritten; a timing aid, 2³⁰ / splits calls before a count could
    reach zero)."""
    import torch

    return torch.full((tiles,), -2 ** 30, dtype=torch.int32, device=device)


def fc_grad_call(g, x, splits: int, counts):
    """A launcher of the bf16 K10 through the library's ``fc_grad`` entry
    at a forced split count, with ``counts`` (zeroed, or
    :func:`never_last`), into fresh dW, db and partials."""
    import torch

    from vit_tpu_torch.kernels import _build

    lib = _build.load()
    n, fo = g.shape
    fi = x.shape[1]
    dw = torch.empty(fo, fi, device=g.device)
    db = torch.empty(fo, device=g.device)
    part = torch.empty(max(splits, 2), fo, fi, device=g.device)
    part_db = torch.empty(max(splits, 2), fo, device=g.device)
    stream = torch.cuda.current_stream(g.device).cuda_stream

    def call():
        _build.check(lib, lib.fc_grad(
            g.data_ptr(), x.data_ptr(), dw.data_ptr(), db.data_ptr(),
            part.data_ptr(), part_db.data_ptr(), counts.data_ptr(), n, fo,
            fi, splits, stream), "fc_grad")
    return call


def fc_grad_reduction_ms(g, x) -> dict:
    """The bf16 K10's split count at (g, x) and its ordered sum timed
    apart, on the card alone (:func:`device_ms`): the wrapper's call
    (``ms``), the same launch with :func:`never_last` counts, every split's
    partial written and none added (``no_sum_ms``), and their difference,
    what the last blocks' sum of the partials costs (``sum_ms``)."""
    import torch

    from vit_tpu_torch.kernels import fc_grad as k_fc

    n, fo = g.shape
    fi = x.shape[1]
    tiles = k_fc.tiles_bf16(fo, fi)
    splits = k_fc.splits_bf16(n, tiles, torch.cuda.get_device_properties(
        g.device).multi_processor_count)
    out = dict(splits=splits,
               ms=device_ms(lambda: k_fc.matmul_dw_db(g, x)),
               no_sum_ms=device_ms(fc_grad_call(
                   g, x, splits, never_last(tiles, g.device))))
    out["sum_ms"] = out["ms"] - out["no_sum_ms"]
    return out


def time_k10_splits() -> dict:
    """{row: ms} of the bf16 K10 on the card alone (:func:`device_ms`) at
    fc2 (g 768 wide, x 3072) and fc1 over N 20480, forced to each split
    count through the library's ``fc_grad`` entry: as it runs ("K10 fc2 S5
    dev") and without its ordered sum (:func:`never_last`, "K10 fc2 S5
    no-sum dev"); a tree whose entry predates its counts argument times
    nothing (the ``k10`` group)."""
    import torch

    from vit_tpu_torch.kernels import _build
    from vit_tpu_torch.kernels import fc_grad as k_fc

    if not hasattr(k_fc, "tiles_bf16"):
        return {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    ms = {}
    for fo, fi, site in ((768, 3072, "fc2"), (3072, 768, "fc1")):
        g = torch.randn(N_ROWS, fo, device="cuda", generator=gen).bfloat16()
        x = torch.randn(N_ROWS, fi, device="cuda", generator=gen).bfloat16()
        tiles = k_fc.tiles_bf16(fo, fi)
        counts = _build.zeroed("fc_grad", tiles, torch.int32, g.device)
        for splits in (1, 3, 4, 5, 6, 7, 9, 11):
            ms[f"K10 {site} S{splits} dev"] = device_ms(
                fc_grad_call(g, x, splits, counts))
            if splits > 1:
                ms[f"K10 {site} S{splits} no-sum dev"] = device_ms(
                    fc_grad_call(g, x, splits, never_last(tiles, g.device)))
            torch.cuda.empty_cache()
        del g, x
        torch.cuda.empty_cache()
    return ms


def time_q8(fwd, bwd) -> dict:
    """{row: ms} of K12a and K12b on the arguments ``fwd`` and ``bwd`` (as
    :func:`time_kernels` draws them at one fused stage): single, x20, dev
    and the wrapper's host time (:func:`host_ms`). bf16 rows at C 384 give the single calls the keys "K12a" and
    "K12b", else "K12a C96" and the like; fp32 rows "K12a fp32 C96" and the
    like."""
    import torch

    from vit_tpu_torch.kernels import convnext_block as k_cnx

    c, fp32 = fwd[0].shape[1], fwd[0].dtype == torch.float32
    ms = {}
    for name, fn, args in (("K12a", k_cnx.convnext_tail_fwd_q8, fwd),
                           ("K12b", k_cnx.convnext_tail_bwd_q8, bwd)):
        key = f"{name} fp32 C{c}" if fp32 else f"{name} C{c}"
        single = name if c == TAIL_C and not fp32 else key
        ms[single] = median_ms(lambda: fn(*args))
        ms[key + " x20"] = batched_ms(lambda: fn(*args))
        ms[key + " dev"] = device_ms(lambda: fn(*args))
        ms[key + " host"] = host_ms(lambda: fn(*args))
    return ms


def time_q8_stages() -> dict:
    """:func:`time_q8` at ConvNeXt-S's three fused stages on bf16 and fp32
    rows (K12a and K12b alone, the ``q8`` group), inputs drawn as
    :func:`time_kernels` draws its tails'."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)

    def r(*shape, scale=1.0):
        return scale * torch.randn(*shape, device="cuda", generator=gen)

    ms = {}
    for rows, c in TAIL_STAGES:
        h, x, dy = (r(rows, c) for _ in range(3))
        lns, lnb = 1.0 + r(c, scale=0.1), r(c, scale=0.1)
        w1, b1 = r(4 * c, c, scale=c ** -0.5), r(4 * c, scale=0.1)
        w2, b2 = r(c, 4 * c, scale=(4 * c) ** -0.5), r(c, scale=0.1)
        gamma = r(c, scale=0.5)
        for dt in (torch.bfloat16, torch.float32):
            hd, xd, dyd = (t.to(dt) for t in (h, x, dy))
            ms.update(time_q8(
                (hd, xd, lns, lnb, w1, b1, w2, b2, gamma, 1e-6),
                (hd, dyd, lns, lnb, w1, b1, w2, gamma, 1e-6)))
            del hd, xd, dyd
        del h, x, dy
        torch.cuda.empty_cache()
    return ms


def time_ln_bwd(x, g, key: str) -> dict:
    """{row: ms} of K9c on (x, g) as a single call, 20 back to back ("x20")
    and on the card alone ("dev"), and the same of the library's LayerNorm
    backward without weight and bias, its saved mean and 1/σ made
    beforehand (K9c recomputes them; "lib")."""
    import torch

    from vit_tpu_torch.kernels import ln_matmul as k_lnmm

    c = x.shape[1]
    _, mean, rstd = torch.ops.aten.native_layer_norm(x, [c], None, None,
                                                     k_lnmm.EPS)
    def library():
        torch.ops.aten.native_layer_norm_backward(
            g, x, [c], mean, rstd, None, None, [True, False, False])

    ms = {}
    for name, fn in ((key, lambda: k_lnmm.ln_bwd(x, g)),
                     (key + " lib", library)):
        ms[name] = median_ms(fn)
        ms[name + " x20"] = batched_ms(fn)
        ms[name + " dev"] = device_ms(fn)
    return ms


def time_tail_f32(r) -> dict:
    """{row: ms} of K3 and K4 on fp32 rows at ConvNeXt-S's three fused
    stages ("K3 fp32 C96", "K4 fp32 C96", ...), single, x20 and dev, K12a
    and K12b on the same rows (:func:`time_q8`: "K12a fp32 C96", ...), and,
    where the tree has it, the weights' pre-split alone ("K3 fp32 split C96
    dev", ...)."""
    from vit_tpu_torch.kernels import convnext_block as k_cnx

    ms = {}
    for rows, c in TAIL_STAGES:
        h, x, dy = r(rows, c), r(rows, c), r(rows, c)
        lns, lnb = 1.0 + r(c, scale=0.1), r(c, scale=0.1)
        w1, b1 = r(4 * c, c, scale=c ** -0.5), r(4 * c, scale=0.1)
        w2, b2 = r(c, 4 * c, scale=(4 * c) ** -0.5), r(c, scale=0.1)
        gamma = r(c, scale=0.5)
        calls = {"K3": lambda: k_cnx.convnext_tail_fwd(
                     h, x, lns, lnb, w1, b1, w2, b2, gamma, 1e-6),
                 "K4": lambda: k_cnx.convnext_tail_bwd(
                     h, dy, lns, lnb, w1, b1, w2, gamma, 1e-6)}
        for kernel, fn in calls.items():
            name = f"{kernel} fp32 C{c}"
            ms[name] = median_ms(fn)
            ms[name + " x20"] = batched_ms(fn)
            ms[name + " dev"] = device_ms(fn)
        ms.update(time_q8((h, x, lns, lnb, w1, b1, w2, b2, gamma, 1e-6),
                          (h, dy, lns, lnb, w1, b1, w2, gamma, 1e-6)))
        if hasattr(k_cnx, "split_weights"):
            ms[f"K3 fp32 split C{c} dev"] = device_ms(
                lambda: k_cnx.split_weights(w1, w2))
        del h, x, dy, calls
    return ms


def device_ms(fn, calls: int = 20) -> float:
    """ms a call of ``fn`` on the card alone (median of 5): the ``calls``
    launches are queued behind a sleep kernel long enough for the host to
    queue them all, so the events time the card and none of the host."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        torch.cuda._sleep(10_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return sorted(times)[2]


def host_ms(fn, calls: int = 200) -> float:
    """ms of host time a call of ``fn`` takes to return, the launches queued
    and not waited for (the card catches up after the clock stops)."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - start
    torch.cuda.synchronize()
    return elapsed / calls * 1e3


def time_depthwise(r) -> dict:
    """{row: ms} of K11a, K11b's dx-only form and its full form at
    ConvNeXt-S's four stages at bs 64 (``chip_smoke.K11_STAGES``), bf16 and
    fp32, single calls, 20 back to back ("x20"), on the card alone ("dev",
    :func:`device_ms`) and the host time of a call ("host", :func:`host_ms`:
    at the small stages a call is host-bound), with cuDNN's channels-last
    ``F.conv2d`` and
    ``aten.convolution_backward`` (output mask [True, False, False] for dx
    alone, [True, True, True] in full) beside them. A tree whose K11b has
    no dx-only form times, as its "dx-only" rows, the full form: what its
    autograd Function launched for a frozen net."""
    import inspect

    import torch
    import torch.nn.functional as F

    from vit_tpu_torch.kernels import depthwise as k_dw

    has_dx_only = "dx_only" in inspect.signature(k_dw.depthwise_bwd).parameters
    ms = {}
    for stage, shape in enumerate(((64, 56, 56, 96), (64, 28, 28, 192),
                                   (64, 14, 14, 384), (64, 7, 7, 768))):
        c = shape[-1]
        for dtype in (torch.bfloat16, torch.float32):
            x, g = r(*shape).to(dtype), r(*shape).to(dtype)
            w, b = (r(7, 7, c) / 7).to(dtype), r(c).to(dtype)
            xc, gc = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
            wc = w.permute(2, 0, 1)[:, None].contiguous()
            kw = {"dx_only": True} if has_dx_only else {}

            def cudnn_bwd(mask):
                return lambda: torch.ops.aten.convolution_backward(
                    gc, xc, wc, [c], [1, 1], [3, 3], [1, 1], False, [0, 0],
                    c, mask)

            tag = f"s{stage}" + (" fp32" if dtype == torch.float32 else "")
            calls = {
                f"K11a {tag}": lambda: k_dw.depthwise_fwd(x, w, b),
                f"K11b dx-only {tag}": lambda: k_dw.depthwise_bwd(x, g, w,
                                                                  **kw),
                f"K11b full {tag}": lambda: k_dw.depthwise_bwd(x, g, w),
                f"cuDNN fwd {tag}": lambda: F.conv2d(xc, wc, b, padding=3,
                                                     groups=c),
                f"cuDNN dx-only {tag}": cudnn_bwd([True, False, False]),
                f"cuDNN full {tag}": cudnn_bwd([True, True, True])}
            for name, fn in calls.items():
                ms[name] = median_ms(fn)
                ms[name + " x20"] = batched_ms(fn)
                ms[name + " dev"] = device_ms(fn)
                ms[name + " host"] = host_ms(fn)
            del x, g, xc, gc
            torch.cuda.empty_cache()
    return ms


def depthwise_mean_rel() -> dict:
    """{"shape dtype": {output: mean |Δ| / mean |plain|, in fp32}} of the
    tree's K11a (y) and full K11b (dx, dw, db) against their plain versions
    at ConvNeXt-S's four stages at bs 64 and (3, 13, 37, 40), fp32 then
    bf16, x, g, w and b drawn in that order from one seed-0 generator: on
    the parent, the readings ``chip_smoke.K11_MEAN_REL`` (fp32 y and dx)
    and ``K11_DW_MEAN_REL`` (dw and db) are 10× the largest of."""
    import torch

    from vit_tpu_torch.kernels import depthwise as k_dw

    def rel(out, ref):
        return ((out.float() - ref.float()).abs().mean()
                / ref.float().abs().mean()).item()

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for shape in ((64, 56, 56, 96), (64, 28, 28, 192), (64, 14, 14, 384),
                  (64, 7, 7, 768), (3, 13, 37, 40)):
        c = shape[-1]
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(*shape, device="cuda", generator=gen).to(dtype)
            g = torch.randn(*shape, device="cuda", generator=gen).to(dtype)
            w = (torch.randn(7, 7, c, device="cuda", generator=gen)
                 / 7).to(dtype)
            b = torch.randn(c, device="cuda", generator=gen).to(dtype)
            got = (k_dw.depthwise_fwd(x, w, b), *k_dw.depthwise_bwd(x, g, w))
            ref = (k_dw.depthwise_fwd_ref(x, w, b),
                   *k_dw.depthwise_bwd_ref(x, g, w))
            out[f"{shape} {str(dtype)[6:]}"] = dict(zip(
                ("y", "dx", "dw", "db"), map(rel, got, ref)))
            del x, g, got, ref
            torch.cuda.empty_cache()
    return out


def device_spans(fn, names=("depthwise",)) -> dict:
    """``torch.profiler`` over one call of ``fn`` (which ends synchronised):
    the card's busy time (the union of its kernels' intervals), its span
    (the first kernel's start to the last one's end) and, for each of
    ``names``, the time of the kernels whose name holds it, in ms; under
    "kernels" {kernel name: [launches, ms, ms of the card idle just before
    its launches]} of every kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    out = dict.fromkeys(names, 0.0)
    kernels = {}
    for start, stop, name in spans:
        row = kernels.setdefault(name, [0, 0.0, 0.0])
        if end > float("-inf") and start > end:
            row[2] += (start - end) / 1e3
        if stop > end:
            busy += stop - max(start, end)
            end = stop
        for key in names:
            if key in name:
                out[key] += (stop - start) / 1e3
        row[0] += 1
        row[1] += (stop - start) / 1e3
    span = (end - spans[0][0]) / 1e3 if spans else 0.0
    return dict(out, busy=busy / 1e3, span=span, kernels=kernels)


def perceptual_ms() -> dict:
    """ms a call of the perceptual loss and its image gradient, set up as
    ``chip_smoke.py``'s perceptual phase sets up its arms (ConvNeXt-S in
    bf16 with the flagship's weights, γ drawn around 0.5, bs 64 pairs at
    image 128), under ``dw_impl`` "lax" and "pallas", quant "none":
    host-clock median of 10 synchronised calls after 2; then, as
    "perceptual <impl> busy" and "... depthwise", the medians over three
    profiled calls of the card's busy time and of the time of its kernels
    named "depthwise" (:func:`device_spans`: under "pallas" K11a and K11b)."""
    import numpy as np
    import torch

    import chip_smoke as cs

    net = cs.ConvNeXt(dtype=torch.bfloat16)
    cs.init_convnext_(net, torch.Generator().manual_seed(1))
    state = net.state_dict()
    gen = torch.Generator().manual_seed(5)
    for k in state:
        if k.endswith(".gamma"):
            state[k] = 0.5 + 0.1 * torch.randn(state[k].shape, generator=gen)
    rng = np.random.default_rng(3)
    x, y = (torch.from_numpy(rng.uniform(0, 1, (64, 128, 128, 3)).astype(
        np.float32)).cuda() for _ in range(2))
    out = {}
    for impl in ("lax", "pallas"):
        net = cs.ConvNeXt(dtype=torch.bfloat16, dw_impl=impl)
        net.load_state_dict(state)
        loss_fn = cs.PerceptualLoss(net).cuda()
        xg = x.clone().requires_grad_()

        def call():
            loss = loss_fn(xg, y)
            torch.autograd.grad(loss, xg)
            torch.cuda.synchronize()

        out[f"perceptual {impl}"] = cs.host_median_ms(call, 10)
        spans = [device_spans(call) for _ in range(3)]
        for key in ("busy", "depthwise"):
            out[f"perceptual {impl} {key}"] = sorted(
                s[key] for s in spans)[1]
        del net, loss_fn, xg
        torch.cuda.empty_cache()
    return out


def exact_attention_fwd(q, k, v, causal: bool, dropout_rate: float = 0.0,
                        seed=None, batch: int = 8):
    """The plain forward's math (``kernels/attention.py:attention_fwd_ref``)
    in float64 on the same fp32 operands: s = q·kᵀ/√d (masked), m = max s,
    p = exp(s − m), l = Σ p, o = (D∘p)·v / l, the reference the fp32 forms'
    mean limit is held against. (B, H, S, 64) → (o, m, l) in float64,
    ``batch`` batch rows at a time."""
    import torch

    from vit_tpu_torch.kernels import attention as k_attn

    outs = []
    n = q.shape[-2]
    for b0 in range(0, q.shape[0], batch):
        qb, kb, vb = (t[b0:b0 + batch].double() for t in (q, k, v))
        s = qb @ kb.transpose(-1, -2) * q.shape[-1] ** -0.5
        if causal:
            keep = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
            s = s.masked_fill(~keep, float("-inf"))
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True)
        if dropout_rate > 0.0:
            hid = (torch.arange(b0, b0 + qb.shape[0], device=q.device)[:, None]
                   * q.shape[1] + torch.arange(q.shape[1], device=q.device)
                   + seed[1].long())
            p = p * k_attn.dropout_mask(seed, hid, n, n, 0, n,
                                        dropout_rate).double()
        outs.append(((p @ vb) / l, m.squeeze(-1), l.squeeze(-1)))
        del s, p
    return tuple(torch.cat(t) for t in zip(*outs))


def two_parts(x):
    """fp32 ``x`` rounded to two bf16 parts, x0 + x1 (a 16-bit significand):
    what a split that lost its third part reads."""
    x0 = x.bfloat16().float()
    return x0 + (x - x0).bfloat16().float()


def _layer_norm(h, lns, lnb, eps):
    """u = LN(h)·ln_scale + ln_bias, two-pass statistics, in h's dtype."""
    d = h - h.mean(-1, keepdim=True)
    return d * (d * d).mean(-1, keepdim=True).add(eps).rsqrt() * lns + lnb


def exact_tail_fwd(h, x, lns, lnb, w1, b1, w2, b2, gamma, eps,
                   batch: int = 4096):
    """K3's function (``kernels/convnext_block.py:convnext_tail_fwd_ref``
    at fp32, no rounding between its steps) in float64 on the same fp32
    rows and parameters, w1 (4C, C) and w2 (C, 4C): the reference the fp32
    form's mean limit is held against. y (N, C) in float64, ``batch`` rows
    at a time."""
    import torch

    from vit_tpu_torch.ops.gelu import tanh_erf_gelu

    lns, lnb, w1, b1, w2, b2, gamma = (t.double() for t in (
        lns, lnb, w1, b1, w2, b2, gamma))
    out = []
    for r0 in range(0, h.shape[0], batch):
        u = _layer_norm(h[r0:r0 + batch].double(), lns, lnb, eps)
        a = tanh_erf_gelu(u @ w1.t() + b1)
        out.append(x[r0:r0 + batch].double() + gamma * (a @ w2.t() + b2))
    return torch.cat(out)


def two_part_tail_fwd(h, x, lns, lnb, w1, b1, w2, b2, gamma, eps):
    """The plain fp32 tail with u, a = gelu(z + b1), W1 and W2 rounded to two
    bf16 parts (:func:`two_parts`): what a split K3 that lost its third
    part reads, the control of its mean limit."""
    from vit_tpu_torch.ops.gelu import tanh_erf_gelu

    u = two_parts(_layer_norm(h, lns, lnb, eps))
    a = two_parts(tanh_erf_gelu(u @ two_parts(w1).t() + b1))
    return x + gamma * (a @ two_parts(w2).t() + b2)


def _ln_backward(h, du, lns, eps):
    """dh from du = ∂/∂u through u = LN(h)·ln_scale + ln_bias, in h's
    dtype: rstd·(dû − mean(dû) − û·mean(dû⊙û)), dû = du⊙ln_scale."""
    d = h - h.mean(-1, keepdim=True)
    rstd = (d * d).mean(-1, keepdim=True).add(eps).rsqrt()
    uhat, dhat = d * rstd, du * lns
    return rstd * (dhat - dhat.mean(-1, keepdim=True)
                   - uhat * (dhat * uhat).mean(-1, keepdim=True))


def exact_tail_bwd(h, dy, lns, lnb, w1, b1, w2, gamma, eps,
                   batch: int = 4096):
    """K4's function (``kernels/convnext_block.py:convnext_tail_bwd_ref``
    at fp32, no rounding between its steps) in float64 on the same fp32
    rows and parameters: the reference of the fp32 form's mean limit. dh
    (N, C) in float64, ``batch`` rows at a time."""
    import torch

    from vit_tpu_torch.ops.gelu import gelu_grad

    lns, lnb, w1, b1, w2, gamma = (t.double() for t in (
        lns, lnb, w1, b1, w2, gamma))
    out = []
    for r0 in range(0, h.shape[0], batch):
        hb = h[r0:r0 + batch].double()
        z = _layer_norm(hb, lns, lnb, eps) @ w1.t() + b1
        dz = (dy[r0:r0 + batch].double() * gamma) @ w2 * gelu_grad(z)
        out.append(_ln_backward(hb, dz @ w1, lns, eps))
    return torch.cat(out)


def two_part_tail_bwd(h, dy, lns, lnb, w1, b1, w2, gamma, eps):
    """The plain fp32 backward with u, do = γ⊙dy, dz, W1 and W2 rounded to
    two bf16 parts (:func:`two_parts`): what a split K4 that lost its
    third part reads, the control of its mean limit."""
    from vit_tpu_torch.ops.gelu import gelu_grad

    w1_2, w2_2 = two_parts(w1), two_parts(w2)
    z = two_parts(_layer_norm(h, lns, lnb, eps)) @ w1_2.t() + b1
    dz = two_parts((two_parts(dy * gamma) @ w2_2) * gelu_grad(z))
    return _ln_backward(h, dz @ w1_2, lns, eps)


def exact_ln_matmul_fwd(x, w, b=None, gelu: bool = False,
                        batch: int = 4096):
    """K9a's function (``kernels/ln_matmul.py:ln_matmul_fwd_ref`` at fp32,
    no rounding between its steps) in float64 on the same fp32 rows x (N,
    C), w (F, C) and b (F,) or None: the reference of the fp32 form's mean
    limit. (z, zpre) (N, F) in float64, zpre the product plus bias (z
    itself without ``gelu``), ``batch`` rows at a time."""
    import torch

    from vit_tpu_torch.ops.gelu import tanh_erf_gelu

    wd = w.double()
    zs, zpres = [], []
    for r0 in range(0, x.shape[0], batch):
        xb = x[r0:r0 + batch].double()
        d = xb - xb.mean(-1, keepdim=True)
        acc = (d * (d * d).mean(-1, keepdim=True).add(1e-5).rsqrt()) @ wd.t()
        if b is not None:
            acc = acc + b.double()
        zpres.append(acc)
        zs.append(tanh_erf_gelu(acc) if gelu else acc)
    return torch.cat(zs), torch.cat(zpres)


def two_part_ln_matmul_fwd(x, w, b=None, gelu: bool = False):
    """The plain fp32 K9a with x̂ and W rounded to two bf16 parts
    (:func:`two_parts`): what a split K9a fp32 that lost its third part
    reads, the control of its mean limit. (z, zpre) in fp32."""
    from vit_tpu_torch.kernels.ln_matmul import _stats
    from vit_tpu_torch.ops.gelu import tanh_erf_gelu

    acc = two_parts(_stats(x)[0]) @ two_parts(w).t()
    if b is not None:
        acc = acc + b
    return (tanh_erf_gelu(acc) if gelu else acc), acc


def exact_fc_grad(g, x):
    """K10's function (``kernels/fc_grad.py:matmul_dw_db_ref``) in float64
    on the same fp32 g (N, F_out) and x (N, F_in): (dW, db), the reference
    of the fp32 form's mean limit."""
    gd = g.double()
    return gd.t() @ x.double(), gd.sum(0)


def two_part_fc_grad(g, x):
    """The plain fp32 K10 with g and x rounded to two bf16 parts
    (:func:`two_parts`): what a split K10 fp32 that lost its third part
    reads, the control of its mean limit. (dW, db) in fp32; db from g
    itself, as the kernel sums it."""
    return two_parts(g).t() @ two_parts(x), g.sum(0)


def mean_rel(out, ref) -> float:
    """mean |out − ref| / mean |ref|, in float64."""
    return ((out.double() - ref.double()).abs().mean()
            / ref.double().abs().mean()).item()


def time_fp32_kernels() -> "tuple[dict, dict]":
    """{kernel: ms} of the attention kernels on fp32 operands (K1, K2, K6,
    K7/K8's fp32 forms) at ``chip_smoke.py``'s fp32 shapes, as single calls
    and as 20 back-to-back calls ("x20"); and {forward row: mean distances}
    of the forwards' o, m and l from the plain version ("plain") and from
    :func:`exact_attention_fwd` ("exact"), the two-part control's from the
    latter ("two_parts_exact")."""
    import torch

    from vit_tpu_torch.kernels import attention as k_attn

    gen = torch.Generator(device="cuda").manual_seed(7)

    def r(*shape, scale=1.0):
        return scale * torch.randn(*shape, device="cuda", generator=gen)

    def seed():
        return k_attn.seed_vec(torch.randint(
            0, 2 ** 31 - 1, (1,), device="cuda", generator=gen,
            dtype=torch.int32))

    def accuracy(q, k, v, causal, got, drop):
        plain = k_attn.attention_fwd_ref(q, k, v, causal, True, **drop)
        exact = exact_attention_fwd(q, k, v, causal, **drop)
        two = k_attn.attention_fwd_ref(*(two_parts(t) for t in (q, k, v)),
                                       causal, True, **drop)
        names = ("o", "m", "l")
        return {"plain": dict(zip(names, map(mean_rel, got, plain))),
                "exact": dict(zip(names, map(mean_rel, got, exact))),
                "plain_exact": dict(zip(names, map(mean_rel, plain, exact))),
                "two_parts_exact": dict(zip(names, map(mean_rel, two,
                                                       exact)))}

    ms, rel = {}, {}
    ms.update(time_ln_bwd(2 * r(N_ROWS, 768) + 0.5, r(N_ROWS, 768),
                          "K9c fp32"))
    ms.update(time_tail_f32(r))
    torch.cuda.empty_cache()
    for name, (b, s, h, rate) in {"K2 fp32": (64, 320, 12, 0.0),
                                  "K2 fp32 dropout": (64, 257, 16,
                                                      0.15)}.items():
        qkv, bias, dout = r(b, s, 3 * h * 64), r(3 * h * 64, scale=0.3), \
            r(b, s, h * 64)
        drop = dict(dropout_rate=rate, seed=seed() if rate else None)
        out, m, l = k_attn.attention_packed_fwd(qkv, bias, h, False, True,
                                                **drop)
        fwd = name.replace("K2", "K1")
        rel[fwd] = accuracy(*k_attn.split_heads(qkv, h, bias), False,
                            (out.reshape(b, s, h, 64).transpose(1, 2), m, l),
                            drop)
        def fwd_call():
            k_attn.attention_packed_fwd(qkv, bias, h, False, True, **drop)
        def call():
            k_attn.attention_packed_bwd(qkv, bias, dout, m, l, h, False,
                                        **drop)
        ms[fwd] = median_ms(fwd_call)
        ms[fwd + " x20"] = batched_ms(fwd_call)
        ms[name] = median_ms(call)
        ms[name + " x20"] = batched_ms(call)
        del qkv, bias, dout, out, m, l
        torch.cuda.empty_cache()
    for name, (b, s, rate) in {"K8 fp32": (32, 1024, 0.0),
                               "K8 fp32 dropout": (32, 1024, 0.1),
                               "K7 fp32": (2, 513, 0.0)}.items():
        q, k, v = r(b, s, 3, 12, 64).permute(2, 0, 3, 1, 4)
        do = r(b, s, 12, 64).transpose(1, 2)
        drop = dict(dropout_rate=rate, seed=seed() if rate else None)
        out, m, l = k_attn.attention_fwd(q, k, v, True, True, **drop)
        fwd = name.replace("K8", "K6").replace("K7", "K6 at K7's shape,")
        rel[fwd] = accuracy(q, k, v, True, (out, m, l), drop)
        def fwd_call():
            k_attn.attention_fwd(q, k, v, True, True, **drop)
        def call():
            k_attn.attention_bwd(q, k, v, do, m, l, True, **drop)
        if b > 2:
            ms[fwd] = median_ms(fwd_call)
            ms[fwd + " x20"] = batched_ms(fwd_call)
        ms[name] = median_ms(call)
        ms[name + " x20"] = batched_ms(call)
        del q, k, v, do, out, m, l
        torch.cuda.empty_cache()
    return ms, rel


def videogpt_step_ms(dtype: str = "bfloat16") -> float:
    """The VideoGPT-B bs-32 train step (tokenizer and AR step), set up as
    ``chip_smoke.py``'s videogpt phase sets up the steps it times: its
    model, tokenizer, first synthetic batch and the optimizer of its timed
    steps (``make_optimizer(1e-4, 2, 500000, 1e-5, 1e-4)``, no clip). The
    phase times after 21 earlier steps (its launch count, the plain
    comparison and 20 learning steps); this times after two warm-up steps.
    Both take the host-clock median of 6 synchronised steps. ``dtype``
    "float32" builds both models at float32 (``--mixed false``)."""
    import torch

    import chip_smoke as cs

    dt = getattr(torch, dtype)
    tok = cs.TiTok(cs.TiTokConfig(**cs.VIDEO_TOKENIZER, dtype=dt))
    cs.init_params_(tok, torch.Generator().manual_seed(123))
    tokenizer = cs.FrozenTokenizer(tok.cuda())
    model = cs.VideoGPT(cs.VideoGPTConfig(**cs.VIDEOGPT, dtype=dt))
    cs.init_params_(model, torch.Generator().manual_seed(0))
    model = model.cuda().train()
    videos = cs.video_batch(cs.VIDEO_TOKENIZER["image_size"])
    step = cs.make_videogpt_train_step(model)
    state = cs.TrainState.create(model, cs.make_optimizer(
        1e-4, 2, 500000, 1e-5, 1e-4, clip_norm=None))
    for _ in range(2):
        step(state, tokenizer, videos)
    torch.cuda.synchronize()
    return cs.host_median_ms(lambda: (step(state, tokenizer, videos),
                                      torch.cuda.synchronize()), 6)


def titok_step(dtype: str = "bfloat16", quant: str = "none"):
    """The flagship TiTok-B unfused bs-64 train step, set up as
    ``chip_smoke.py``'s train phase sets up the steps it times, as a call
    that ends synchronised, after two warm-up steps: its model
    (``FLAGSHIP``, weights from seed 0), ``train_inputs``' perceptual loss
    and batch, and the optimizer of its timed steps (``make_optimizer(1e-4,
    2, 1_000_000, 1e-5, 1e-4, clip_norm=1.0)``). The phase times after 21
    earlier steps and a plain-version step, and its model has served the
    slice and timing phases first; this is a fresh model. ``dtype``
    "float32" builds the model and ConvNeXt-S at float32 (``--mixed
    false``), as the fp32 phase's unfused step; ``quant`` "int8" gives bf16
    ConvNeXt-S the int8 tail (``--perceptual_quant int8``, K12a and K12b),
    as the train_int8 phase builds it from the same weights."""
    import numpy as np
    import torch

    import chip_smoke as cs

    dt = getattr(torch, dtype)
    model = cs.TiTok(cs.TiTokConfig(**cs.FLAGSHIP, dtype=dt))
    cs.init_params_(model, torch.Generator().manual_seed(0))
    model = model.cuda().train()
    if dtype == "bfloat16":
        perceptual, images = cs.train_inputs(model)
        if quant != "none":
            net = cs.ConvNeXt(dtype=dt, quant=quant)
            net.load_state_dict(perceptual.net.state_dict())
            perceptual = cs.PerceptualLoss(net).cuda()
    else:
        net = cs.ConvNeXt(dtype=dt)
        cs.init_convnext_(net, torch.Generator().manual_seed(1))
        perceptual = cs.PerceptualLoss(net).cuda()
        size = model.config.image_size
        images = torch.from_numpy(np.random.default_rng(2).uniform(
            0, 1, (cs.TRAIN_BS, size, size, 3)).astype(np.float32)).cuda()
    usage = torch.zeros(model.config.codebook_size, device="cuda")
    step = cs.make_tokenizer_train_step(model, perceptual_loss_fn=perceptual)
    state = cs.TrainState.create(model, cs.make_optimizer(
        1e-4, 2, 1_000_000, 1e-5, 1e-4, clip_norm=1.0))
    for _ in range(2):
        step(state, images, usage)
    torch.cuda.synchronize()
    return lambda: (step(state, images, usage), torch.cuda.synchronize())


def titok_step_ms(dtype: str = "bfloat16", quant: str = "none") -> float:
    """:func:`titok_step`'s host-clock median of 10 synchronised steps
    (``chip_smoke.host_median_ms``)."""
    import chip_smoke as cs

    return cs.host_median_ms(titok_step(dtype, quant), 10)


# The ConvNeXt tails' kernels by the names the profiler gives them: K3 and
# K4 (bf16 and fp32, and K4 fp32's pre-pass and the weights' pre-split),
# K12a and K12b
TAIL_SPANS = {"K3": "convnext_tail_fwd_kernel", "K4": "convnext_tail_bwd_kernel",
              "K12a": "convnext_tail_fwd_q8", "K12b": "convnext_tail_bwd_q8"}


# K9a's kernels by the names the profiler gives them: the product and, in
# a tree that has them, its row pre-pass and fp32 W split (csrc/ln_matmul.cu)
K9A_SPANS = ("ln_matmul_fwd", "ln_rows_kernel", "(anonymous namespace)::split_kernel")


def titok_step_spans(name: str, quant: str,
                     dtype: str = "bfloat16") -> "tuple[dict, dict]":
    """:func:`titok_step` with ``quant`` at ``dtype``: its host-clock median
    of 10 steps under ``name``, then, over three profiled steps
    (:func:`device_spans`), the medians of the card's busy time ("<name>
    busy"), of its span ("<name> span"), of the ConvNeXt tails' kernel
    time ("<name> K12a", ...: ``TAIL_SPANS``) and of K9a's kernels
    together ("<name> K9a": ``K9A_SPANS``, where the step launches them);
    and the middle profiled step's {kernel: [launches, ms, idle ms before
    them]}."""
    import torch

    import chip_smoke as cs

    call = titok_step(dtype, quant)
    ms = {name: cs.host_median_ms(call, 10)}
    spans = [device_spans(call, tuple(TAIL_SPANS.values()) + K9A_SPANS)
             for _ in range(3)]
    order = sorted(range(3), key=lambda i: spans[i]["busy"])
    ms[name + " busy"] = spans[order[1]]["busy"]
    ms[name + " span"] = sorted(s["span"] for s in spans)[1]
    for kernel, key in TAIL_SPANS.items():
        if any(s[key] for s in spans):
            ms[f"{name} {kernel}"] = sorted(s[key] for s in spans)[1]
    k9a = sorted(sum(s[key] for key in K9A_SPANS) for s in spans)
    if k9a[1]:
        ms[f"{name} K9a"] = k9a[1]
    del call
    torch.cuda.empty_cache()
    return ms, spans[order[1]]["kernels"]


def fused_titok_step_spans(name: str, dtype: str,
                           fused_ln: str = "1") -> "tuple[dict, dict]":
    """:func:`titok_step_spans` of the flagship step under
    ``VIT_TPU_FUSED_LN=1 VIT_TPU_FUSED_FC=1`` (K9a, K9b, K9c and K10 on
    the MLP and qkv sites, as ``chip_smoke.py``'s train_fused phase runs
    it), or with ``fused_ln`` "0" under ``VIT_TPU_FUSED_LN=0
    VIT_TPU_FUSED_FC=1`` (K10 alone, at fc1 and fc2: 48 launches), set for
    this step only."""
    saved = {k: os.environ.get(k) for k in ("VIT_TPU_FUSED_LN",
                                            "VIT_TPU_FUSED_FC")}
    os.environ.update(VIT_TPU_FUSED_LN=fused_ln, VIT_TPU_FUSED_FC="1")
    try:
        return titok_step_spans(name, "none", dtype)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def vit_step_ms(dtype: str = "bfloat16") -> float:
    """The ViT-L/16 @256 bs-64 train step at dropout 0.15, set up as
    ``chip_smoke.py``'s vit phase sets up that cell's timed steps: its
    ``VIT_CELLS`` entry, weights from seed 0, ``vit_batch``, the optimizer
    of its timed steps (``make_optimizer(1e-5, 2, 500000, 1e-6, 1e-2,
    clip_norm=None)``) and a dropout generator from seed 1. The phase times
    after 11 earlier steps and two plain-version passes; this after two
    warm-up steps. Both take the host-clock median of 6 synchronised
    steps. ``dtype`` "float32" is ``train_vit.py --mixed false``'s step."""
    import torch

    import chip_smoke as cs

    size, patch, preset, rate = cs.VIT_CELLS["vit_l16_256_drop0.15"]
    model = cs.ViTClassifier(cs.ViTConfig(size, 3, patch, preset, 1, rate,
                                          dtype=getattr(torch, dtype)),
                             cs.VIT_CLASSES, device="cuda")
    cs.init_params_(model, torch.Generator(device="cuda").manual_seed(0))
    images, labels = cs.vit_batch(size)
    step = cs.make_classifier_train_step(model)
    state = cs.TrainState.create(model, cs.make_optimizer(
        1e-5, 2, 500000, 1e-6, 1e-2, clip_norm=None))
    gen = torch.Generator(device="cuda").manual_seed(1)
    for _ in range(2):
        step(state, images, labels, gen)
    torch.cuda.synchronize()
    return cs.host_median_ms(lambda: (step(state, images, labels, gen),
                                      torch.cuda.synchronize()), 6)


# The train steps a turn times, by name; the bf16 TiTok-B steps also
# profiled (:func:`titok_step_spans`)
STEPS = {"VideoGPT-B step": videogpt_step_ms,
         "TiTok-B step": lambda: titok_step_spans("TiTok-B step", "none"),
         "TiTok-B int8 step": lambda: titok_step_spans("TiTok-B int8 step",
                                                       "int8"),
         "ViT-L step": vit_step_ms,
         "VideoGPT-B fp32 step": lambda: videogpt_step_ms("float32"),
         "ViT-L fp32 step": lambda: vit_step_ms("float32"),
         "TiTok-B fp32 step": lambda: titok_step_ms("float32"),
         "TiTok-B fused step": lambda: fused_titok_step_spans(
             "TiTok-B fused step", "bfloat16"),
         "TiTok-B fused fp32 step": lambda: fused_titok_step_spans(
             "TiTok-B fused fp32 step", "float32"),
         "TiTok-B fused-FC step": lambda: fused_titok_step_spans(
             "TiTok-B fused-FC step", "bfloat16", fused_ln="0")}
GROUPS = ("kernels", "q8", "queue", "k10", "perceptual", "fp32", "steps")


def worker(root: str, groups=("kernels", "perceptual", "fp32", "steps"),
           steps=tuple(STEPS)) -> None:
    """One turn: import the checkout at ``root`` and print its times, of
    the ``groups`` in order (``GROUPS``: :func:`time_kernels`,
    :func:`time_q8_stages`, :func:`time_queue`, :func:`time_k10_splits`,
    :func:`perceptual_ms`,
    :func:`time_fp32_kernels` with :func:`depthwise_mean_rel`, the
    ``steps`` of ``STEPS``)."""
    sys.path.insert(0, root)
    import torch

    import vit_tpu_torch

    where = str(Path(vit_tpu_torch.__file__).resolve().parent.parent)
    if where != str(Path(root).resolve()):
        raise SystemExit(f"imported vit_tpu_torch from {where}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ms, fwd_rel, k11_rel, step_kernels = {}, {}, {}, {}
    for group in groups:
        if group == "kernels":
            ms.update(time_kernels())
        elif group == "q8":
            ms.update(time_q8_stages())
        elif group == "queue":
            ms.update(time_queue())
        elif group == "k10":
            ms.update(time_k10_splits())
        elif group == "perceptual":
            ms.update(perceptual_ms())
        elif group == "fp32":
            k11_rel = depthwise_mean_rel()
            fp32_ms, fwd_rel = time_fp32_kernels()
            ms.update(fp32_ms)
        elif group == "steps":
            for name in steps:
                got = STEPS[name]()
                if isinstance(got, tuple):
                    got, step_kernels[name] = got
                    ms.update(got)
                else:
                    ms[name] = got
                torch.cuda.empty_cache()
        torch.cuda.empty_cache()
    print(json.dumps({"tree": root, "ms": ms, "fwd_mean_rel": fwd_rel,
                      "k11_mean_rel": k11_rel,
                      "step_kernels": step_kernels}), flush=True)


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", required=True,
                    help="checkout roots, in the order of the turns")
    ap.add_argument("--out", default=None, help="also write the turns here")
    ap.add_argument("--groups", nargs="+", choices=GROUPS,
                    default=["kernels", "perceptual", "fp32", "steps"],
                    help="what a turn times, in order (q8: K12a and K12b "
                         "alone at every fused width, bf16 and fp32 rows; "
                         "queue: K9a, K9b, K10 and K5 on the card alone; "
                         "k10: the bf16 K10 at each split count)")
    ap.add_argument("--steps", nargs="+", choices=list(STEPS),
                    default=list(STEPS), help="the steps of the steps group")
    args = ap.parse_args(argv)
    turns = []
    for i, tree in enumerate(args.trees):
        root = str(Path(tree).resolve())
        script = str(Path(__file__).resolve())
        code = (f"import runpy; runpy.run_path({script!r})['worker']("
                f"{root!r}, {tuple(args.groups)!r}, {tuple(args.steps)!r})")
        proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                              capture_output=True, text=True, timeout=900,
                              env={**os.environ, "PYTHONPATH": ""})
        if proc.returncode:
            raise SystemExit(f"turn {i} ({tree}) exited {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}{proc.stderr[-3000:]}")
        turn = json.loads(proc.stdout.strip().splitlines()[-1])
        turn.update(turn=i, arg=tree)
        turns.append(turn)
        print(json.dumps({k: v for k, v in turn.items()
                          if k != "step_kernels"}), flush=True)
    name = card()
    print(f"card: {name}")
    kernels = list(dict.fromkeys(k for t in turns for k in t["ms"]))
    print("kernel                  " + "  ".join(
        f"{t['arg']}#{t['turn']}" for t in turns))
    for k in kernels:
        print(f"{k:22s}  " + "  ".join(
            f"{t['ms'][k]:.3f}" if k in t["ms"] else "-" for t in turns))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": name, "turns": turns},
                                             indent=1))
    return turns


if __name__ == "__main__":
    main()
