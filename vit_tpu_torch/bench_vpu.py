"""Measure the card's FMA rate on the CUDA cores, fp32 and bf16, to bound
the work the tensor cores cannot take: the port's fp32 kernel forms and the
7×7 depthwise convolutions (49 multiply-adds per element, no channel
mixing). The counterpart of ``scripts/bench_vpu.py``, through the probe P
(``kernels/fma_probe.py``, ``csrc/fma_probe.cu``).

    python -m vit_tpu_torch.bench_vpu [--iters 4096] [--steps 20]
        [--device cuda]

Sweeps fp32 and bf16 × 1-6 independent chains per element over the
card-filling default shape, prints
one line per setting, then the depthwise floor at the best fp32 rate: the
flagship step's ≈ 22 GMAC of depthwise work (BENCHMARKS.md, round 3) over
that rate. On ``--device cpu`` the plain version runs and the rates are the
CPU's, labelled so.
"""

from __future__ import annotations

import argparse

import torch

from vit_tpu_torch.kernels.fma_probe import MAX_CHAINS, default_shape, fma_rate

DWCONV_GMAC = 22.0   # the flagship step's depthwise work (BENCHMARKS.md)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", type=str, default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the sweep; returns {(dtype name, chains): (MAC/s, s per call)}
    and the floor under the key "dwconv_floor_ms"."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_vpu: no CUDA device (pass --device cpu for "
                         "the plain version)")
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu, plain version")
    results, best32 = {}, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        shape = default_shape(dtype)
        for chains in range(1, MAX_CHAINS + 1):
            rate, dt = fma_rate(shape, args.iters, args.steps, dtype, chains,
                                device)
            name = str(dtype).removeprefix("torch.")
            results[(name, chains)] = (rate, dt)
            if dtype == torch.float32:
                best32 = max(best32, rate)
            print(f"{name:9s} chains={chains}  FMA rate ({where}): "
                  f"{rate / 1e12:6.2f} T MAC/s  ({dt * 1e3:.3f} ms/call, "
                  f"shape {shape})", flush=True)
    floor_ms = DWCONV_GMAC * 1e9 / best32 * 1e3
    results["dwconv_floor_ms"] = floor_ms
    print(f"→ dwconv floor at best fp32 rate ({where}): {floor_ms:.3f} ms "
          f"for {DWCONV_GMAC:g} GMAC", flush=True)
    return results


if __name__ == "__main__":
    main()
