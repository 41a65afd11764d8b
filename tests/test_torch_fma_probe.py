"""Port parity for P, the FMA-rate probe: the plain version bit for bit
against the Pallas kernel ``scripts/bench_vpu.py:_fma_kernel`` in interpret
mode (the script loaded by path, unchanged), the wrapper's refusals, the
card-filling default shape, and ``python -m vit_tpu_torch.bench_vpu`` on the
CPU."""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from vit_tpu_torch.kernels import fma_probe

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "bench_vpu.py"
SHAPE, ITERS = (8, 128), 64


@pytest.fixture(scope="module")
def bench_vpu():
    spec = importlib.util.spec_from_file_location("bench_vpu_jax", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("chains", range(1, 7))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_is_bit_identical_to_jax(bench_vpu, dtype, chains):
    """``fma_chains_ref`` equals ``_fma_kernel`` under ``pl.pallas_call(...,
    interpret=True)`` to the bit, on the script's ones and on x in [1, 2)."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.default_rng(chains)
    for x in (np.ones(SHAPE, np.float32),
              1.0 + rng.random(SHAPE).astype(np.float32)):
        ref = pl.pallas_call(
            functools.partial(bench_vpu._fma_kernel, iters=ITERS,
                              chains=chains),
            out_shape=jax.ShapeDtypeStruct(SHAPE, jdt),
            interpret=True)(jnp.asarray(x, jdt))
        out = fma_probe.fma_chains_ref(torch.from_numpy(x).to(tdt), ITERS,
                                       chains)
        assert out.dtype == tdt and out.shape == SHAPE
        np.testing.assert_array_equal(out.float().numpy(),
                                      np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("chains", range(1, 7))
def test_bf16_steps_change_the_value_at_other_constants(chains):
    """At the script's constants every bf16 step returns a, so the output
    is Σᵢ (x + i) whether the steps run or not. At c = 1 + 2⁻⁷, d = 2⁻¹⁰
    each step changes a: the plain version (and the wrapper on the CPU)
    equals a float64 loop rounded to bf16 once a step by ``ml_dtypes``, and
    differs from Σᵢ (x + i)."""
    c, d, iters = 1 + 2.0 ** -7, 2.0 ** -10, 256
    rng = np.random.default_rng(chains)
    x = torch.from_numpy(1 + rng.random(SHAPE).astype(np.float32)).bfloat16()
    out = fma_probe.fma_chains_ref(x, iters, chains, c, d)
    assert torch.equal(fma_probe.fma_chains(x, iters, chains, c, d), out)
    bf16 = jnp.bfloat16
    x64 = x.float().numpy().astype(np.float64)
    accs = [np.asarray(x64 + i, bf16) for i in range(chains)]
    for _ in range(iters):
        accs = [np.asarray(a.astype(np.float64) * c + d, bf16) for a in accs]
    want = accs[0]
    for a in accs[1:]:
        want = np.asarray(want.astype(np.float64) + a.astype(np.float64),
                          bf16)
    np.testing.assert_array_equal(out.float().numpy(),
                                  want.astype(np.float32))
    idle = fma_probe.fma_chains_ref(x, 0, chains)
    assert not torch.equal(out, idle)


def test_wrapper_runs_the_plain_version_only_on_the_cpu():
    """A CPU tensor takes the plain version (no launch); a device tensor
    launches or raises (a meta tensor stands in for one); other dtypes and
    chain counts are refused."""
    x = torch.ones(4, 128)
    assert torch.equal(fma_probe.fma_chains(x, 3, 2),
                       fma_probe.fma_chains_ref(x, 3, 2))
    assert fma_probe.launches == 0
    with pytest.raises(ValueError, match="unsupported device"):
        fma_probe.fma_chains(torch.ones(4, 128, device="meta"), 3, 2)
    with pytest.raises(TypeError):
        fma_probe.fma_chains(torch.ones(4, 128, dtype=torch.float16), 3, 2)
    for chains in (0, 7):
        with pytest.raises(ValueError, match="chains"):
            fma_probe.fma_chains(x, 3, chains)


def test_default_shape_fills_the_card():
    """One fp32 element or one bf16 pair for each of 132 × 2,048 threads."""
    rows, lanes = fma_probe.default_shape(torch.float32)
    assert rows * lanes == 132 * 2048 and lanes == 128
    rows16, _ = fma_probe.default_shape(torch.bfloat16)
    assert rows16 == 2 * rows
    assert fma_probe.macs((rows, lanes), 4096, 6) == 132 * 2048 * 4096 * 6


def test_bench_vpu_entry_runs_on_the_cpu(capsys):
    """``--iters``, ``--steps`` and ``--device cpu``: the dtype × chains 1-6
    sweep over the card-filling default shape through the plain version,
    then the depthwise floor at the best fp32 rate, every line labelled as
    the CPU's."""
    from vit_tpu_torch.bench_vpu import DWCONV_GMAC, main

    res = main(["--iters", "3", "--steps", "1", "--device", "cpu"])
    sweep = {k: v for k, v in res.items() if k != "dwconv_floor_ms"}
    assert set(sweep) == {(d, c) for d in ("float32", "bfloat16")
                          for c in range(1, 7)}
    assert all(rate > 0 and dt > 0 for rate, dt in sweep.values())
    best = max(rate for (d, _), (rate, _) in sweep.items() if d == "float32")
    assert res["dwconv_floor_ms"] == pytest.approx(DWCONV_GMAC * 1e12 / best)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 13 and all("cpu, plain version" in s for s in lines)
    assert lines[-1].startswith("→ dwconv floor")
