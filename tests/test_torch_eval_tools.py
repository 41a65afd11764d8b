"""The evaluation tools against the JAX package's, on the CPU:

  - ``vit_tpu_torch.losses.lpips`` against ``vit_tpu/losses/lpips.py`` at
    JAX's init carried over by the bridge, fp32 NHWC pairs at 64 × 64 from a
    numpy seed (within 1e-5 relative), its taps' shapes, ``load_params`` on a
    JAX-format ``.npz``, the bridge both ways and ``init_params``' tree;
  - ``python -m vit_tpu_torch.eval_recon``'s ``main`` against
    ``eval_recon.py``'s for a tiny fp32 TiTok, ViT-VQGAN and TATiTok: the
    same argv and synthetic batches, the JAX ``load_model`` patched to
    return the JAX init, the port reading a ``Checkpointer`` checkpoint of
    the bridged tree, and LPIPS and perceptual weights (a tiny ConvNeXt in
    both packages, γ around 0.5) from ``.npz`` files in the JAX layout.
    psnr within 1e-3 dB, ssim within 1e-4, perceptual and lpips within 1e-4
    relative, ``codebook_usage`` and ``n`` equal;
  - ``python -m vit_tpu_torch.tokenize_images``' ``main`` against
    ``tokenize_images.py``'s: encode of the same PNGs (codes and paths
    equal), then decode of the JAX codes (PNGs equal, where a pixel's fp32
    value does not lie within 1e-5 of a truncation step)."""

import contextlib
import functools
import io
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_tpu.core.config as jax_config
import vit_tpu_torch.core.config as torch_config
from torch_port_helpers import (CONVNEXT, TITOK, convnext_params, tiny_preset,
                                with_gamma)
from vit_tpu_torch import bridge
from vit_tpu_torch.losses import lpips as port_lpips
from vit_tpu_torch.serve.export import FAMILIES
from vit_tpu_torch.train.checkpoint import Checkpointer
from vit_tpu_torch.train.optim import make_optimizer
from vit_tpu_torch.train.state import TrainState

ROOT = Path(__file__).resolve().parents[1]
LPIPS_REL = 1e-5
PSNR_ABS, SSIM_ABS, METRIC_REL = 1e-3, 1e-4, 1e-4
PNG_STEP_TOL = 1e-5
FIELDS = {"titok": TITOK,
          "vit_vqgan": dict(image_size=32, patch_size=8, codebook_size=64,
                            latent_dim=12, transformer="tiny"),
          "tatitok": dict(image_size=32, patch_size=8, latent_tokens=8,
                          codebook_size=64, latent_dim=12,
                          transformer="small")}
ARGV = ["--dataset", "synthetic", "--bs", "2", "--batches", "2"]


@pytest.fixture(scope="module", autouse=True)
def setting():
    """The "tiny" preset and the Bytedance "small" cut to 2 layers × 2
    heads × 128 in both packages; one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with tiny_preset(), pytest.MonkeyPatch.context() as mp:
        for mod in (jax_config, torch_config):
            mp.setitem(mod.BYTEDANCE_WIDTH, "small", 128)
            mp.setitem(mod.BYTEDANCE_LAYERS, "small", 2)
            mp.setitem(mod.BYTEDANCE_HEADS, "small", 2)
        mp.syspath_prepend(str(ROOT))
        yield
    torch.set_num_threads(n)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def write_npz(path: Path, tree: dict) -> str:
    np.savez(path, **bridge.flatten(tree))
    return str(path)


@functools.lru_cache(maxsize=None)
def jax_lpips_params() -> dict:
    from vit_tpu.losses import lpips as jax_lpips

    params = np_tree(jax_lpips.init_params())
    # heads drawn away from the init's ones, so each tap's weight matters
    rng = np.random.default_rng(7)
    for i in range(5):
        params[f"lin{i}"] = rng.uniform(0.1, 1.0, params[f"lin{i}"].shape
                                        ).astype(np.float32)
    return params


def pairs(seed: int, size: int = 64):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (2, size, size, 3)).astype(np.float32)
            for _ in range(2)]


def test_lpips_matches_jax():
    from vit_tpu.losses import lpips as jax_lpips

    params = jax_lpips_params()
    x, y = pairs(0)
    ref = np.asarray(jax.jit(jax_lpips.lpips_fn(params))(x, y))
    got = port_lpips.lpips_fn(params, device="cpu")(torch.from_numpy(x),
                                                     torch.from_numpy(y))
    assert got.shape == (2,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=LPIPS_REL)
    assert float(port_lpips.lpips_fn(params, device="cpu")(
        torch.from_numpy(x), torch.from_numpy(x)).abs().max()) == 0.0


def test_lpips_taps_and_constants_match_jax():
    from vit_tpu.losses import lpips as jax_lpips

    params = jax_lpips_params()
    x = pairs(1)[0]
    taps_j = jax.jit(lambda p, x: jax_lpips.AlexNetFeatures().apply(
        {"params": p}, x))(params["alex"], x)
    net = port_lpips.build(params, device="cpu")
    taps = net.alex(torch.from_numpy(x))
    assert [tuple(t.shape) for t in taps] == [t.shape for t in taps_j] == [
        (2, 15, 15, 64), (2, 7, 7, 192), (2, 3, 3, 384), (2, 3, 3, 256),
        (2, 3, 3, 256)]
    for t, tj in zip(taps, taps_j):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(tj),
                                   rtol=1e-5, atol=1e-5 * float(
                                       np.abs(tj).max()))
    assert port_lpips.LPIPS_SHIFT == jax_lpips.LPIPS_SHIFT
    assert port_lpips.LPIPS_SCALE == jax_lpips.LPIPS_SCALE
    assert port_lpips.LPIPS_NORM_EPS == jax_lpips.LPIPS_NORM_EPS
    assert port_lpips.ALEXNET_CONVS == jax_lpips.ALEXNET_CONVS
    assert port_lpips._POOL_AFTER == jax_lpips._POOL_AFTER
    f = np.random.default_rng(2).normal(size=(3, 5, 7)).astype(np.float32)
    f[0] *= 1e-9   # a small-norm row, where eps's placement shows
    np.testing.assert_allclose(
        port_lpips.unit_normalize(torch.from_numpy(f)).numpy(),
        np.asarray(jax_lpips.unit_normalize(jnp.asarray(f))), rtol=1e-6)


def test_lpips_load_params_and_bridge(tmp_path):
    from vit_tpu.losses import lpips as jax_lpips

    params = jax_lpips_params()
    path = write_npz(tmp_path / "lpips.npz", params)
    loaded = port_lpips.load_params(path)
    ref = np_tree(jax_lpips.load_params(path))
    flat, flat_ref = bridge._flat(loaded), bridge._flat(ref)
    assert flat.keys() == flat_ref.keys()
    assert all(np.array_equal(flat[k], flat_ref[k]) for k in flat)
    state = bridge.lpips_state_dict_from_flax(loaded)
    assert state["alex.conv0.weight"].shape == (64, 3, 11, 11)
    assert state["lin4"].shape == (256,)
    back = bridge.flax_from_state_dict(state)
    assert all(np.array_equal(bridge._flat(back)[k], flat[k]) for k in flat)
    with pytest.raises(KeyError):
        bridge.lpips_state_dict_from_flax({k: v for k, v in loaded.items()
                                           if k != "lin2"})


def test_lpips_init_params_has_the_jax_tree():
    from vit_tpu.losses import lpips as jax_lpips

    mine = bridge._flat(port_lpips.init_params(3))
    ref = bridge._flat(np_tree(jax_lpips.init_params()))
    assert {k: tuple(v.shape) for k, v in mine.items()} == {
        k: tuple(v.shape) for k, v in ref.items()}
    for i, (_, k, _, _) in enumerate(port_lpips.ALEXNET_CONVS):
        w = mine[f"alex/conv{i}/kernel"]
        fan_in = w.shape[0] * w.shape[1] * w.shape[2]
        assert float(w.abs().max()) <= 2 * (1 / fan_in) ** 0.5 / 0.8796 + 1e-6
        assert abs(float(w.std()) * fan_in ** 0.5 - 1.0) < 0.1
        assert float(mine[f"alex/conv{i}/bias"].abs().max()) == 0.0
        assert bool((mine[f"lin{i}"] == 1).all())
    assert bridge._flat(port_lpips.init_params(3))[
        "alex/conv0/kernel"].equal(mine["alex/conv0/kernel"])


# -- eval_recon and tokenize_images against the JAX tools -------------------

def jax_net(name: str):
    import vit_tpu.models.tatitok as jt
    import vit_tpu.models.titok as jtt
    import vit_tpu.models.vit_vqgan as jq

    cls, net = {"titok": (jtt.TiTokConfig, jtt.TiTok),
                "vit_vqgan": (jq.ViTVQGANConfig, jq.ViTVQGAN),
                "tatitok": (jt.TATiTokConfig, jt.TATiTok)}[name]
    cfg = cls(**FIELDS[name], dtype=jnp.float32,
              **({"attn_impl": "xla"} if name == "tatitok" else {}))
    return net(cfg), cfg


@functools.lru_cache(maxsize=None)
def tokenizer(name: str, root: str) -> dict:
    """The JAX init of ``name``, and a port "best" checkpoint of it."""
    net, cfg_j = jax_net(name)
    args = (jnp.zeros((1, 32, 32, 3)),) + ((None,) if name == "tatitok"
                                           else ())
    params = np_tree(jax.jit(net.init)(jax.random.PRNGKey(0), *args)
                     ["params"])
    cfg_t = FAMILIES[name][0](**FIELDS[name], dtype=torch.float32)
    model = FAMILIES[name][1](cfg_t)
    model.load_state_dict(bridge.module_state_dict_from_flax(params, model))
    ckpt = Path(root) / name
    Checkpointer(str(ckpt)).save(
        TrainState.create(model, make_optimizer(1e-4, 1, 10, 1e-5, 0.0)),
        config=cfg_t, tag="best")
    return dict(net=net, cfg=cfg_j, params=params, ckpt=str(ckpt),
                model=model.eval())


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("eval_tools")


@pytest.fixture(scope="module")
def weights(root):
    """LPIPS and tiny-ConvNeXt perceptual weights as JAX-layout .npz."""
    return dict(lpips=write_npz(root / "lpips.npz", jax_lpips_params()),
                perceptual=write_npz(root / "convnext.npz",
                                     with_gamma(convnext_params())))


@contextlib.contextmanager
def jax_tools(tok: dict):
    """The JAX tools with ``load_model`` returning the JAX init, no
    compilation cache, and the perceptual ConvNeXt cut to the tiny one;
    the port's ConvNeXt cut the same way."""
    import eval_recon
    import tokenize_images
    import vit_tpu.losses.perceptual as jax_perceptual
    import vit_tpu.utils.cache as jax_cache
    import vit_tpu_torch.losses.perceptual as port_perceptual

    def load_model(args):
        return tok["net"], jax.tree.map(jnp.asarray, tok["params"]), \
            tok["cfg"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(eval_recon, "load_model", load_model)
        mp.setattr(tokenize_images, "load_model", load_model)
        mp.setattr(jax_cache, "enable_compilation_cache", lambda: None)
        mp.setattr(jax_perceptual, "ConvNeXt", functools.partial(
            jax_perceptual.ConvNeXt, **CONVNEXT))
        mp.setattr(port_perceptual, "ConvNeXt", functools.partial(
            port_perceptual.ConvNeXt, **CONVNEXT))
        yield eval_recon, tokenize_images, mp


def run_jax(mp, main, prog: str, argv) -> str:
    buf = io.StringIO()
    mp.setattr(sys, "argv", [prog, *argv])
    with contextlib.redirect_stdout(buf):
        main()
    return buf.getvalue()


def run_port(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main([*argv, "--device", "cpu"])
    return buf.getvalue()


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_eval_recon_matches_jax(name, root, weights):
    from vit_tpu_torch.eval_recon import main as port_main

    tok = tokenizer(name, str(root))
    argv = ["--ckpt", tok["ckpt"], "--model", name, *ARGV,
            "--lpips_weights", weights["lpips"],
            "--perceptual_weights", weights["perceptual"]]
    with jax_tools(tok) as (eval_recon, _, mp):
        ref = json.loads(run_jax(mp, eval_recon.main, "eval_recon.py",
                                 argv).splitlines()[-1])
        out = json.loads(run_port(port_main, argv).splitlines()[-1])
    assert list(out) == list(ref) == ["psnr", "codebook_usage", "n", "ssim",
                                      "perceptual", "lpips"]
    assert out["n"] == ref["n"] == 4
    assert out["codebook_usage"] == ref["codebook_usage"] > 0
    assert abs(out["psnr"] - ref["psnr"]) <= PSNR_ABS
    assert abs(out["ssim"] - ref["ssim"]) <= SSIM_ABS
    for key in ("perceptual", "lpips"):
        assert ref[key] > 0
        assert abs(out[key] - ref[key]) <= METRIC_REL * ref[key] + 0.5e-5, key


def test_eval_recon_small_images_emit_null_ssim(tmp_path, capsys):
    """Images below SSIM's 11 × 11 window: ``ssim`` is null on both sides
    and the key order is the JAX tool's."""
    import vit_tpu.models.titok as jtt

    from vit_tpu_torch.eval_recon import main as port_main

    fields = dict(TITOK, image_size=8, patch_size=4, latent_tokens=4)
    cfg_j = jtt.TiTokConfig(**fields, dtype=jnp.float32)
    net = jtt.TiTok(cfg_j)
    params = np_tree(jax.jit(net.init)(jax.random.PRNGKey(1),
                                       jnp.zeros((1, 8, 8, 3)))["params"])
    cfg_t = FAMILIES["titok"][0](**fields, dtype=torch.float32)
    model = FAMILIES["titok"][1](cfg_t)
    model.load_state_dict(bridge.module_state_dict_from_flax(params, model))
    Checkpointer(str(tmp_path)).save(
        TrainState.create(model, make_optimizer(1e-4, 1, 10, 1e-5, 0.0)),
        config=cfg_t, tag="best")
    tok = dict(net=net, cfg=cfg_j, params=params)
    argv = ["--ckpt", str(tmp_path), *ARGV, "--synthetic_mode", "noise"]
    with jax_tools(tok) as (eval_recon, _, mp):
        ref = json.loads(run_jax(mp, eval_recon.main, "eval_recon.py",
                                 argv).splitlines()[-1])
        out = json.loads(run_port(port_main, argv).splitlines()[-1])
    assert list(out) == list(ref) == ["psnr", "codebook_usage", "n", "ssim"]
    assert out["ssim"] is None and ref["ssim"] is None
    assert "emitting ssim: null" in capsys.readouterr().err
    assert out["codebook_usage"] == ref["codebook_usage"]
    assert abs(out["psnr"] - ref["psnr"]) <= PSNR_ABS


def test_eval_recon_random_weights_and_refusals(root, capsys):
    """"random" LPIPS and perceptual weights (the JAX tool's smoke path: a
    random draw of each package's own) give finite fields and the
    warnings; a missing tag or an EMA the checkpoint lacks raises."""
    from vit_tpu_torch.eval_recon import main as port_main

    tok = tokenizer("titok", str(root))
    with jax_tools(tok):
        out = port_main(["--ckpt", tok["ckpt"], *ARGV, "--synthetic_mode",
                         "noise", "--lpips_weights", "random",
                         "--perceptual_weights", "random", "--device",
                         "cpu"])
    err = capsys.readouterr().err
    assert "RANDOMLY INITIALIZED ConvNeXt" in err and "RANDOM weights" in err
    assert all(np.isfinite(out[k]) for k in ("psnr", "ssim", "perceptual",
                                             "lpips"))
    with pytest.raises(ValueError, match="EMA"):
        port_main(["--ckpt", tok["ckpt"], "--use_ema", "--device", "cpu"])
    with pytest.raises(FileNotFoundError):
        port_main(["--ckpt", tok["ckpt"], "--tag", "last", "--device",
                   "cpu"])


def write_pngs(folder: Path, n: int, seed: int) -> str:
    from PIL import Image

    folder.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):   # sizes other than 32 go through the resize
        size = (40, 28) if i % 2 else (32, 32)
        Image.fromarray(rng.integers(0, 256, (*size[::-1], 3), np.uint8)
                        ).save(folder / f"{i}.png")
    return str(folder / "*.png")


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_tokenize_images_matches_jax(name, root, tmp_path):
    from PIL import Image

    from vit_tpu_torch.tokenize_images import main as port_main

    tok = tokenizer(name, str(root))
    pattern = write_pngs(tmp_path / "imgs", 5, seed=11)
    common = ["--ckpt", tok["ckpt"], "--model", name, "--bs", "2"]
    with jax_tools(tok) as (_, tokenize_images, mp):
        for side, run in (("jax", lambda a: run_jax(
                mp, tokenize_images.main, "tokenize_images.py", a)),
                ("port", lambda a: run_port(port_main, a))):
            codes = tmp_path / f"{side}.npz"
            said = run(["encode", *common, "--images", pattern, "--out",
                        str(codes)])
            assert f"encoded 5 images -> {codes}" in said
        ref = np.load(tmp_path / "jax.npz", allow_pickle=True)
        got = np.load(tmp_path / "port.npz", allow_pickle=True)
        np.testing.assert_array_equal(got["codes"], ref["codes"])
        assert got["codes"].dtype == ref["codes"].dtype
        np.testing.assert_array_equal(got["paths"], ref["paths"])
        for side, run in (("jax", lambda a: run_jax(
                mp, tokenize_images.main, "tokenize_images.py", a)),
                ("port", lambda a: run_port(port_main, a))):
            said = run(["decode", *common, "--codes",
                        str(tmp_path / "jax.npz"), "--out_dir",
                        str(tmp_path / f"{side}_png")])
            assert said.startswith("decoded 5 code sequences")
    model = tok["model"]
    dec = model.decode_tokens if name == "tatitok" else model.decode_indices
    with torch.no_grad():
        values = dec(torch.from_numpy(ref["codes"])).clamp(0, 1).numpy() * 255
    for i in range(5):
        png = f"{i:06d}.png"
        a = np.asarray(Image.open(tmp_path / "jax_png" / png))
        b = np.asarray(Image.open(tmp_path / "port_png" / png))
        assert a.shape == b.shape == (32, 32, 3)
        # a pixel may differ only where the fp32 value lies within the
        # tolerance of a truncation step
        near_step = np.abs(values[i] - np.round(values[i])) <= (
            255 * PNG_STEP_TOL)
        assert ((a == b) | near_step).all(), png
