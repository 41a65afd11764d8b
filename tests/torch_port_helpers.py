"""Shared set-up for the ``test_torch_*`` parity tests: a tiny transformer
preset registered in both packages, the matching TiTok and VideoGPT configs,
a tiny ConvNeXt perceptual net, JAX weights carried into the port through the
bridge, the JAX train steps, seeded numpy inputs, and a count of the fused
kernels' plain-version calls."""

from __future__ import annotations

import ast
import contextlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_tpu.core.config as jax_config
import vit_tpu_torch.core.config as torch_config
from vit_tpu.models.titok import TiTok as JaxTiTok
from vit_tpu.models.titok import TiTokConfig as JaxTiTokConfig
from vit_tpu_torch.bridge import state_dict_from_flax
from vit_tpu_torch.kernels import fc_grad as k_fc
from vit_tpu_torch.kernels import ln_matmul as k_lnmm
from vit_tpu_torch.models.titok import TiTok, TiTokConfig

# 2 layers, 2 heads, width 128: head_dim 64, so the packed kernel path applies
TINY = dict(n_layers=2, n_heads=2, n_embd=128)
# image 32, patch 8 (16 patches), K 8: S = 24 in both encoder and decoder
TITOK = dict(image_size=32, patch_size=8, latent_tokens=8, codebook_size=64,
             latent_dim=12, transformer="tiny")
# VideoGPT with the tiny transformer swapped in after construction, as
# tests/test_videogpt.py builds its tiny config: 13 frames of 64 codes make
# S = 832 > 768, so attention takes the unpacked path (K6, K7/K8)
VIDEOGPT = dict(frame_size=64, codebook_size=64, transformer="S",
                max_frames=13)
# ConvNeXt with one block per stage; the tests set the fused-tail gate to 64
# so the last stage (C 128) takes the unfused path, as ConvNeXt-S's stage 3
CONVNEXT = dict(depths=(1, 1, 1, 1), dims=(16, 32, 64, 128), num_classes=10)
TINY_FUSED_DIM = 64


def smoke_constant(name: str) -> float:
    """A limit of chip_smoke.py, read from its source (the script holds the
    kernels to it on the card)."""
    tree = ast.parse((Path(__file__).resolve().parents[1]
                      / "chip_smoke.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == name for t in node.targets):
            return float(ast.literal_eval(node.value))
    raise KeyError(name)


@contextlib.contextmanager
def tiny_preset():
    """Register the "tiny" preset in both packages' preset dicts."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_config.transformer_configs, "tiny",
                   lambda **kw: jax_config.TransformerConfig(**TINY, **kw))
        mp.setitem(torch_config.transformer_configs, "tiny",
                   lambda **kw: torch_config.TransformerConfig(**TINY, **kw))
        yield


def configs(dtype: str = "float32"):
    """(JAX TiTokConfig, port TiTokConfig) of the tiny TiTok; call inside
    ``tiny_preset``."""
    return (JaxTiTokConfig(**TITOK, dtype=getattr(jnp, dtype)),
            TiTokConfig(**TITOK, dtype=getattr(torch, dtype)))


def jax_params(cfg_j) -> dict:
    """TiTok.init(PRNGKey(0)) params as a nested dict of numpy arrays."""
    x = jnp.zeros((1, cfg_j.image_size, cfg_j.image_size, 3))
    params = jax.jit(JaxTiTok(cfg_j).init)(jax.random.PRNGKey(0), x)["params"]
    return jax.tree.map(np.asarray, params)


def port_model(cfg_t, params: dict) -> TiTok:
    """The port's TiTok on the CPU, filled with the JAX weights."""
    model = TiTok(cfg_t, device="meta")
    model.load_state_dict(state_dict_from_flax(params, cfg_t), assign=True)
    return model.eval().requires_grad_(False)


def images(n: int, seed: int = 0, size: int = 32) -> np.ndarray:
    return np.random.default_rng(seed).uniform(
        0.0, 1.0, (n, size, size, 3)).astype(np.float32)


def convnext_params() -> dict:
    """The tiny JAX ConvNeXt's init(PRNGKey(0)) params, numpy leaves."""
    from vit_tpu.losses.perceptual import ConvNeXt as JaxConvNeXt

    # the params do not depend on the image size; 32 keeps the init cheap
    params = jax.jit(JaxConvNeXt(**CONVNEXT).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]
    return jax.tree.map(np.asarray, params)


def with_gamma(params: dict, seed: int = 0) -> dict:
    """``params`` with every block's layer scale γ drawn around 0.5: at the
    init's 1e-6 a block's tail vanishes under the residual, and a broken
    tail kernel would go unseen."""
    rng = np.random.default_rng(seed)
    out = {k: dict(v) if isinstance(v, dict) else v for k, v in params.items()}
    for name, blk in out.items():
        if "_block" in name:
            blk["gamma"] = (0.5 + 0.1 * rng.normal(size=blk["gamma"].shape)
                            ).astype(np.float32)
    return out


def jax_perceptual(params: dict, dtype=jnp.float32, **model_kw):
    """The JAX PerceptualLoss around the tiny ConvNeXt, built as the JAX
    package's own tests build it; ``model_kw`` go to its ConvNeXt
    (``mlp_impl``, ``dw_impl``, ``quant``)."""
    from vit_tpu.losses.perceptual import ConvNeXt as JaxConvNeXt
    from vit_tpu.losses.perceptual import PerceptualLoss as JaxPerceptual

    loss = JaxPerceptual.__new__(JaxPerceptual)
    loss.model = JaxConvNeXt(**CONVNEXT, dtype=dtype, **model_kw)
    loss.layout = "nhwc"
    loss.params = jax.tree.map(jnp.asarray, params)
    return loss


def port_perceptual(params: dict, dtype=torch.float32, **convnext_kw):
    """The port's PerceptualLoss with the same tiny ConvNeXt weights;
    ``convnext_kw`` go to its ConvNeXt (``dw_impl``, ``quant``)."""
    from vit_tpu_torch.losses.perceptual import PerceptualLoss

    return PerceptualLoss.from_params(params, dtype=dtype, **CONVNEXT,
                                      **convnext_kw)


def jax_train_step(model, perceptual, **opt):
    """The JAX package's jitted tokenizer step and a fresh TrainState
    factory for ``make_optimizer(**opt)``."""
    from vit_tpu.train.optim import make_optimizer
    from vit_tpu.train.state import TrainState
    from vit_tpu.train.step import make_tokenizer_train_step

    tx = make_optimizer(**opt)
    step = jax.jit(make_tokenizer_train_step(model,
                                             perceptual_loss_fn=perceptual))
    return step, lambda params: TrainState.create(params, tx)


def videogpt_configs(dtype: str = "float32", **kw):
    """(JAX VideoGPTConfig with attn_impl "pallas", port VideoGPTConfig) of
    the tiny VideoGPT: ``VIDEOGPT`` with keyword overrides, then the
    transformer cut to ``TINY``."""
    from vit_tpu.models.videogpt import VideoGPTConfig as JaxVideoGPTConfig
    from vit_tpu_torch.models.videogpt import VideoGPTConfig

    fields = {**VIDEOGPT, **kw}
    cfg_j = JaxVideoGPTConfig(**fields, dtype=getattr(jnp, dtype),
                              attn_impl="pallas")
    cfg_t = VideoGPTConfig(**fields, dtype=getattr(torch, dtype))
    for cfg in (cfg_j, cfg_t):
        cfg.trans_config = cfg.trans_config.replace(**TINY)
        cfg.n_embd = TINY["n_embd"]
    return cfg_j, cfg_t


def videogpt_params(cfg_j) -> dict:
    """VideoGPT.init(PRNGKey(1)) params as a nested dict of numpy arrays
    (one frame is enough: the params do not depend on the length)."""
    from vit_tpu.models.videogpt import VideoGPT as JaxVideoGPT

    x = jnp.zeros((1, 1, cfg_j.frame_size), jnp.int32)
    params = jax.jit(JaxVideoGPT(cfg_j).init)(jax.random.PRNGKey(1), x)["params"]
    return jax.tree.map(np.asarray, params)


def port_videogpt(cfg_t, params: dict):
    """The port's VideoGPT on the CPU, filled with the JAX weights."""
    from vit_tpu_torch.bridge import videogpt_state_dict_from_flax
    from vit_tpu_torch.models.videogpt import VideoGPT

    model = VideoGPT(cfg_t, device="meta")
    model.load_state_dict(videogpt_state_dict_from_flax(params, cfg_t),
                          assign=True)
    return model.eval()


def tail_inputs(n: int, c: int, seed: int) -> dict:
    """Seeded fp32 inputs of a ConvNeXt block tail: rows h, x, dy (n, c) and
    its parameters in the JAX layout (w1 (c, 4c), w2 (4c, c)), γ of order
    0.5 so the tail shows under the residual."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return (scale * rng.normal(size=shape)).astype(np.float32)

    return dict(h=r(n, c), x=r(n, c), dy=r(n, c), lns=1.0 + r(c, scale=0.1),
                lnb=r(c, scale=0.1), w1=r(c, 4 * c, scale=c ** -0.5),
                b1=r(4 * c, scale=0.1), w2=r(4 * c, c, scale=(4 * c) ** -0.5),
                b2=r(c, scale=0.1), gamma=r(c, scale=0.5))


def scaled_err(out, ref) -> float:
    """max |out − ref| / max |ref|, in fp32."""
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    return np.abs(out - ref).max() / (np.abs(ref).max() + 1e-8)


def codes(shape, n_codes: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, n_codes, shape,
                                                dtype=np.int32)


def count_plain_calls(monkeypatch) -> dict:
    """Count the calls of the four kernels' plain versions (which the
    wrappers run on the CPU): proof that a fused path ran."""
    calls = dict.fromkeys(("ln_matmul_fwd", "ln_matmul_dgelu", "ln_bwd",
                           "fc_grad"), 0)
    routes = [(k_lnmm, "ln_matmul_fwd_ref", "ln_matmul_fwd"),
              (k_lnmm, "ln_matmul_dgelu_ref", "ln_matmul_dgelu"),
              (k_lnmm, "ln_bwd_ref", "ln_bwd"),
              (k_fc, "matmul_dw_db_ref", "fc_grad")]
    for mod, attr, key in routes:
        def spy(*args, _fn=getattr(mod, attr), _key=key, **kw):
            calls[_key] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(mod, attr, spy)
    return calls


def jax_noise(key, b: int, n: int) -> np.ndarray:
    """The (b, n) mask noise that MAE and Puzzle draw in the JAX package
    under ``rngs={"mask": key}``: both are root modules whose one
    ``make_rng("mask")`` call feeds ``jax.random.uniform``
    (``vit_tpu/models/mae.py:random_masking``), so a root module making the
    same call draws the same noise."""
    import flax.linen as fnn

    class NoiseOf(fnn.Module):
        @fnn.compact
        def __call__(self, b):
            return jax.random.uniform(self.make_rng("mask"), (b, n))

    return np.array(NoiseOf().apply({}, b, rngs={"mask": key}))


def moved_params(key: str, got, start, ref):
    """(port's change, JAX's change) of parameter ``key`` over some steps.
    For a packed qkv bias the k third is left out: softmax is invariant to
    a shift of every score of a row, so k's bias gradient is rounding noise
    on both sides, which Adam scales up to lr-sized steps of either sign."""
    moved, moved_ref = got - start, ref - start
    if key.endswith("qkv/bias"):
        third = moved.shape[-1] // 3
        keep = np.r_[0:third, 2 * third:3 * third]
        moved, moved_ref = moved[..., keep], moved_ref[..., keep]
    return moved, moved_ref
