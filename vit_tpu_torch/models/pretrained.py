"""Pretrained tokenizers: the frozen interface VideoGPT trains on and the
loader of ``--tokenizer_ckpt`` (counterpart of
``vit_tpu/models/pretrained.py`` and ``train_videogpt.py:91-124``).

The JAX class pairs a flax module with its params; here the port's ``TiTok``
or ``TATiTok`` holds its own weights, so the wrapper takes the module alone
and freezes it (eval mode, no gradients). A TATiTok encodes through
``encode(...)[1]["min_encoding_indices"]`` and decodes through
``decode_tokens``, as the JAX wrapper does.

A Bytedance ``oned_tokenizer`` folder (``config.yaml`` plus
``checkpoint-*/unwrapped_model/pytorch_model.bin`` or a bare
``pytorch_model.bin``) is read with PyYAML, imported only then, and
``torch.load(..., map_location="cpu")``; ``convert_bytedance_state_dict``
maps its torch names straight onto the port's (``vit_tpu/models/
pretrained.py:33-124``, which maps them onto the flax tree), and
``config_from_bytedance_yaml`` reads its config (:127-143, fp32).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

import torch

from vit_tpu_torch.models.tatitok import TATiTok, TATiTokConfig
from vit_tpu_torch.models.titok import TiTok, TiTokConfig

# the "random" tokenizer's weights (train_videogpt.py:104 seeds its init
# with PRNGKey(123))
RANDOM_TOKENIZER_SEED = 123


class FrozenTokenizer:
    """Image batch → code indices and back (reference train_videogpt.py:
    124-127, 146-158)."""

    def __init__(self, model: "TiTok | TATiTok"):
        if not isinstance(model, (TiTok, TATiTok)):
            raise NotImplementedError(
                f"FrozenTokenizer takes the port's TiTok or TATiTok, got "
                f"{type(model).__name__}")
        self.model = model.eval().requires_grad_(False)
        self._is_tatitok = isinstance(model, TATiTok)

    @property
    def latent_tokens(self) -> int:
        return self.model.config.latent_tokens

    @property
    def codebook_size(self) -> int:
        return self.model.config.codebook_size

    @property
    def image_size(self) -> int:
        return self.model.config.image_size

    @torch.no_grad()
    def encode_indices(self, frames: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) in [0, 1] → (N, K) int32 codes."""
        if self._is_tatitok:
            return self.model.encode(frames)[1]["min_encoding_indices"]
        return self.model.encode(frames)

    @torch.no_grad()
    def decode_indices(self, indices: torch.Tensor) -> torch.Tensor:
        """(N, K) codes → (N, H, W, 3) images."""
        if self._is_tatitok:
            return self.model.decode_tokens(indices)
        return self.model.decode_indices(indices)


# the Bytedance block's names (blocks.py's ResidualAttentionBlock) → the
# port's, after "<encoder|decoder>.transformer.<i>."
BLOCK_NAMES = {"ln_1": "ln1", "ln_2": "ln2",
               "attn.in_proj_weight": "attn.qkv.weight",
               "attn.in_proj_bias": "attn.qkv.bias",
               "mlp.c_fc": "mlp.fc1", "mlp.c_proj": "mlp.fc2"}


def _renamed(rest: str, names: dict) -> str:
    for a, b in names.items():
        if rest.startswith(a):
            return b + rest[len(a):]
    return rest


def convert_bytedance_state_dict(sd: Dict, config: TATiTokConfig
                                 ) -> "dict[str, torch.Tensor]":
    """A Bytedance TiTok/TATiTok torch state dict → the port's
    ``TATiTok(config)`` state dict (fp32). ``nn.MultiheadAttention``'s
    ``in_proj`` packs [q; k; v] as the fused qkv does, so the block
    weights keep their (out, in) layout; the patch conv (W, 3, p, p)
    becomes the dense over (p1 p2 c) columns, the 1×1 convs dense weights,
    the class and mask tokens gain their leading axes."""
    def arr(key):
        return torch.as_tensor(sd[key]).detach().float().cpu()

    p, width = config.patch_size, config.width
    out = {"latent_tokens": arr("latent_tokens"),
           "quantize.embedding": arr("quantize.embedding.weight")}
    for part in ("encoder", "decoder"):
        for i in range(config.trans_config.n_layers):
            src = f"{part}.transformer.{i}."
            for key in sd:
                if key.startswith(src):
                    rest = _renamed(key[len(src):], BLOCK_NAMES)
                    out[f"{part}.transformer.layers.{i}.{rest}"] = arr(key)
        for name in ("positional_embedding",
                     "latent_token_positional_embedding", "ln_pre.weight",
                     "ln_pre.bias", "ln_post.weight", "ln_post.bias"):
            out[f"{part}.{name}"] = arr(f"{part}.{name}")
        out[f"{part}.class_embedding"] = arr(
            f"{part}.class_embedding").reshape(1, width)
    out["encoder.patch_embed.weight"] = arr(
        "encoder.patch_embed.weight").permute(0, 2, 3, 1).reshape(
            width, p * p * 3)
    out["encoder.patch_embed.bias"] = arr("encoder.patch_embed.bias")
    out["encoder.conv_out.weight"] = arr("encoder.conv_out.weight")[:, :, 0, 0]
    out["encoder.conv_out.bias"] = arr("encoder.conv_out.bias")
    for name in ("decoder_embed.weight", "decoder_embed.bias",
                 "conv_out.weight", "conv_out.bias"):
        out[f"decoder.{name}"] = arr(f"decoder.{name}")
    out["decoder.mask_token"] = arr("decoder.mask_token").reshape(1, 1, width)
    out["decoder.ffn.weight"] = arr("decoder.ffn.0.weight")[:, :, 0, 0]
    out["decoder.ffn.bias"] = arr("decoder.ffn.0.bias")
    if config.text_guidance and "decoder.text_guidance_proj.weight" in sd:
        for name in ("text_guidance_proj.weight", "text_guidance_proj.bias",
                     "text_guidance_positional_embedding"):
            out[f"decoder.{name}"] = arr(f"decoder.{name}")
    return {k: v.contiguous() for k, v in out.items()}


def bytedance_state_dict(model: TATiTok) -> "dict[str, torch.Tensor]":
    """The inverse of ``convert_bytedance_state_dict``: the port's TATiTok
    weights under the Bytedance torch names and layouts (host copies)."""
    cfg = model.config
    p, width = cfg.patch_size, cfg.width
    sd = {k: v.detach().float().cpu() for k, v in model.state_dict().items()}
    out = {"latent_tokens": sd["latent_tokens"],
           "quantize.embedding.weight": sd["quantize.embedding"]}
    back = {b: a for a, b in BLOCK_NAMES.items()}
    for key, t in sd.items():
        part, _, rest = key.partition(".transformer.layers.")
        if rest:
            i, _, rest = rest.partition(".")
            out[f"{part}.transformer.{i}.{_renamed(rest, back)}"] = t
    for part in ("encoder", "decoder"):
        for name in ("positional_embedding",
                     "latent_token_positional_embedding", "ln_pre.weight",
                     "ln_pre.bias", "ln_post.weight", "ln_post.bias"):
            out[f"{part}.{name}"] = sd[f"{part}.{name}"]
        out[f"{part}.class_embedding"] = sd[f"{part}.class_embedding"][0]
    out["encoder.patch_embed.weight"] = sd["encoder.patch_embed.weight"
                                           ].reshape(width, p, p, 3
                                                     ).permute(0, 3, 1, 2)
    out["encoder.patch_embed.bias"] = sd["encoder.patch_embed.bias"]
    out["encoder.conv_out.weight"] = sd["encoder.conv_out.weight"][
        :, :, None, None]
    out["encoder.conv_out.bias"] = sd["encoder.conv_out.bias"]
    for name in ("decoder_embed.weight", "decoder_embed.bias",
                 "conv_out.weight", "conv_out.bias"):
        out[f"decoder.{name}"] = sd[f"decoder.{name}"]
    out["decoder.mask_token"] = sd["decoder.mask_token"].reshape(1, 1, width)
    out["decoder.ffn.0.weight"] = sd["decoder.ffn.weight"][:, :, None, None]
    out["decoder.ffn.0.bias"] = sd["decoder.ffn.bias"]
    if cfg.text_guidance:
        for name in ("text_guidance_proj.weight", "text_guidance_proj.bias",
                     "text_guidance_positional_embedding"):
            out[f"decoder.{name}"] = sd[f"decoder.{name}"]
    return {k: v.contiguous() for k, v in out.items()}


def write_bytedance_folder(model: TATiTok, folder: Path) -> Path:
    """A Bytedance ``oned_tokenizer`` folder of ``model``: ``config.yaml``
    (written as JSON, which YAML reads) and
    ``checkpoint-0/unwrapped_model/pytorch_model.bin``."""
    cfg = model.config
    vq = dict(vit_enc_model_size=cfg.transformer,
              vit_enc_patch_size=cfg.patch_size,
              num_latent_tokens=cfg.latent_tokens,
              codebook_size=cfg.codebook_size, token_size=cfg.latent_dim,
              use_l2_norm=cfg.use_l2_norm)
    if cfg.text_guidance:
        vq["text_context_length"] = cfg.text_context_length
    folder = Path(folder)
    ckpt = folder / "checkpoint-0" / "unwrapped_model"
    ckpt.mkdir(parents=True, exist_ok=True)
    (folder / "config.yaml").write_text(json.dumps(
        {"model": {"vq_model": vq},
         "dataset": {"preprocessing": {"crop_size": cfg.image_size}}},
        indent=2))
    torch.save(bytedance_state_dict(model), ckpt / "pytorch_model.bin")
    return folder


def config_from_bytedance_yaml(folder: Path) -> TATiTokConfig:
    """The ``TATiTokConfig`` of a Bytedance folder's ``config.yaml``
    (fp32), read with PyYAML; a machine without it is refused naming the
    package."""
    try:
        import yaml
    except ImportError as e:
        raise NotImplementedError(
            f"{folder}: a Bytedance tokenizer's config.yaml is read with "
            f"PyYAML (the yaml package), which this machine lacks") from e
    cfg = yaml.safe_load((folder / "config.yaml").read_text())
    vq = cfg.get("model", {}).get("vq_model", {})
    ds = cfg.get("dataset", {}).get("preprocessing", {})
    return TATiTokConfig(
        image_size=int(ds.get("crop_size", vq.get("image_size", 256))),
        patch_size=int(vq.get("vit_enc_patch_size", vq.get("patch_size", 16))),
        latent_tokens=int(vq.get("num_latent_tokens", 32)),
        codebook_size=int(vq.get("codebook_size", 4096)),
        latent_dim=int(vq.get("token_size", 12)),
        transformer=str(vq.get("vit_enc_model_size", "base")),
        use_l2_norm=bool(vq.get("use_l2_norm", True)),
        text_guidance=bool(vq.get("is_legacy", False) is False
                           and "text_context_length" in vq),
        dtype=torch.float32)


def load_bytedance(folder: Path) -> TATiTok:
    """A Bytedance folder's TATiTok on the host, its weights converted."""
    config = config_from_bytedance_yaml(folder)
    ckpts = sorted(folder.glob(
        "checkpoint-*/unwrapped_model/pytorch_model.bin"))
    if not ckpts:
        ckpts = sorted(folder.glob("pytorch_model.bin"))
    if not ckpts:
        raise FileNotFoundError(f"no pytorch_model.bin under {folder}")
    sd = torch.load(ckpts[-1], map_location="cpu", weights_only=True)
    model = TATiTok(config)
    model.load_state_dict(convert_bytedance_state_dict(sd, config))
    return model


def load_tokenizer(spec: str, dtype: torch.dtype, device, *,
                   image_size: int = 64, frame_size: int = 64,
                   codebook_size: int = 1024) -> FrozenTokenizer:
    """``--tokenizer_ckpt`` as ``train_videogpt.py:load_tokenizer`` reads it:

    - ``"random"``: ``TiTokConfig(image_size, 8, frame_size, codebook_size,
      12, "S")`` with weights drawn from ``RANDOM_TOKENIZER_SEED``;
    - a directory the port's ``train_titok`` wrote (``best_config.json`` and
      ``best/state.pt``): that config, computing in ``dtype``, with the
      "best" parameters;
    - a directory the port's ``train_tatitok`` wrote (``use_l2_norm`` in
      ``best_config.json``): that TATiTok config, in its own dtype as the
      JAX loader keeps it, with the "best" parameters;
    - any other directory, a Bytedance folder (``load_bytedance``, fp32).

    An FSQ tokenizer raises."""
    from vit_tpu_torch.train.checkpoint import load_params
    from vit_tpu_torch.utils.config import dataclass_from_dict
    from vit_tpu_torch.utils.init import init_params_

    if spec == "random":
        model = TiTok(TiTokConfig(image_size, 8, frame_size, codebook_size, 12,
                                  "S", dtype=dtype))
        init_params_(model, torch.Generator().manual_seed(
            RANDOM_TOKENIZER_SEED))
        return FrozenTokenizer(model.to(device))
    cfg_path = Path(spec) / "best_config.json"
    data = json.loads(cfg_path.read_text()) if cfg_path.exists() else None
    if data is None:
        model = load_bytedance(Path(spec))
    elif "use_l2_norm" in data:
        cfg = dataclass_from_dict(TATiTokConfig, data)
        model = TATiTok(cfg)
        model.load_state_dict(load_params(spec, "best"))
    else:
        cfg = dataclass_from_dict(TiTokConfig, data)
        if cfg.quantizer == "fsq":
            raise NotImplementedError(
                f"--tokenizer_ckpt {spec}: an FSQ tokenizer's codes range "
                "over prod(fsq_levels), not the prior's codebook_size "
                "vocabulary (ROADMAP Queue C, reference-side hazards)")
        cfg.dtype = dtype
        cfg.__post_init__()
        model = TiTok(cfg, device="meta")
        model.load_state_dict(load_params(spec, "best"), assign=True)
    return FrozenTokenizer(model.to(device))
