"""The LlamaGen VQGAN, the frozen taming-style CNN tokenizer (counterpart of
``vit_tpu/models/llamagen_vq.py:38-290``).

The LlamaGen-TiTok trainer compresses this tokenizer's codes and reads its
weights from LlamaGen's own ``{"model": state_dict}`` ``.pt`` files. This
module is its inference surface, ``encode`` (images → code indices) and
``decode_indices`` (indices → images), with the checkpoint path both ways:
``load_llamagen_vq`` infers every hyperparameter from the state dict's keys
and shapes (``_infer_config``) and maps LlamaGen's keys to the port's
(``convert_llamagen_state_dict``); ``llamagen_state_dict`` writes a model
back in LlamaGen's layout.

Architecture: conv_in → per level [ResnetBlock × n (+ AttnBlock)] with a
stride-2 downsample after the taming asymmetric (0, 1) pad on H and W →
mid Resnet/Attn/Resnet → GroupNorm/swish/conv_out → 1×1 quant_conv → the
L2-normalised nearest code (K5); the decoder mirrors it with nearest 2×
upsampling and n + 1 blocks a level. GroupNorm is flax's: 32 groups, eps
1e-6, statistics over (H, W, C/G) in fp32 as E[x²] − mean². The whole model
is fp32, as the flax modules (which have no ``dtype``); on the card the
caller keeps TF32 off (``utils/precision.py:disable_tf32``), since cuDNN's
default TF32 convolutions would move the codes.

The port's images are NHWC as the JAX package's; the convolutions run NCHW
inside. Modules are named after the flax modules (``encoder.down_0_res_0``,
``encoder.mid_attn_0``, ``decoder.up_0_upsample``, ``codebook``), so the
bridge's rule carries JAX weights over (``bridge.py``).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vit_tpu_torch.kernels.vq import nearest_code


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups=32, epsilon=1e-6)`` on NCHW."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-6,
                 device=None):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        g = x.float().reshape(b, self.groups, -1)
        mu = g.mean(-1, keepdim=True)
        var = ((g * g).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
        y = ((g - mu) * torch.rsqrt(var + self.eps)).reshape(b, c, h, w)
        return y * self.weight[:, None, None] + self.bias[:, None, None]


def _conv(cin: int, cout: int, k: int, device, stride: int = 1,
          padding: int = 0) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding,
                     device=device)


class ResnetBlock(nn.Module):
    """GN → swish → conv3, twice, plus the input (through a 1×1
    ``nin_shortcut`` where the channel count changes)."""

    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.norm1 = GroupNorm(cin, device=device)
        self.conv1 = _conv(cin, cout, 3, device, padding=1)
        self.norm2 = GroupNorm(cout, device=device)
        self.conv2 = _conv(cout, cout, 3, device, padding=1)
        if cin != cout:
            self.nin_shortcut = _conv(cin, cout, 1, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over the H·W positions, 1×1 q, k, v and
    proj_out, scores in fp32 at scale c^-0.5. A plain product, as it is
    outside any Pallas kernel in the JAX package."""

    def __init__(self, c: int, device=None):
        super().__init__()
        self.norm = GroupNorm(c, device=device)
        self.q = _conv(c, c, 1, device)
        self.k = _conv(c, c, 1, device)
        self.v = _conv(c, c, 1, device)
        self.proj_out = _conv(c, c, 1, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        h = self.norm(x)
        q = self.q(h).reshape(b, c, hh * ww).transpose(1, 2)
        k = self.k(h).reshape(b, c, hh * ww)
        v = self.v(h).reshape(b, c, hh * ww).transpose(1, 2)
        w = torch.softmax(torch.matmul(q, k) * c ** -0.5, dim=-1)
        h = torch.matmul(w, v).transpose(1, 2).reshape(b, c, hh, ww)
        return x + self.proj_out(h)


@dataclasses.dataclass(eq=False)
class LlamaGenVQConfig:
    """LlamaGen VQ-16's widths by default. ``enc_attn``/``dec_attn`` are
    each level's attention-block counts, the decoder's in its order
    (highest-channel level first)."""

    ch: int = 128
    ch_mult: Sequence[int] = (1, 1, 2, 2, 4)
    num_res_blocks: int = 2
    enc_attn: Sequence[int] = ()
    dec_attn: Sequence[int] = ()
    z_channels: int = 256
    embed_dim: int = 8
    n_embed: int = 16384
    l2_norm: bool = True

    def __post_init__(self):
        self.ch_mult = tuple(self.ch_mult)
        self.num_levels = len(self.ch_mult)
        self.enc_attn = tuple(self.enc_attn) or (0,) * self.num_levels
        self.dec_attn = tuple(self.dec_attn) or (0,) * self.num_levels
        self.downsample_factor = 2 ** (self.num_levels - 1)


def vq16_config() -> LlamaGenVQConfig:
    """VQ-16 with attention where LlamaGen's ``vq_model.py`` places it:
    after each res block of the encoder's last level and of the decoder's
    first."""
    return LlamaGenVQConfig(enc_attn=(0, 0, 0, 0, 2),
                            dec_attn=(3, 0, 0, 0, 0))


class LlamaGenEncoder(nn.Module):
    def __init__(self, cfg: LlamaGenVQConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.conv_in = _conv(3, cfg.ch, 3, device, padding=1)
        c = cfg.ch
        for i, mult in enumerate(cfg.ch_mult):
            out = cfg.ch * mult
            for j in range(cfg.num_res_blocks):
                self.add_module(f"down_{i}_res_{j}",
                                ResnetBlock(c, out, device=device))
                c = out
                if j < cfg.enc_attn[i]:
                    self.add_module(f"down_{i}_attn_{j}",
                                    AttnBlock(c, device=device))
            if i != cfg.num_levels - 1:
                self.add_module(f"down_{i}_downsample",
                                _conv(c, c, 3, device, stride=2))
        self.mid_res_0 = ResnetBlock(c, c, device=device)
        self.mid_attn_0 = AttnBlock(c, device=device)
        self.mid_res_1 = ResnetBlock(c, c, device=device)
        self.norm_out = GroupNorm(c, device=device)
        self.conv_out = _conv(c, cfg.z_channels, 3, device, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = self.conv_in(x)
        for i in range(cfg.num_levels):
            for j in range(cfg.num_res_blocks):
                h = getattr(self, f"down_{i}_res_{j}")(h)
                if j < cfg.enc_attn[i]:
                    h = getattr(self, f"down_{i}_attn_{j}")(h)
            if i != cfg.num_levels - 1:
                # taming's Downsample: pad bottom and right by one, then a
                # stride-2 valid conv
                h = getattr(self, f"down_{i}_downsample")(
                    F.pad(h, (0, 1, 0, 1)))
        h = self.mid_res_1(self.mid_attn_0(self.mid_res_0(h)))
        return self.conv_out(F.silu(self.norm_out(h)))


class LlamaGenDecoder(nn.Module):
    def __init__(self, cfg: LlamaGenVQConfig, device=None):
        super().__init__()
        self.cfg = cfg
        mults = list(reversed(cfg.ch_mult))   # coarse → fine
        c = cfg.ch * mults[0]
        self.conv_in = _conv(cfg.z_channels, c, 3, device, padding=1)
        self.mid_res_0 = ResnetBlock(c, c, device=device)
        self.mid_attn_0 = AttnBlock(c, device=device)
        self.mid_res_1 = ResnetBlock(c, c, device=device)
        for i, mult in enumerate(mults):
            out = cfg.ch * mult
            for j in range(cfg.num_res_blocks + 1):
                self.add_module(f"up_{i}_res_{j}",
                                ResnetBlock(c, out, device=device))
                c = out
                if j < cfg.dec_attn[i]:
                    self.add_module(f"up_{i}_attn_{j}",
                                    AttnBlock(c, device=device))
            if i != cfg.num_levels - 1:
                self.add_module(f"up_{i}_upsample",
                                _conv(c, c, 3, device, padding=1))
        self.norm_out = GroupNorm(c, device=device)
        self.conv_out = _conv(c, 3, 3, device, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = self.conv_in(z)
        h = self.mid_res_1(self.mid_attn_0(self.mid_res_0(h)))
        for i in range(cfg.num_levels):
            for j in range(cfg.num_res_blocks + 1):
                h = getattr(self, f"up_{i}_res_{j}")(h)
                if j < cfg.dec_attn[i]:
                    h = getattr(self, f"up_{i}_attn_{j}")(h)
            if i != cfg.num_levels - 1:
                h = h.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
                h = getattr(self, f"up_{i}_upsample")(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class LlamaGenVQ(nn.Module):
    """The frozen tokenizer's inference surface, fp32, NHWC images."""

    def __init__(self, config: LlamaGenVQConfig, device=None):
        super().__init__()
        self.config = config
        self.encoder = LlamaGenEncoder(config, device=device)
        self.decoder = LlamaGenDecoder(config, device=device)
        self.quant_conv = _conv(config.z_channels, config.embed_dim, 1,
                                device)
        self.post_quant_conv = _conv(config.embed_dim, config.z_channels, 1,
                                     device)
        self.codebook = nn.Parameter(torch.empty(
            config.n_embed, config.embed_dim, device=device))

    @torch.no_grad()
    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) → (B, (H/f)·(W/f)) int32 codes, row-major grid."""
        z = self.quant_conv(self.encoder(images.float().permute(0, 3, 1, 2)))
        b = z.shape[0]
        z = z.permute(0, 2, 3, 1).reshape(-1, self.config.embed_dim)
        idx = nearest_code(z.contiguous(), self.codebook,
                           l2_normalize=self.config.l2_norm)
        return idx.reshape(b, -1)

    @torch.no_grad()
    def decode_indices(self, indices: torch.Tensor) -> torch.Tensor:
        """(B, N) codes on a round(√N)-square grid → (B, H, W, 3)."""
        b, n = indices.shape
        g = int(round(n ** 0.5))
        zq = F.embedding(indices.reshape(-1).long(), self.codebook)
        if self.config.l2_norm:
            zq = zq / zq.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        zq = zq.reshape(b, g, g, -1).permute(0, 3, 1, 2)
        return self.decoder(self.post_quant_conv(zq)).permute(0, 2, 3, 1)


# --------------------------- LlamaGen's key layout ---------------------------

# port key → LlamaGen key, in order; the inverse swaps each pair's sides
_RENAMES = (
    (r"^(encoder|decoder)\.(?:down|up)_(\d+)_res_(\d+)\.",
     r"\1.conv_blocks.\2.res.\3."),
    (r"^(encoder|decoder)\.(?:down|up)_(\d+)_attn_(\d+)\.",
     r"\1.conv_blocks.\2.attn.\3."),
    (r"^encoder\.down_(\d+)_downsample\.",
     r"encoder.conv_blocks.\1.downsample.conv."),
    (r"^decoder\.up_(\d+)_upsample\.",
     r"decoder.conv_blocks.\1.upsample.conv."),
    (r"^(encoder|decoder)\.mid_res_0\.", r"\1.mid.0."),
    (r"^(encoder|decoder)\.mid_attn_0\.", r"\1.mid.1."),
    (r"^(encoder|decoder)\.mid_res_1\.", r"\1.mid.2."),
    (r"^codebook$", "quantize.embedding.weight"),
)


def llamagen_key(port_key: str) -> str:
    """The port's parameter name → LlamaGen's."""
    for pat, rep in _RENAMES:
        key, n = re.subn(pat, rep, port_key)
        if n:
            return key
    return port_key


def _infer_config(sd: Dict) -> LlamaGenVQConfig:
    """Every hyperparameter from a LlamaGen state dict's keys and shapes."""
    ch = int(sd["encoder.conv_in.weight"].shape[0])
    levels = 1 + max(int(m.group(1)) for k in sd
                     if (m := re.match(r"encoder\.conv_blocks\.(\d+)\.", k)))
    num_res = 1 + max(
        int(m.group(1)) for k in sd
        if (m := re.match(r"encoder\.conv_blocks\.0\.res\.(\d+)\.", k)))
    ch_mult, enc_attn, dec_attn = [], [], []
    for i in range(levels):
        w = sd[f"encoder.conv_blocks.{i}.res.0.conv1.weight"]
        ch_mult.append(int(w.shape[0]) // ch)
        enc_attn.append(len({k.split(".")[4] for k in sd if k.startswith(
            f"encoder.conv_blocks.{i}.attn.")}))
        dec_attn.append(len({k.split(".")[4] for k in sd if k.startswith(
            f"decoder.conv_blocks.{i}.attn.")}))
    emb = sd["quantize.embedding.weight"]
    return LlamaGenVQConfig(ch=ch, ch_mult=tuple(ch_mult),
                            num_res_blocks=num_res, enc_attn=tuple(enc_attn),
                            dec_attn=tuple(dec_attn),
                            z_channels=int(sd["encoder.conv_out.weight"]
                                           .shape[0]),
                            embed_dim=int(emb.shape[1]),
                            n_embed=int(emb.shape[0]))


def convert_llamagen_state_dict(sd: Dict
                                ) -> Tuple[LlamaGenVQConfig,
                                           "dict[str, torch.Tensor]"]:
    """A LlamaGen ``VQModel`` state dict → (config, the port's state dict,
    fp32). Each port parameter is read from its LlamaGen key (both are
    OIHW), so keys LlamaGen keeps beside the weights (usage buffers) are
    left out; a missing or misshapen one raises."""
    cfg = _infer_config(sd)
    expected = LlamaGenVQ(cfg, device="meta").state_dict()
    out = {}
    for key, want in expected.items():
        src = llamagen_key(key)
        if src not in sd:
            raise KeyError(f"LlamaGen checkpoint has no {src!r} (for {key})")
        t = torch.as_tensor(sd[src]).float()
        if tuple(t.shape) != tuple(want.shape):
            raise ValueError(f"{src}: shape {tuple(t.shape)} does not fit "
                             f"{key} {tuple(want.shape)}")
        out[key] = t.contiguous()
    return cfg, out


def llamagen_state_dict(model: LlamaGenVQ) -> "dict[str, torch.Tensor]":
    """The inverse of ``convert_llamagen_state_dict``: ``model``'s weights
    under LlamaGen's keys, on the host."""
    return {llamagen_key(k): v.detach().cpu().clone()
            for k, v in model.state_dict().items()}


def load_llamagen_vq(path: str, device=None) -> LlamaGenVQ:
    """A LlamaGen ``{"model": state_dict}`` ``.pt`` (or a bare state dict)
    → the port's model in eval mode, on ``device``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt["model"] if "model" in ckpt else ckpt
    cfg, weights = convert_llamagen_state_dict(sd)
    model = LlamaGenVQ(cfg, device="meta")
    model.load_state_dict(weights, assign=True)
    return model.to(device).eval().requires_grad_(False)
