"""VideoGPT, the causal AR prior over flattened frame tokens (counterpart of
``vit_tpu/models/videogpt.py:28-217``).

Forward: flatten (B, T, N) frame tokens, prepend SOS (index
``codebook_size``), token + position embeddings summed in fp32 and cast to
the compute dtype, the causal transformer, an fp32 projection to codebook
logits, and the mean next-token cross-entropy. At S > 768 (the reference's
16 frames × 64 tokens = 1024) attention runs the unpacked kernels K6 and
K7/K8.

Generation keeps an explicit KV cache (``init_cache``): one causal prefill
over SOS and the conditioning codes (K6), then one single-token decode step
per generated code. Greedy decoding is ``argmax`` with the lowest index on
ties, as ``jnp.argmax``; temperature / top-k sampling draws from an explicit
``torch.Generator``, which cannot reproduce JAX's stream.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vit_tpu_torch.core.config import TransformerConfig, transformer_configs
from vit_tpu_torch.core.transformer import Transformer, init_kv_cache, linear


@dataclasses.dataclass(eq=False)
class VideoGPTConfig:
    """The reference's VideoGPTConfig (train_videogpt.py:18-27).
    ``trans_config`` and ``n_embd`` are derived in ``__post_init__`` and stay
    overridable, as tests shrink the transformer after construction.
    ``scan_layers`` and ``pp_stages`` are kept as the JAX config's compile
    levers and change nothing here: the port runs the unrolled stack, and
    ``vit_tpu_torch.bridge`` unrolls a scanned or pipelined tree."""

    frame_size: int          # tokens per frame
    codebook_size: int
    transformer: str
    max_frames: int
    dropout: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    scan_layers: bool = False
    pp_stages: int = 0
    quant: Optional[str] = None    # "int8": serving-only int8 dense sites

    def __post_init__(self):
        self.max_tokens = self.max_frames * self.frame_size
        self.trans_config: TransformerConfig = transformer_configs[
            self.transformer](block_size=self.max_tokens, dropout=self.dropout,
                              causal=True, dtype=self.dtype,
                              param_dtype=self.param_dtype, quant=self.quant)
        self.n_embd = self.trans_config.n_embd


class VideoGPT(nn.Module):
    """Decoder-only AR model (reference train_videogpt.py:38-69)."""

    def __init__(self, config: VideoGPTConfig, device=None):
        super().__init__()
        self.config = config
        tc = config.trans_config
        # +1 row: SOS is index codebook_size (train_videogpt.py:48)
        self.tok_embed = nn.Parameter(torch.empty(
            config.codebook_size + 1, config.n_embd, dtype=tc.param_dtype,
            device=device))
        self.pos_embed = nn.Parameter(torch.empty(
            config.max_tokens, config.n_embd, dtype=tc.param_dtype,
            device=device))
        self.transformer = Transformer(tc, device=device)
        self.proj = nn.Linear(config.n_embd, config.codebook_size,
                              dtype=tc.param_dtype, device=device)

    def _embed(self, tokens: torch.Tensor, pos: int) -> torch.Tensor:
        """Token + position embeddings of positions [pos, pos + L), summed in
        fp32 and cast to the compute dtype."""
        length = tokens.shape[1]
        emb = (F.embedding(tokens.long(), self.tok_embed)
               + self.pos_embed[pos:pos + length])
        return emb.to(self.config.trans_config.dtype)

    def forward(self, x: torch.Tensor,
                generator: "torch.Generator | None" = None):
        """x (B, T, N) int tokens → (logits (B, T·N, C) fp32, scalar CE);
        ``generator`` feeds the transformer's dropout while training."""
        b, t, n = x.shape
        y = x.reshape(b, t * n).long()
        sos = torch.full((b, 1), self.config.codebook_size, dtype=torch.long,
                         device=x.device)
        h = self.transformer(self._embed(torch.cat([sos, y[:, :-1]], -1), 0),
                             generator=generator)
        logits = linear(h, self.proj, torch.float32)
        return logits, cross_entropy(logits, y)

    def decode_step(self, token: torch.Tensor, pos: int, cache: list):
        """One KV-cache decode step. token (B, 1) (SOS or a code) at position
        ``pos`` → (next-token logits (B, C), the cache, updated in place)."""
        h = self.transformer(self._embed(token, pos), cache, pos)
        return linear(h, self.proj, torch.float32)[:, 0], cache

    def prefill(self, tokens: torch.Tensor, cache: list):
        """Prime the cache with the whole prefix in one causal forward over
        positions [0, L). tokens (B, L) → (the last position's next-token
        logits (B, C), the cache, updated in place)."""
        h = self.transformer(self._embed(tokens, 0), cache, 0)
        return linear(h[:, -1], self.proj, torch.float32), cache


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of ``targets`` under ``log_softmax``."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets[..., None].long()).mean()


def init_cache(model: VideoGPT, batch_size: int) -> list:
    """A zero KV cache for ``batch_size`` sequences on the model's device."""
    return init_kv_cache(model.config.trans_config, batch_size,
                         device=model.tok_embed.device)


def _select_token(logits: torch.Tensor, *, temperature: float, top_k,
                  generator) -> torch.Tensor:
    """logits (B, C) → next token (B,) int32. Temperature 0: greedy argmax
    (the lowest index among equal maxima). Otherwise softmax sampling at
    ``temperature`` from ``generator``, optionally over the ``top_k`` most
    likely codes only."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / temperature
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


@torch.inference_mode()
def generate(model: VideoGPT, tokens: torch.Tensor, n: int, *,
             temperature: float = 0.0, top_k: "int | None" = None,
             generator: "torch.Generator | None" = None) -> torch.Tensor:
    """AR generation with the KV cache. tokens (B, L) conditioning codes →
    (B, L + n) int32 codes on the model's device. Greedy by default;
    ``temperature > 0`` samples from ``generator`` (on the model's device),
    so a generator seeded alike reproduces a rollout."""
    cfg = model.config
    device = model.tok_embed.device
    tokens = torch.as_tensor(tokens).to(device=device, dtype=torch.int32)
    b, cond_len = tokens.shape
    total = cond_len + n
    if total > cfg.max_tokens:
        raise ValueError(f"cond + gen = {total} tokens exceeds the model's "
                         f"max_tokens {cfg.max_tokens}")
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature > 0 requires generator")
    select = dict(temperature=temperature, top_k=top_k, generator=generator)
    cache = init_cache(model, b)
    buf = torch.cat([torch.full((b, 1), cfg.codebook_size, dtype=torch.int32,
                                device=device),
                     tokens,
                     torch.zeros((b, n), dtype=torch.int32, device=device)],
                    dim=-1)                                   # (B, 1 + total)
    # one causal forward over [SOS, cond) primes the cache and yields the
    # first generated code
    logits, cache = model.prefill(buf[:, :cond_len + 1], cache)
    buf[:, cond_len + 1] = _select_token(logits, **select)
    for pos in range(cond_len + 1, total):
        logits, cache = model.decode_step(buf[:, pos:pos + 1], pos, cache)
        buf[:, pos + 1] = _select_token(logits, **select)
    return buf[:, 1:]


def generate_frames(model: VideoGPT, video_tokens: torch.Tensor,
                    n: int) -> torch.Tensor:
    """(B, T, N) conditioning frames → (B, (T + n)·N) codes
    (reference train_videogpt.py:66-69)."""
    b, t, k = video_tokens.shape
    return generate(model, video_tokens.reshape(b, t * k),
                    n * model.config.frame_size)
