"""Shared pre-LN transformer core (counterpart of
``vit_tpu/core/transformer.py:105-437``).

Blocks of [LayerNorm → fused-QKV attention] and [LayerNorm → 4× GELU MLP],
with residual adds around both, in the compute dtype. Parameters stay fp32
and every matmul casts its operands to ``cfg.dtype`` explicitly. The QKV
projection is applied without its bias, which the attention kernel adds as it
reads each tile (``kernels/attention.py``).

Ported: the unrolled stack, forward and backward, and KV-cache decoding,
in both block layouts: the author's minimal block (non-affine LayerNorms, no
attention output projection) and the Bytedance one (``ln_affine``: the
LayerNorms scale and shift in fp32 by their ``weight`` and ``bias``, the
JAX tree's ``scale`` and ``bias``; ``attn_out_proj``: a dense ``out_proj``
after attention, in the compute dtype). Autograd carries gradients through
the explicit casts back to the fp32 parameters; attention's backward is the
K2 or K7/K8 kernel and GELU's the flat derivative (``ops/gelu.py``).

Remat (``cfg.remat``, ``vit_tpu/core/transformer.py:456-473, 562-565``)
runs each block under ``torch.utils.checkpoint`` (non-reentrant), except
while decoding with a KV cache. ``remat_policy`` (None → ``$VIT_TPU_REMAT_POLICY``
→ "everything") picks what the backward keeps: "none"/"everything" nothing
(the whole block runs again), "dots" the outputs of every matrix product,
"dots_no_batch" those of the products without a batch dimension (through
``create_selective_checkpoint_contexts``); any other name raises
``ValueError``. The recompute replays the dropout draws of the first
forward: the block draws from a generator set to the state the caller's had
before it, and the caller's generator then moves on to where the first
forward left it.

KV-cache decoding (``vit_tpu/core/transformer.py:173-238``) takes an explicit
cache instead of flax's ``cache`` collection: one ``(k, v)`` pair per layer,
each (B, H, block_size, d) in the compute dtype (``init_kv_cache``), passed
to ``Transformer.forward`` with a position and written in place (the JAX
module returns a new collection each step; writing in place saves a copy of
the whole cache per token). A multi-token call at position 0 is the prefill:
it writes positions [0, S) and runs causal ``multi_head_attention`` (K6). A
one-token call at ``pos`` writes that position and attends over the whole
cache with the ``≤ pos`` mask in plain torch, as the JAX module does outside
any Pallas kernel.

The fused kernel paths follow ``vit_tpu/core/transformer.py:34-83``, with
the same switches and the same precedence: ``$VIT_TPU_FUSED_LN`` (0, 1,
qkv or mlp), then ``TransformerConfig.fused_ln``, then off, hands the raw
stream to the qkv and/or fc1 product with its LayerNorm fused in (K9a, with
K9b and K9c in the backward; ``kernels/ln_matmul.py``), and
``$VIT_TPU_FUSED_FC`` (0 or 1), then ``fused_fc_grad``, then off, computes the
MLP products' weight and bias gradients in one pass (K10,
``kernels/fc_grad.py``). Widths the kernels' gates refuse turn both off,
and fused LN is off while decoding with a KV cache. The switches are read
each time a block runs. The GELU inside K9a and its backward K9b is always
the tanh-composed erf and its flat derivative, whatever ``gelu_impl`` says,
as in the JAX package.

Dropout (``cfg.dropout``) runs while the module is training
(``module.train()``, JAX's ``deterministic=False``) and never while decoding
with a KV cache, from an explicit ``torch.Generator`` handed to
``Transformer.forward``: each block's attention draws one int32 seed from it
per call for the kernels' counter hash (as each JAX ``Attention`` draws from
its dropout key, ``vit_tpu/core/transformer.py:180-182``), then its MLP
drops fc2's output (``nn.Dropout``, :320) with a mask drawn from it, in the
compute dtype, kept values divided by 1 − rate. Training with dropout and
no generator raises.

Not yet: the scanned and pipelined stacks, and int8.
"""

from __future__ import annotations

import functools
import os
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from vit_tpu_torch.core.config import TransformerConfig
from vit_tpu_torch.kernels import fc_grad, ln_matmul
from vit_tpu_torch.ops.attention import (fused_qkv_attention, merge_heads,
                                         multi_head_attention, split_heads)
from vit_tpu_torch.ops.gelu import gelu as gelu_op


aten = torch.ops.aten
# the products whose outputs "dots" keeps (JAX's checkpoint_dots), and those
# without a batch dimension ("dots_no_batch": F.linear's mm and addmm)
DOTS_NO_BATCH = (aten.mm.default, aten.addmm.default)
DOTS = DOTS_NO_BATCH + (aten.bmm.default, aten.baddbmm.default)


def remat_policy(name: Optional[str]) -> "tuple | None":
    """``cfg.remat_policy`` → the ops whose outputs the recompute keeps
    (None: none, the whole block runs again). None reads
    ``$VIT_TPU_REMAT_POLICY``."""
    if name is None:
        name = os.environ.get("VIT_TPU_REMAT_POLICY", "")
    if name in ("", "none", "everything"):
        return None
    if name == "dots":
        return DOTS
    if name == "dots_no_batch":
        return DOTS_NO_BATCH
    raise ValueError(f"unknown remat_policy {name!r} "
                     "(expected none|dots|dots_no_batch)")


def checkpointed(fn: Callable, x: torch.Tensor,
                 generator: "torch.Generator | None" = None,
                 saved: "tuple | None" = None) -> torch.Tensor:
    """``fn(x, generator)`` with its activations dropped after the forward
    and recomputed in the backward, keeping the outputs of the ops in
    ``saved`` (``remat_policy``). ``fn`` draws from a copy of
    ``generator`` both times, so the recompute sees the first forward's
    masks; ``generator`` ends where that forward left its copy."""
    context_fn = ckpt.noop_context_fn
    if saved is not None:
        def policy(ctx, op, *args, **kwargs):
            return (ckpt.CheckpointPolicy.MUST_SAVE if op in saved
                    else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)

        context_fn = functools.partial(
            ckpt.create_selective_checkpoint_contexts, policy)
    run, after = fn, []
    if generator is not None:
        start = generator.get_state()

        def run(x, _):
            g = torch.Generator(device=generator.device)
            g.set_state(start)
            out = fn(x, g)
            after.append(g.get_state())
            return out
    out = ckpt.checkpoint(run, x, None, use_reentrant=False,
                          preserve_rng_state=False, context_fn=context_fn)
    if after:
        generator.set_state(after[0])
    return out


def use_fused_fc(cfg: TransformerConfig) -> bool:
    """Gate for K10 on the MLP's products (``_use_fused_fc``, :34-55):
    off for widths the kernel's gate refuses, then ``$VIT_TPU_FUSED_FC``,
    then ``cfg.fused_fc_grad``, then off."""
    if not fc_grad.fused_dense_supported(cfg.n_embd, 4 * cfg.n_embd):
        return False
    env = os.environ.get("VIT_TPU_FUSED_FC")
    if env is not None:
        return env != "0"
    if cfg.fused_fc_grad is not None:
        return cfg.fused_fc_grad
    return False


def use_fused_ln(cfg: TransformerConfig, decoding: bool
                 ) -> "tuple[bool, bool]":
    """(qkv, mlp) gates for K9a (``_use_fused_ln``, :58-83): off for the
    affine LayerNorm, while decoding with a KV cache and for widths the
    kernel's gate refuses; then ``$VIT_TPU_FUSED_LN`` (0, 1, qkv, mlp), then
    ``cfg.fused_ln``, then off."""
    if cfg.ln_affine or decoding:
        return False, False
    c = cfg.n_embd
    if not (ln_matmul.supported(c, 3 * c) and ln_matmul.supported(c, 4 * c)):
        return False, False
    env = os.environ.get("VIT_TPU_FUSED_LN")
    if env is not None:
        if env in ("qkv", "mlp"):
            return env == "qkv", env == "mlp"
        return (env != "0",) * 2
    if cfg.fused_ln is not None:
        return (cfg.fused_ln,) * 2
    return False, False


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype
           ) -> torch.Tensor:
    """``layer`` applied in ``dtype``: input, weight and bias cast first."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


class LayerNorm(nn.Module):
    """LayerNorm with fp32 statistics, eps 1e-5, output in the compute
    dtype; under ``ln_affine`` scaled and shifted in fp32 by ``weight``
    (ones) and ``bias`` (zeros)."""

    def __init__(self, config: TransformerConfig, device=None):
        super().__init__()
        self.config = config
        if config.ln_affine:
            kw = dict(dtype=config.param_dtype, device=device)
            self.weight = nn.Parameter(torch.ones(config.n_embd, **kw))
            self.bias = nn.Parameter(torch.zeros(config.n_embd, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = (x32 - mean).square().mean(-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + 1e-5)
        if self.config.ln_affine:
            y = y * self.weight.float() + self.bias.float()
        return y.to(self.config.dtype)


def init_kv_cache(config: TransformerConfig, batch_size: int,
                  device=None) -> "list[tuple[torch.Tensor, torch.Tensor]]":
    """A zero (k, v) pair per layer, each (B, H, block_size, d) in the
    compute dtype."""
    shape = (batch_size, config.n_heads, config.block_size,
             config.n_embd // config.n_heads)
    return [tuple(torch.zeros(shape, dtype=config.dtype, device=device)
                  for _ in range(2)) for _ in range(config.n_layers)]


def _decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            kv: "tuple[torch.Tensor, torch.Tensor]", pos: int) -> torch.Tensor:
    """q, k, v (B, H, S, d) at positions [pos, pos + S), written into the
    cache ``kv`` in place. S > 1 is the prefill, only correct from position 0
    (its queries see only the new block); S == 1 one decode step."""
    ck, cv = kv
    s_len, d = q.shape[-2], q.shape[-1]
    if s_len > 1:
        if not (isinstance(pos, int) and pos == 0):
            raise ValueError(
                "multi-token decode (prefill) requires static pos=0; "
                f"got pos={pos!r} for a {s_len}-token block")
        ck[:, :, :s_len] = k
        cv[:, :, :s_len] = v
        return multi_head_attention(q, k, v, causal=True)
    ck[:, :, pos] = k[:, :, 0]
    cv[:, :, pos] = v[:, :, 0]
    s = (q.float() @ ck.float().transpose(-1, -2)) * d ** -0.5
    future = torch.arange(ck.shape[2], device=ck.device) > pos
    s = s.masked_fill(future, torch.finfo(torch.float32).min)
    p = torch.softmax(s, dim=-1)
    return (p.to(cv.dtype).float() @ cv.float()).to(q.dtype)


class Attention(nn.Module):
    """Fused-QKV multi-head self-attention: x·W in the compute dtype, the
    bias handed to the attention kernel, or added here when decoding. With
    ``fused_ln`` x is the raw stream and ln1 runs inside the product (K9a).
    Under ``attn_out_proj`` a dense ``out_proj`` follows, in the compute
    dtype."""

    def __init__(self, config: TransformerConfig, device=None):
        super().__init__()
        self.config = config
        self.qkv = nn.Linear(config.n_embd, 3 * config.n_embd,
                             dtype=config.param_dtype, device=device)
        if config.attn_out_proj:
            self.out_proj = nn.Linear(config.n_embd, config.n_embd,
                                      dtype=config.param_dtype, device=device)

    def forward(self, x: torch.Tensor, kv=None, pos=None,
                fused_ln: bool = False, dropout_rate: float = 0.0,
                generator: "torch.Generator | None" = None) -> torch.Tensor:
        out = self._attend(x, kv, pos, fused_ln, dropout_rate, generator)
        if self.config.attn_out_proj:
            return linear(out, self.out_proj, self.config.dtype)
        return out

    def _attend(self, x, kv, pos, fused_ln, dropout_rate, generator):
        cfg = self.config
        w = self.qkv.weight.to(cfg.dtype)
        if fused_ln:
            qkv_nb = ln_matmul.fused_ln_matmul(x.to(cfg.dtype), w)
        else:
            qkv_nb = F.linear(x.to(cfg.dtype), w)
        if kv is None:
            seed = None
            if dropout_rate > 0.0:   # one int32 per call, drawn on x's device
                seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                                     device=x.device, dtype=torch.int32)
            return fused_qkv_attention(qkv_nb, cfg.n_heads, causal=cfg.causal,
                                       dropout_rate=dropout_rate, seed=seed,
                                       qkv_bias=self.qkv.bias)
        q, k, v = split_heads(qkv_nb, cfg.n_heads, self.qkv.bias)
        return merge_heads(_decode(q, k, v, kv, pos))


class Mlp(nn.Module):
    """fc1 → GELU → fc2 → dropout, both matmuls in the compute dtype. With
    ``fused_ln`` x is the raw stream and ln2, fc1, its bias and the GELU run
    in K9a; with fused FC (``use_fused_fc``) fc2, and fc1 unless K9a takes
    it, get K10's weight and bias gradients."""

    def __init__(self, config: TransformerConfig, device=None):
        super().__init__()
        self.config = config
        self.fc1 = nn.Linear(config.n_embd, 4 * config.n_embd,
                             dtype=config.param_dtype, device=device)
        self.fc2 = nn.Linear(4 * config.n_embd, config.n_embd,
                             dtype=config.param_dtype, device=device)

    def forward(self, x: torch.Tensor, fused_ln: bool = False,
                dropout_rate: float = 0.0,
                generator: "torch.Generator | None" = None) -> torch.Tensor:
        out = self._mlp(x, fused_ln)
        if dropout_rate == 0.0:
            return out
        keep = torch.rand(out.shape, generator=generator,
                          device=out.device) < 1.0 - dropout_rate
        return torch.where(keep, out / (1.0 - dropout_rate), 0.0)

    def _mlp(self, x: torch.Tensor, fused_ln: bool) -> torch.Tensor:
        cfg = self.config
        dt = cfg.dtype
        fused_fc = use_fused_fc(cfg)
        if fused_ln:
            h = ln_matmul.fused_ln_matmul(x.to(dt), self.fc1.weight.to(dt),
                                          self.fc1.bias.to(dt), gelu=True)
        elif fused_fc:
            h = gelu_op(fc_grad.fused_dense(x.to(dt), self.fc1.weight.to(dt),
                                            self.fc1.bias.to(dt)),
                        cfg.gelu_impl)
        else:
            h = gelu_op(linear(x, self.fc1, dt), cfg.gelu_impl)
        if fused_fc:
            return fc_grad.fused_dense(h.to(dt), self.fc2.weight.to(dt),
                                       self.fc2.bias.to(dt))
        return linear(h, self.fc2, dt)


class TransformerLayer(nn.Module):
    """Pre-LN block: x + attn(ln1(x)), then + mlp(ln2(x)); a site whose
    LayerNorm is fused (``use_fused_ln``) gets the raw stream instead. While
    training without a KV cache, both draw their dropout from
    ``generator``."""

    def __init__(self, config: TransformerConfig, device=None):
        super().__init__()
        self.config = config
        self.ln1 = LayerNorm(config, device=device)
        self.attn = Attention(config, device=device)
        self.ln2 = LayerNorm(config, device=device)
        self.mlp = Mlp(config, device=device)

    def forward(self, x: torch.Tensor, kv=None, pos=None,
                generator: "torch.Generator | None" = None) -> torch.Tensor:
        rate = self.config.dropout if self.training and kv is None else 0.0
        if rate > 0.0 and generator is None:
            raise ValueError(
                f"training with dropout {rate} needs a torch.Generator "
                "(Transformer.forward's generator), or module.eval()")
        fused_qkv, fused_mlp = use_fused_ln(self.config, kv is not None)
        h = x if fused_qkv else self.ln1(x)
        x = x + self.attn(h, kv, pos, fused_ln=fused_qkv, dropout_rate=rate,
                          generator=generator)
        h = x if fused_mlp else self.ln2(x)
        return x + self.mlp(h, fused_ln=fused_mlp, dropout_rate=rate,
                            generator=generator)


class Transformer(nn.Module):
    """Unrolled stack of ``n_layers`` blocks; the input is cast to the compute
    dtype on entry. ``layers.{i}`` holds the JAX tree's ``layer_{i}``. With
    ``cache`` (``init_kv_cache``) and ``pos`` it decodes, updating the cache
    in place. ``generator`` feeds dropout while training. Under
    ``cfg.remat`` each block runs through ``checkpointed`` unless it
    decodes."""

    def __init__(self, config: TransformerConfig, device=None):
        super().__init__()
        self.config = config
        self.layers = nn.ModuleList(TransformerLayer(config, device=device)
                                    for _ in range(config.n_layers))

    def forward(self, x: torch.Tensor, cache: "list | None" = None,
                pos: "int | None" = None,
                generator: "torch.Generator | None" = None) -> torch.Tensor:
        cfg = self.config
        x = x.to(cfg.dtype)
        if cfg.remat and cache is None:
            saved = remat_policy(cfg.remat_policy)
            for layer in self.layers:
                x = checkpointed(lambda h, g, block=layer: block(h, None,
                                                                 None, g),
                                 x, generator, saved)
            return x
        for i, layer in enumerate(self.layers):
            x = layer(x, None if cache is None else cache[i], pos, generator)
        return x
