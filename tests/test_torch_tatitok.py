"""Port parity for the Bytedance stack on the CPU: the affine-LayerNorm /
``out_proj`` transformer block, remat under each policy, ``UViTBlock``,
``BytedanceVectorQuantizer``, TATiTok (encode, decode, ``decode_tokens``,
with and without text guidance, and their gradients), the Bytedance
checkpoint conversion, ``wd_exclude_mask`` and k = 2 gradient accumulation
against ``optax.MultiSteps``.

Tiny sizes: the Bytedance "small" preset is set to 2 layers × 2 heads ×
128 (head_dim 64) in both packages; image 32, patch 8, 8 latent tokens, a
64 × 12 codebook. Inputs come from numpy seeds, JAX weights are carried over
by ``vit_tpu_torch.bridge``, and the JAX side runs its attention as its own
tests do (``attn_impl="xla"``). fp32 throughout; tolerance 1e-3 relative
(``REL``) unless a line says otherwise."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_tpu.core.config as jax_config
import vit_tpu_torch.core.config as torch_config
from vit_tpu_torch.bridge import (_flax_key, _from_flax, _to_torch,
                                  _torch_key, flatten,
                                  tatitok_state_dict_from_flax, unflatten,
                                  uvit_state_dict_from_flax)

REL = 1e-3
# the tiny Bytedance preset: head_dim 64, so the packed kernels' path runs
SMALL = dict(width=128, layers=2, heads=2)
TATITOK = dict(image_size=32, patch_size=8, latent_tokens=8,
               codebook_size=64, latent_dim=12, transformer="small")
TEXT = dict(text_context_length=5, text_embed_dim=16)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tiny model's small ops run several times
    slower across threads on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def tiny_small():
    """The Bytedance "small" preset at ``SMALL`` in both packages."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_config, torch_config):
            mp.setitem(mod.BYTEDANCE_WIDTH, "small", SMALL["width"])
            mp.setitem(mod.BYTEDANCE_LAYERS, "small", SMALL["layers"])
            mp.setitem(mod.BYTEDANCE_HEADS, "small", SMALL["heads"])
        yield


def rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def close(got, want, rel=REL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert err <= rel * scale, f"{what}: max err {err:.3g} > {rel} × {scale:.3g}"


def shaken(params: dict, seed: int) -> dict:
    """``params`` with every LayerNorm scale and bias drawn around 1 and 0,
    so that a dropped affine term shows."""
    g = rng(seed)
    flat = flatten(jax.tree.map(np.asarray, params))
    for k, v in flat.items():
        if k.endswith("/scale") or ("ln" in k or "norm" in k) and \
                k.endswith("/bias"):
            base = 1.0 if k.endswith("/scale") else 0.0
            flat[k] = (base + 0.2 * g.normal(size=v.shape)).astype(np.float32)
    return unflatten(flat)


def grads_close(port_grads: dict, jax_grads: dict, what: str):
    flat = flatten(jax.tree.map(np.asarray, jax_grads))
    for k, g in flat.items():
        key, is_kernel = _torch_key(k)
        close(port_grads[key], _to_torch(g) if is_kernel else g,
              what=f"{what} d{k}")


def _vjp(fn):
    """(params, x, cotangent) → (fn(params, x), its VJP), to jit whole."""
    def run(p, x, ct):
        out, vjp = jax.vjp(fn, p, x)
        return out, vjp(ct)
    return run


# -- the transformer block ----------------------------------------------------

def _block_configs(out_proj: bool, **kw):
    from vit_tpu.core.config import TransformerConfig as JC
    from vit_tpu_torch.core.config import TransformerConfig as PC

    common = dict(n_layers=2, n_heads=2, n_embd=128, block_size=24,
                  ln_affine=True, attn_out_proj=out_proj)
    return (JC(**common, dtype=jnp.float32, attn_impl="xla"),
            PC(**common, dtype=torch.float32, **kw))


def _port_stack(cfg, params):
    from vit_tpu_torch.core.transformer import Transformer

    model = Transformer(cfg, device="meta")
    model.load_state_dict(_from_flax(params, model.state_dict()), assign=True)
    return model


@pytest.mark.parametrize("out_proj", [False, True],
                         ids=["no_out_proj", "out_proj"])
def test_affine_block_matches_jax(out_proj):
    """Two Bytedance blocks (affine ``ln1``/``ln2`` with scales and biases
    drawn around 1 and 0, with and without ``attn/out_proj``): the output,
    the input's gradient and every parameter's against ``jax.vjp``."""
    from vit_tpu.core.transformer import Transformer as JaxTransformer

    cfg_j, cfg_t = _block_configs(out_proj)
    x = rng(0).normal(size=(2, 24, 128)).astype(np.float32)
    ct = rng(1).normal(size=(2, 24, 128)).astype(np.float32)
    model_j = JaxTransformer(cfg_j)
    params = shaken(jax.jit(model_j.init)(jax.random.PRNGKey(0),
                                          jnp.asarray(x))["params"], 2)
    if out_proj:
        assert "out_proj" in params["layer_0"]["attn"]
    assert set(params["layer_0"]["ln1"]) == {"scale", "bias"}
    out_j, (dp_j, dx_j) = jax.jit(_vjp(lambda p, h: model_j.apply(
        {"params": p}, h)))(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                            jnp.asarray(ct))
    model = _port_stack(cfg_t, params).requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = model(xt)
    close(out, out_j, what="out")
    out.backward(torch.from_numpy(ct))
    close(xt.grad, dx_j, what="dx")
    grads_close({k: p.grad for k, p in model.named_parameters()}, dp_j,
                "block")


def _stack_grads(model, x, ct, seed=None):
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    xt = torch.from_numpy(x).requires_grad_(True)
    model.zero_grad()
    out = model(xt, generator=gen)
    out.backward(torch.from_numpy(ct))
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    return out.detach(), xt.grad, grads, gen


@pytest.mark.parametrize("policy", ["none", "everything", "dots",
                                    "dots_no_batch"])
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["no_dropout", "dropout"])
def test_remat_equals_no_remat(policy, rate):
    """The stack under ``remat`` with each policy: output and gradients
    equal the stack's without remat (the same weights); at dropout 0.1 from
    the same generator state the recompute replays the first forward's
    masks, so they still agree, and the generator ends where the plain
    stack's does."""
    from vit_tpu_torch.core.transformer import Transformer
    from vit_tpu_torch.utils.init import init_params_

    _, cfg_t = _block_configs(True, dropout=rate)
    plain = Transformer(cfg_t)
    init_params_(plain, torch.Generator().manual_seed(0))
    remat = Transformer(cfg_t.replace(remat=True, remat_policy=policy))
    remat.load_state_dict(plain.state_dict())
    plain.train(), remat.train()
    x = rng(3).normal(size=(2, 24, 128)).astype(np.float32)
    ct = rng(4).normal(size=(2, 24, 128)).astype(np.float32)
    seed = 5 if rate else None
    out_p, dx_p, g_p, gen_p = _stack_grads(plain, x, ct, seed)
    out_r, dx_r, g_r, gen_r = _stack_grads(remat, x, ct, seed)
    np.testing.assert_allclose(out_r.numpy(), out_p.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(dx_r.numpy(), dx_p.numpy(), rtol=1e-5,
                               atol=1e-6)
    for k in g_p:
        np.testing.assert_allclose(g_r[k].numpy(), g_p[k].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    if rate:
        assert torch.equal(gen_r.get_state(), gen_p.get_state())
        # the masks are real: another seed gives another output
        out_o = _stack_grads(plain, x, ct, seed + 1)[0]
        assert not torch.allclose(out_o, out_p)


def test_remat_matches_jax_remat():
    """``remat`` with the "dots" policy against the JAX stack under
    ``nn.remat`` with ``checkpoint_dots``: output and gradients."""
    from vit_tpu.core.transformer import Transformer as JaxTransformer

    cfg_j, cfg_t = _block_configs(True)
    cfg_j = cfg_j.replace(remat=True, remat_policy="dots")
    cfg_t = cfg_t.replace(remat=True, remat_policy="dots")
    x = rng(6).normal(size=(2, 24, 128)).astype(np.float32)
    model_j = JaxTransformer(cfg_j)
    params = shaken(jax.jit(model_j.init)(jax.random.PRNGKey(1),
                                          jnp.asarray(x))["params"], 7)
    loss_j = lambda p: jnp.sum(model_j.apply({"params": p},  # noqa: E731
                                             jnp.asarray(x)) ** 2)
    g_j = jax.jit(jax.grad(loss_j))(jax.tree.map(jnp.asarray, params))
    model = _port_stack(cfg_t, params).requires_grad_(True)
    (model(torch.from_numpy(x)) ** 2).sum().backward()
    grads_close({k: p.grad for k, p in model.named_parameters()}, g_j,
                "remat")


def test_remat_policy_names(monkeypatch):
    """None reads ``$VIT_TPU_REMAT_POLICY``; "none" and "everything" keep
    nothing; an unknown name raises ``ValueError``, as JAX's
    ``_remat_policy`` does."""
    from vit_tpu.core.transformer import _remat_policy
    from vit_tpu_torch.core.transformer import (DOTS, DOTS_NO_BATCH,
                                                remat_policy)

    monkeypatch.delenv("VIT_TPU_REMAT_POLICY", raising=False)
    assert remat_policy(None) is None and remat_policy("none") is None
    assert remat_policy("everything") is None
    assert remat_policy("dots") == DOTS
    assert remat_policy("dots_no_batch") == DOTS_NO_BATCH
    monkeypatch.setenv("VIT_TPU_REMAT_POLICY", "dots")
    assert remat_policy(None) == DOTS
    assert _remat_policy(None) is not None
    for impl in (remat_policy, _remat_policy):
        with pytest.raises(ValueError, match="unknown remat_policy"):
            impl("most")


def test_remat_off_while_decoding():
    """A KV-cache decode under ``remat`` runs the blocks directly (no
    checkpoint: the cache is written in place) and equals the plain
    stack's decode."""
    from vit_tpu_torch.core.transformer import Transformer, init_kv_cache
    from vit_tpu_torch.utils.init import init_params_

    _, cfg_t = _block_configs(True)
    cfg_t = cfg_t.replace(causal=True)
    plain = Transformer(cfg_t).eval()
    init_params_(plain, torch.Generator().manual_seed(1))
    remat = Transformer(cfg_t.replace(remat=True)).eval()
    remat.load_state_dict(plain.state_dict())
    x = torch.from_numpy(rng(8).normal(size=(1, 24, 128)).astype(np.float32))
    outs = []
    for model in (plain, remat):
        cache = init_kv_cache(model.config, 1)
        with torch.no_grad():
            outs.append((model(x[:, :4], cache, 0), model(x[:, 4:5], cache,
                                                          4)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# -- UViT ---------------------------------------------------------------------

@pytest.mark.parametrize("skip", [False, True], ids=["no_skip", "skip"])
def test_uvit_block_matches_jax(skip):
    """``UViTBlock`` (dim 128, 2 heads; with ``skip`` also the qkv bias
    and the skip merge) against the JAX block: output and gradients; the
    ``use_checkpoint`` block's gradients equal the plain one's."""
    from vit_tpu.core.uvit import UViTBlock as JaxUViT
    from vit_tpu_torch.core.uvit import UViTBlock

    x = rng(9).normal(size=(2, 24, 128)).astype(np.float32)
    sk = rng(10).normal(size=(2, 24, 128)).astype(np.float32)
    ct = rng(11).normal(size=(2, 24, 128)).astype(np.float32)
    kw = dict(dim=128, num_heads=2, qkv_bias=skip, skip=skip)
    block_j = JaxUViT(**kw)
    args = (jnp.asarray(x), jnp.asarray(sk) if skip else None)
    params = shaken(jax.jit(block_j.init)(jax.random.PRNGKey(2), *args)[
        "params"], 12)
    out_j, (dp_j, dx_j) = jax.jit(_vjp(lambda p, h: block_j.apply(
        {"params": p}, h, args[1])))(jax.tree.map(jnp.asarray, params),
                                     args[0], jnp.asarray(ct))
    grads = []
    for ckpt in (False, True):
        block = UViTBlock(**kw, use_checkpoint=ckpt)
        block.load_state_dict(uvit_state_dict_from_flax(params, block))
        xt = torch.from_numpy(x).requires_grad_(True)
        out = block(xt, torch.from_numpy(sk) if skip else None)
        close(out, out_j, what="out")
        out.backward(torch.from_numpy(ct))
        close(xt.grad, dx_j, what="dx")
        grads.append({k: p.grad for k, p in block.named_parameters()})
        grads_close(grads[-1], dp_j, "uvit")
    for k in grads[0]:
        np.testing.assert_allclose(grads[1][k].numpy(), grads[0][k].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    if skip:
        with pytest.raises(ValueError, match="skip tensor"):
            block(torch.from_numpy(x))


def test_uvit_drop_path_and_dropout_train_only():
    """Stochastic depth and dropout act only in training, and replay under
    ``use_checkpoint``: gradients equal the plain block's from one
    generator state."""
    from vit_tpu_torch.core.uvit import UViTBlock

    kw = dict(dim=128, num_heads=2, dropout=0.2, drop_path=0.5)
    plain, ckpt = UViTBlock(**kw), UViTBlock(**kw, use_checkpoint=True)
    ckpt.load_state_dict(plain.state_dict())
    x = torch.from_numpy(rng(13).normal(size=(4, 24, 128)).astype(np.float32))
    grads = []
    for block in (plain, ckpt):
        block.train()
        out = block(x, generator=torch.Generator().manual_seed(3))
        out.square().sum().backward()
        grads.append([p.grad for p in block.parameters()])
        block.eval()
        assert torch.equal(block(x), block(x))
    for a, b in zip(*grads):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-7)
    plain.train()
    assert not torch.equal(plain(x, generator=torch.Generator().manual_seed(3)),
                           plain.eval()(x))


# -- the Bytedance quantizer -------------------------------------------------

@pytest.mark.parametrize("l2,clustering", [(False, False), (True, False),
                                           (True, True), (False, True)],
                         ids=["plain", "l2", "l2_clustering", "clustering"])
def test_bytedance_vq_matches_jax(l2, clustering):
    """``BytedanceVectorQuantizer`` (64 × 12) in its training form against
    the JAX module: quantized output, losses, indices, the gradients of z
    and the codebook, ``get_codebook_entry``; under clustering the usage
    EMA (from a nonzero start) and ``new_embedding``."""
    from vit_tpu.quantize.bytedance_vq import BytedanceVectorQuantizer as JVQ
    from vit_tpu_torch.quantize.bytedance_vq import BytedanceVectorQuantizer

    z = rng(14).normal(size=(4, 8, 12)).astype(np.float32)
    ct = rng(15).normal(size=(4, 8, 12)).astype(np.float32)
    kw = dict(codebook_size=64, token_size=12, use_l2_norm=l2,
              clustering_vq=clustering)
    vq_j = JVQ(**kw)
    variables = vq_j.init(jax.random.PRNGKey(3), jnp.asarray(z))
    emb = np.asarray(variables["params"]["embedding"])
    prob = (rng(16).uniform(size=64) * 0.02).astype(np.float32)
    stats = {"vq_stats": {"embed_prob": jnp.asarray(prob)}} if clustering \
        else {}

    def f(e, zz):
        (q, res), new = vq_j.apply({"params": {"embedding": e}, **stats}, zz,
                                   True, mutable=["vq_stats"])
        return jnp.sum(q * ct) + res["quantizer_loss"], (q, res, new)

    (_, (q_j, res_j, new_j)), (de_j, dz_j) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(jnp.asarray(emb), jnp.asarray(z))
    vq = BytedanceVectorQuantizer(**kw)
    with torch.no_grad():
        vq.embedding.copy_(torch.from_numpy(emb))
        if clustering:
            vq.embed_prob.copy_(torch.from_numpy(prob))
    assert "embed_prob" not in vq.state_dict()
    zt = torch.from_numpy(z).requires_grad_(True)
    q, res = vq(zt, train=True)
    close(q, q_j, what="quantized")
    assert res["min_encoding_indices"].dtype == torch.int32
    np.testing.assert_array_equal(res["min_encoding_indices"].numpy(),
                                  np.asarray(res_j["min_encoding_indices"]))
    for k in ("quantizer_loss", "commitment_loss", "codebook_loss"):
        close(res[k], res_j[k], what=k)
    ((q * torch.from_numpy(ct)).sum() + res["quantizer_loss"]).backward()
    close(zt.grad, dz_j, what="dz")
    close(vq.embedding.grad, de_j, what="dembedding")
    assert ("new_embedding" in res) == clustering
    if clustering:
        close(res["new_embedding"], res_j["new_embedding"],
              what="new_embedding")
        close(vq.embed_prob, new_j["vq_stats"]["embed_prob"],
              what="embed_prob")
        # the forward leaves the codebook as it was
        assert torch.equal(vq.embedding.detach(), torch.from_numpy(emb))
    idx = np.asarray(res_j["min_encoding_indices"])
    close(vq.get_codebook_entry(torch.from_numpy(idx)),
          vq_j.apply({"params": {"embedding": jnp.asarray(emb)}},
                     jnp.asarray(idx), method="get_codebook_entry"),
          what="get_codebook_entry")


def test_clustering_reseed_ties_to_the_lowest_input():
    """Codes at the origin and two inputs of equal norm in different
    directions: every code's nearest input is a tie, and the reseed takes
    the first, as ``jnp.argmin`` does."""
    from vit_tpu_torch.quantize.bytedance_vq import BytedanceVectorQuantizer

    vq = BytedanceVectorQuantizer(8, 4, clustering_vq=True)
    with torch.no_grad():
        vq.embedding.zero_()
    z = torch.tensor([[1.0, 0.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0],
                      [2.0, 0.0, 0.0, 0.0]])
    res = vq(z, train=True)[1]
    decay_f = torch.exp(-(vq.embed_prob * 8 * 10.0) / (1 - 0.99) - 1e-3)
    want = torch.zeros(8, 4)
    want[:, 0] = decay_f
    torch.testing.assert_close(res["new_embedding"], want)


# -- TATiTok ------------------------------------------------------------------

def _tatitok(text: bool, dtype="float32"):
    from vit_tpu.models.tatitok import TATiTok as JT
    from vit_tpu.models.tatitok import TATiTokConfig as JC
    from vit_tpu_torch.models.tatitok import TATiTok, TATiTokConfig

    extra = dict(text_guidance=True, **TEXT) if text else {}
    cfg_j = JC(**TATITOK, **extra, dtype=getattr(jnp, dtype),
               attn_impl="xla")
    cfg_t = TATiTokConfig(**TATITOK, **extra, dtype=getattr(torch, dtype))
    x = rng(17).uniform(size=(2, 32, 32, 3)).astype(np.float32)
    tg = (rng(18).normal(size=(2, TEXT["text_context_length"],
                                TEXT["text_embed_dim"])).astype(np.float32)
          if text else None)
    model_j = JT(cfg_j)
    params = jax.jit(model_j.init)(jax.random.PRNGKey(4), jnp.asarray(x),
                                   None if tg is None else jnp.asarray(tg))[
        "params"]
    params = shaken(params, 19)
    model = TATiTok(cfg_t, device="meta")
    model.load_state_dict(tatitok_state_dict_from_flax(params, cfg_t),
                          assign=True)
    return model_j, params, model, x, tg


@pytest.mark.parametrize("text", [False, True], ids=["no_text", "text"])
def test_tatitok_matches_jax(text):
    """TATiTok (with and without text guidance) against the JAX model:
    ``encode``'s quantized latents, codes and losses, ``decode``,
    ``decode_tokens``, and the gradients of every parameter of the
    training forward's recon MSE + quantizer loss."""
    with tiny_small():
        model_j, params, model, x, tg = _tatitok(text)
        pj = jax.tree.map(jnp.asarray, params)
        xj = jnp.asarray(x)
        tgj = None if tg is None else jnp.asarray(tg)
        tgt = None if tg is None else torch.from_numpy(tg)
        zq_j, res_j = model_j.apply({"params": pj}, xj, method="encode")
        with torch.no_grad():
            zq, res = model.encode(torch.from_numpy(x))
        close(zq, zq_j, what="zq")
        np.testing.assert_array_equal(res["min_encoding_indices"].numpy(),
                                      np.asarray(res_j["min_encoding_indices"]))
        close(res["quantizer_loss"], res_j["quantizer_loss"], what="qloss")
        with torch.no_grad():
            dec = model.decode(zq, tgt)
            tok = model.decode_tokens(res["min_encoding_indices"], tgt)
        close(dec, model_j.apply({"params": pj}, zq_j, tgj, method="decode"),
              what="decode")
        close(tok, model_j.apply({"params": pj}, res_j["min_encoding_indices"],
                                 tgj, method="decode_tokens"),
              what="decode_tokens")
        assert dec.shape == (2, 32, 32, 3) and dec.dtype == torch.float32

        def loss_j(p):
            recon, r = model_j.apply({"params": p}, xj, tgj, True)
            return jnp.mean((recon - xj) ** 2) + r["quantizer_loss"]

        g_j = jax.jit(jax.grad(loss_j))(pj)
        model.requires_grad_(True)
        recon, r = model(torch.from_numpy(x), tgt, train=True)
        (torch.mean((recon - torch.from_numpy(x)) ** 2)
         + r["quantizer_loss"]).backward()
        grads_close({k: p.grad for k, p in model.named_parameters()}, g_j,
                    "tatitok")


def test_text_guidance_is_required_and_used():
    with tiny_small():
        _, _, model, x, tg = _tatitok(True)
        with torch.no_grad():
            zq, _ = model.encode(torch.from_numpy(x))
            a = model.decode(zq, torch.from_numpy(tg))
            b = model.decode(zq, torch.from_numpy(tg) + 1.0)
            assert not torch.allclose(a, b)
            with pytest.raises(ValueError, match="text_guidance"):
                model.decode(zq)


def test_bytedance_conversion_matches_jax(tmp_path):
    """A Bytedance folder (``config.yaml`` + ``checkpoint-0/
    unwrapped_model/pytorch_model.bin``) written from the port's weights:
    ``convert_bytedance_state_dict`` gives back those weights exactly and
    the JAX converter's tree, through the bridge, the same; the port's
    loader and JAX's ``get_titok_tokenizer`` encode to the same codes."""
    from vit_tpu.models.pretrained import FrozenTokenizer as JaxFrozen
    from vit_tpu.models.pretrained import (convert_bytedance_state_dict as
                                           jax_convert)
    from vit_tpu.models.pretrained import get_titok_tokenizer
    from vit_tpu_torch.models.pretrained import (
        bytedance_state_dict, config_from_bytedance_yaml,
        convert_bytedance_state_dict, load_bytedance, write_bytedance_folder)

    with tiny_small():
        _, _, model, x, _ = _tatitok(False)
        folder = write_bytedance_folder(model, tmp_path / "oned")
        cfg = config_from_bytedance_yaml(folder)
        assert (cfg.image_size, cfg.patch_size, cfg.latent_tokens,
                cfg.codebook_size, cfg.latent_dim, cfg.transformer,
                cfg.use_l2_norm, cfg.text_guidance, cfg.dtype) == (
            32, 8, 8, 64, 12, "small", True, False, torch.float32)
        sd = bytedance_state_dict(model)
        own = model.state_dict()
        conv = convert_bytedance_state_dict(sd, cfg)
        assert sorted(conv) == sorted(own)
        assert all(torch.equal(conv[k], own[k]) for k in own)
        from vit_tpu.models.tatitok import TATiTokConfig as JC
        jcfg = JC(**TATITOK, dtype=jnp.float32)
        via_jax = tatitok_state_dict_from_flax(
            jax.tree.map(np.asarray, jax_convert(sd, jcfg)), cfg)
        assert all(torch.equal(via_jax[k], own[k]) for k in own)
        tok_j = JaxFrozen(*get_titok_tokenizer(str(folder)))
        loaded = load_bytedance(folder)
        with torch.no_grad():
            codes = loaded.encode(torch.from_numpy(x))[1][
                "min_encoding_indices"]
        np.testing.assert_array_equal(
            codes.numpy(), np.asarray(tok_j.encode_indices(jnp.asarray(x))))


# -- the optimizer -------------------------------------------------------------

def test_wd_exclude_mask_matches_jax():
    """The weight-decay decision for every TATiTok tensor (text guidance
    on, so every family is there) equals JAX's ``wd_exclude_mask`` on the
    leaf of the same path."""
    from vit_tpu.train.optim import wd_exclude_mask as jax_mask
    from vit_tpu_torch.train.optim import wd_exclude_mask

    with tiny_small():
        _, params, model, _, _ = _tatitok(True)
    want = flatten(jax.tree.map(np.asarray, jax_mask(
        jax.tree.map(jnp.asarray, params))))
    named = list(model.named_parameters())
    got = dict(zip((_flax_key(n, p.ndim)[0] for n, p in named),
                   wd_exclude_mask(named)))
    assert got == {k: bool(v) for k, v in want.items()}
    decayed = sorted(k for k, v in got.items() if v)
    assert "decoder/conv_out/kernel" in decayed
    assert "encoder/transformer/layer_0/attn/out_proj/kernel" in decayed
    assert not any("embed" in k or "ln" in k for k in decayed)


def test_multisteps_matches_optax():
    """k = 2 accumulation around the clip and the masked AdamW (bf16 first
    moment) against ``optax.MultiSteps`` over ``make_optimizer``: the
    parameters after each of four micro-steps (two updates; the second
    mean's norm above the clip), the count and the micro-step; the
    parameters stay put on the first micro-step of each pair; the state
    round-trips through ``state_dict``."""
    import optax

    from vit_tpu.train.optim import make_optimizer as jax_make
    from vit_tpu.train.optim import wd_exclude_mask as jax_mask
    from vit_tpu_torch.train.optim import (MultiSteps, make_optimizer,
                                           wd_exclude_mask)

    with tiny_small():
        _, params, model, _, _ = _tatitok(False)
    names = [n for n, _ in model.named_parameters()]
    flax_keys = [_flax_key(n, p.ndim)[0] for n, p in model.named_parameters()]
    opt = dict(lr=1e-2, warmup_steps=1, train_steps=100, min_lr=1e-3,
               weight_decay=0.5)
    pj = jax.tree.map(jnp.asarray, params)
    tx_j = optax.MultiSteps(jax_make(**opt, weight_decay_mask=jax_mask(pj)),
                            every_k_schedule=2)
    st_j = tx_j.init(pj)
    update_j = jax.jit(tx_j.update)
    mask = wd_exclude_mask(list(model.named_parameters()))
    tx = MultiSteps(make_optimizer(**opt, weight_decay_mask=mask), 2)
    ps = [p.detach().clone() for p in model.parameters()]
    st = tx.init(ps)
    for i in range(4):
        g = rng(30 + i)
        scale = 0.001 if i < 2 else 0.1   # the second mean is clipped
        flat = {k: (scale * g.normal(size=np.shape(v))).astype(np.float32)
                for k, v in flatten(jax.tree.map(np.asarray, params)).items()}
        upd, st_j = update_j(jax.tree.map(jnp.asarray, unflatten(flat)), st_j,
                             pj)
        pj = optax.apply_updates(pj, upd)
        before = [p.clone() for p in ps]
        grads = []
        for k in flax_keys:
            key, is_kernel = _torch_key(k)
            grads.append(torch.from_numpy(np.ascontiguousarray(
                _to_torch(flat[k]) if is_kernel else flat[k])))
        tx.update_(ps, grads, st)
        assert st.mini_step == int(st_j.mini_step) == (i + 1) % 2
        assert int(st.inner.count) == int(st_j.gradient_step) == (i + 1) // 2
        if i % 2 == 0:
            assert all(torch.equal(a, b) for a, b in zip(ps, before))
        got = dict(zip(names, ps))
        for k, v in flatten(jax.tree.map(np.asarray, pj)).items():
            key, is_kernel = _torch_key(k)
            close(got[key], _to_torch(v) if is_kernel else v, rel=1e-5,
                  what=f"step {i} {k}")
    assert float(st.grad_norm) > 1.0
    sd = st.state_dict(names)
    fresh = tx.init([torch.zeros_like(p) for p in ps])
    fresh.load_state_dict(sd, names)
    assert fresh.mini_step == st.mini_step
    assert all(torch.equal(a, b) for a, b in zip(fresh.inner.mu, st.inner.mu))
