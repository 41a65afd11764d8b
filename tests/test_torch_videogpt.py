"""Port parity for the VideoGPT AR prior: the unpacked attention kernels' plain
versions (K6 forward, K7/K8 backward) against the Pallas kernels, a tiny
VideoGPT at S = 832 (the unpacked path) against the JAX model, greedy
generation, the frozen tokenizer, three steps of the VideoGPT train step,
export → load → HTTP /generate, the bridge and sampling. The Pallas kernels
run in interpret mode on the CPU, as the JAX package's own tests run them."""

import io
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (codes, configs, images, jax_params,
                                port_model, port_videogpt, tiny_preset,
                                videogpt_configs, videogpt_params)
from vit_tpu.kernels.attention import flash_attention as jax_flash_attention
from vit_tpu.models.videogpt import VideoGPT as JaxVideoGPT
from vit_tpu.models.videogpt import generate as jax_generate
from vit_tpu_torch.bridge import (flatten, flax_from_state_dict,
                                  videogpt_state_dict_from_flax)
from vit_tpu_torch.kernels import attention as k_attn
from vit_tpu_torch.models.videogpt import (VideoGPT, VideoGPTConfig,
                                           generate, generate_frames,
                                           init_cache)
from vit_tpu_torch.ops.attention import multi_head_attention

ATTN_TOL = 1e-5       # fp32 forward on both sides; only summation order differs
ATTN_GRAD_TOL = 1e-4  # the backward sums S more products per element
GOLDEN_TOL = 1e-3     # the BASELINE.md golden contract, fp32
UPDATE_REL = 1e-2     # a step's parameter change against JAX's, per tensor


def _qkv(s, seed, n=3):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(1, 2, s, 64)).astype(np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [40, 513, 800])
def test_unpacked_attention_matches_jax(s, causal):
    """K6's plain version against the Pallas ``_fa_kernel``: one q block
    (40), the prefill's 513 and a padded two-block 800."""
    q, k, v = _qkv(s, seed=s + causal)
    ref = np.asarray(jax_flash_attention(*map(jnp.asarray, (q, k, v)),
                                         causal=causal))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out = k_attn.flash_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATTN_TOL, rtol=0)
    # the statistics are the masked row max and row sum, and leave the
    # output as it is
    out_s, m, l = k_attn.attention_fwd(tq, tk, tv, causal, emit_stats=True)
    assert torch.equal(out_s, out)
    sc = (q[0].astype(np.float64) @ k[0].astype(np.float64).transpose(0, 2, 1)
          ) / 8.0
    if causal:
        sc = np.where(np.tril(np.ones((s, s), bool)), sc, -np.inf)
    m_ref = sc.max(-1)
    np.testing.assert_allclose(m[0].numpy(), m_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(l[0].numpy(),
                               np.exp(sc - m_ref[..., None]).sum(-1),
                               rtol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [513, 800])   # K7 (S ≤ 768) and K8 (S > 768)
def test_unpacked_attention_backward_matches_jax(s, causal):
    q, k, v, g = _qkv(s, seed=10 + s + causal, n=4)
    out_j, vjp = jax.vjp(
        lambda a, b, c: jax_flash_attention(a, b, c, causal=causal),
        *map(jnp.asarray, (q, k, v)))
    grads_j = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = k_attn.flash_attention(tq, tk, tv, causal=causal)
    assert type(out.grad_fn).__name__ == "UnpackedAttentionBackward"
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               atol=ATTN_TOL, rtol=0)
    for name, got, want in zip("qkv", grads, grads_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATTN_GRAD_TOL, rtol=0, err_msg=name)
    assert k_attn.unpacked_launches == k_attn.unpacked_bwd_launches == 0


def test_unpacked_wrappers_never_fall_back_off_the_cpu():
    """Only a CPU tensor runs a plain version; a meta tensor stands in for a
    device here, and head_dim ≠ 64 is refused on any device."""
    t = torch.empty(2, 2, 40, 64, device="meta")
    stats = torch.empty(2, 2, 40, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        k_attn.attention_fwd(t, t, t, True)
    with pytest.raises(ValueError, match="unsupported device"):
        k_attn.attention_bwd(t, t, t, t, stats, stats, True)
    narrow = torch.empty(2, 2, 40, 48, device="meta")
    with pytest.raises(NotImplementedError, match="K6"):
        k_attn.flash_attention(narrow, narrow, narrow)
    with pytest.raises(ValueError, match="one shape"):
        k_attn.flash_attention(t, t, torch.empty(2, 2, 41, 64, device="meta"))
    # no sequence length sends a device tensor to the plain attention
    long = torch.empty(1, 1, 8193, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        multi_head_attention(long, long, long, causal=True)
    assert k_attn.unpacked_launches == k_attn.unpacked_bwd_launches == 0


@pytest.fixture(scope="module")
def tiny_gpt():
    cfg_j, cfg_t = videogpt_configs("float32")
    return cfg_j, cfg_t, videogpt_params(cfg_j)


def test_videogpt_forward_and_grads_match_jax(tiny_gpt):
    """The tiny VideoGPT at S = 832 (K6 forward, K8 backward in JAX; their
    plain versions in the port): logits, loss and every gradient."""
    cfg_j, cfg_t, params = tiny_gpt
    x = codes((2, cfg_t.max_frames, cfg_t.frame_size), cfg_t.codebook_size)
    net_j = JaxVideoGPT(cfg_j)

    def loss_fn(p):
        logits, loss = net_j.apply({"params": p}, jnp.asarray(x))
        return loss, logits

    (loss_j, logits_j), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    assert not k_attn.packed_supported(2, 128, 832)   # the unpacked path
    model = port_videogpt(cfg_t, params).requires_grad_(True)
    logits, loss = model(torch.from_numpy(x))
    assert logits.shape == (2, 832, cfg_t.codebook_size)
    assert logits.dtype == loss.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_j),
                               atol=GOLDEN_TOL, rtol=0)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=GOLDEN_TOL)
    loss.backward()
    grads = flatten(flax_from_state_dict(
        {k: p.grad for k, p in model.named_parameters()}))
    want = flatten(jax.tree.map(np.asarray, grads_j))
    assert grads.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(grads[k], want[k], atol=GOLDEN_TOL, rtol=0,
                                   err_msg=k)


def test_greedy_generate_matches_jax(tiny_gpt):
    cfg_j, cfg_t, params = tiny_gpt
    cond = codes((2, 40), cfg_t.codebook_size, seed=3)
    want = np.asarray(jax_generate(JaxVideoGPT(cfg_j),
                                   jax.tree.map(jnp.asarray, params),
                                   jnp.asarray(cond), 12))
    got = generate(port_videogpt(cfg_t, params), torch.from_numpy(cond), 12)
    assert got.dtype == torch.int32 and got.shape == (2, 52)
    np.testing.assert_array_equal(got.numpy(), want)


def test_kv_cache_decode_matches_full_forward(tiny_gpt):
    """Prefill then single-token steps give the logits of the full causal
    forward at those positions."""
    _, cfg_t, params = tiny_gpt
    model = port_videogpt(cfg_t, params)
    x = codes((2, 1, 30), cfg_t.codebook_size, seed=4)
    with torch.no_grad():
        full, _ = model(torch.from_numpy(x))
        cache = init_cache(model, 2)
        sos = torch.full((2, 1), cfg_t.codebook_size, dtype=torch.int32)
        seq = torch.cat([sos, torch.from_numpy(x[:, 0])], 1)
        logits, cache = model.prefill(seq[:, :20], cache)
        np.testing.assert_allclose(logits.numpy(), full[:, 19].numpy(),
                                   atol=1e-4, rtol=0)
        for pos in range(20, 30):
            logits, cache = model.decode_step(seq[:, pos:pos + 1], pos, cache)
            np.testing.assert_allclose(logits.numpy(), full[:, pos].numpy(),
                                       atol=1e-4, rtol=0, err_msg=str(pos))
        # a multi-token block past position 0 would ignore the cached prefix
        with pytest.raises(ValueError, match="pos=0"):
            model.transformer(model._embed(seq[:, 3:6], 3), cache, 3)


def test_sampling(tiny_gpt):
    """temperature/top_k: reproducible under a generator seeded alike, codes
    in range, the prefix kept, top_k = 1 equal to greedy, and a generator
    required (it cannot match JAX's stream, so no JAX comparison)."""
    _, cfg_t, params = tiny_gpt
    model = port_videogpt(cfg_t, params)
    cond = torch.from_numpy(codes((2, 8), cfg_t.codebook_size, seed=5))
    greedy = generate(model, cond, 6)

    def sample(seed, **kw):
        return generate(model, cond, 6, temperature=kw.pop("t", 1.0),
                        generator=torch.Generator().manual_seed(seed), **kw)

    s1, s2 = sample(7), sample(7)
    assert torch.equal(s1, s2)
    assert s1.min() >= 0 and s1.max() < cfg_t.codebook_size
    assert torch.equal(s1[:, :8], cond)
    assert not all(torch.equal(sample(seed), greedy) for seed in range(3))
    assert torch.equal(sample(9, t=0.7, top_k=1), greedy)
    with pytest.raises(ValueError, match="requires generator"):
        generate(model, cond, 6, temperature=1.0)
    # one conditioning frame of 8 codes, one generated frame of 64
    frames = generate_frames(model, cond.reshape(2, 1, 8), 1)
    assert frames.shape == (2, 8 + cfg_t.frame_size)
    assert torch.equal(frames[:, :14], greedy)


def test_config_refuses_unported_stacks():
    with pytest.raises(NotImplementedError, match="scan_layers"):
        VideoGPTConfig(8, 16, "S", 4, scan_layers=True)
    with pytest.raises(NotImplementedError, match="pp_stages"):
        VideoGPTConfig(8, 16, "S", 4, pp_stages=2)


def test_bridge_round_trip(tiny_gpt):
    """The embeddings are raw 2-D leaves and keep their layout; Dense
    kernels transpose; the tree comes back exactly."""
    _, cfg_t, params = tiny_gpt
    sd = videogpt_state_dict_from_flax(params, cfg_t)
    assert set(sd) == set(VideoGPT(cfg_t, device="meta").state_dict())
    np.testing.assert_array_equal(sd["tok_embed"].numpy(), params["tok_embed"])
    np.testing.assert_array_equal(sd["pos_embed"].numpy(), params["pos_embed"])
    assert sd["tok_embed"].shape == (cfg_t.codebook_size + 1, 128)
    np.testing.assert_array_equal(sd["proj.weight"].numpy(),
                                  params["proj"]["kernel"].T)
    np.testing.assert_array_equal(
        sd["transformer.layers.1.attn.qkv.weight"].numpy(),
        params["transformer"]["layer_1"]["attn"]["qkv"]["kernel"].T)
    back = flatten(flax_from_state_dict(sd))
    ref = flatten(params)
    assert back.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k])


@pytest.fixture(scope="module")
def tokenizers():
    with tiny_preset():
        cfg_j, cfg_t = configs("float32")
        params = jax_params(cfg_j)
        yield cfg_j, params, port_model(cfg_t, params)


def test_frozen_tokenizer_matches_jax(tokenizers):
    from vit_tpu.models.pretrained import FrozenTokenizer as JaxFrozen
    from vit_tpu.models.titok import TiTok as JaxTiTok
    from vit_tpu_torch.models.pretrained import FrozenTokenizer

    cfg_j, params, titok = tokenizers
    tok_j = JaxFrozen(JaxTiTok(cfg_j), jax.tree.map(jnp.asarray, params))
    tok = FrozenTokenizer(titok)
    x = images(6, seed=11)
    idx = tok.encode_indices(torch.from_numpy(x))
    assert idx.dtype == torch.int32 and idx.shape == (6, 8)
    np.testing.assert_array_equal(idx.numpy(),
                                  np.asarray(tok_j.encode_indices(x)))
    np.testing.assert_allclose(tok.decode_indices(idx).numpy(),
                               np.asarray(tok_j.decode_indices(idx.numpy())),
                               atol=GOLDEN_TOL, rtol=0)
    with pytest.raises(NotImplementedError, match="TATiTok"):
        FrozenTokenizer(torch.nn.Linear(2, 2))


def test_synthetic_video_loader_matches_jax():
    from vit_tpu.data.synthetic import SyntheticVideoLoader as JaxLoader
    from vit_tpu_torch.data.synthetic import SyntheticVideoLoader

    kw = dict(frames=5, image_size=16, steps_per_epoch=3, seed=4)
    port, ref = SyntheticVideoLoader(2, **kw), JaxLoader(2, **kw)
    assert len(port) == len(ref) == 3
    for (v, a), (v_j, a_j) in zip(port, ref):
        assert v.dtype == np.uint8 and v.shape == (2, 5, 16, 16, 3)
        np.testing.assert_array_equal(v, v_j)
        np.testing.assert_array_equal(a, a_j)


def test_videogpt_train_step_matches_jax(tokenizers):
    """The slice as a whole: three fp32 steps of the port's step (frozen
    tiny TiTok codes 97 frames of 8 tokens, S = 776 > 768, so the AR model
    runs K6 and K7/K8's plain versions) against the jitted JAX step from
    the same weights and videos. Warmup 1, so steps 1 and 2 move."""
    from train_videogpt import make_videogpt_train_step as jax_step_fn
    from vit_tpu.models.pretrained import FrozenTokenizer as JaxFrozen
    from vit_tpu.models.titok import TiTok as JaxTiTok
    from vit_tpu.train.optim import make_optimizer as jax_make_optimizer
    from vit_tpu.train.state import TrainState as JaxTrainState
    from vit_tpu_torch.data.synthetic import SyntheticVideoLoader
    from vit_tpu_torch.models.pretrained import FrozenTokenizer
    from vit_tpu_torch.train.optim import make_optimizer
    from vit_tpu_torch.train.state import TrainState
    from vit_tpu_torch.train.step import make_videogpt_train_step

    cfg_tj, tok_params, titok = tokenizers
    cfg_j, cfg_t = videogpt_configs("float32", frame_size=8, max_frames=97)
    params = videogpt_params(cfg_j)
    opt = dict(lr=1e-4, warmup_steps=1, train_steps=1000, min_lr=1e-5,
               weight_decay=1e-4, clip_norm=None)
    net_j = JaxVideoGPT(cfg_j)
    tok_j = JaxFrozen(JaxTiTok(cfg_tj), jax.tree.map(jnp.asarray, tok_params))
    step_j = jax.jit(jax_step_fn(net_j, tok_j))
    state_j = JaxTrainState.create(jax.tree.map(jnp.asarray, params),
                                   jax_make_optimizer(**opt))
    model = port_videogpt(cfg_t, params).train().requires_grad_(True)
    state = TrainState.create(model, make_optimizer(**opt))
    step = make_videogpt_train_step(model)
    tok = FrozenTokenizer(titok)
    loader = SyntheticVideoLoader(2, frames=97, image_size=32,
                                  steps_per_epoch=3, seed=0)
    for videos, _ in loader:
        clip = videos.astype(np.float32) / 255.0
        state_j, tokens_j, m_j = step_j(state_j, tok_j.params,
                                        jnp.asarray(clip))
        _, tokens, m = step(state, tok, torch.from_numpy(clip))
        assert tokens.shape == (2, 97, 8) and tokens.dtype == torch.int32
        np.testing.assert_array_equal(tokens.numpy(), np.asarray(tokens_j))
        assert set(m) == set(m_j) == {"train/loss"}
        assert m["train/loss"].dim() == 0
        np.testing.assert_allclose(m["train/loss"].item(),
                                   float(m_j["train/loss"]), rtol=GOLDEN_TOL)
    assert state.step.item() == 3
    port = flatten(flax_from_state_dict(model.state_dict()))
    ref = flatten(jax.tree.map(np.asarray, state_j.params))
    assert port.keys() == ref.keys()
    start = flatten(params)
    for k in ref:
        np.testing.assert_allclose(port[k], ref[k], atol=GOLDEN_TOL, rtol=0,
                                   err_msg=k)
        moved, moved_ref = port[k] - start[k], ref[k] - start[k]
        assert np.linalg.norm(moved_ref) > 0, k
        rel = np.linalg.norm(moved - moved_ref) / np.linalg.norm(moved_ref)
        assert rel <= UPDATE_REL, (k, rel)


def _post(url, arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        return np.load(io.BytesIO(resp.read()))


def test_export_load_and_serve_generate(tmp_path):
    """export_videogpt → load_exported → POST /generate on the CPU: the
    served rollout equals a direct generate call on the padded batch; a
    sampled export is callable with a seed and not served."""
    from vit_tpu_torch.serve.export import export_videogpt, load_exported
    from vit_tpu_torch.serve.server import make_server
    from vit_tpu_torch.utils.init import init_params_

    with tiny_preset():
        cfg = VideoGPTConfig(8, 64, "tiny", 6, dtype=torch.float32)
        model = VideoGPT(cfg)
        init_params_(model, torch.Generator().manual_seed(0))
        export_videogpt(model, str(tmp_path / "greedy"), cond_frames=2,
                        gen_frames=3, bs=2)
        export_videogpt(model, str(tmp_path / "sampled"), cond_frames=2,
                        gen_frames=3, bs=2, temperature=1.0, top_k=5)
        manifest = json.loads((tmp_path / "greedy" / "manifest.json")
                              .read_text())
        assert manifest["model"] == "videogpt" and manifest["bs"] == 2
        assert manifest["config"]["transformer"] == "tiny"
        loaded = load_exported(str(tmp_path / "greedy"), "cpu")
        assert loaded["_in_avals"] == {"generate": [((2, 16), "int32")]}
        sampled = load_exported(str(tmp_path / "sampled"), "cpu")
        assert sampled["_in_avals"]["generate"][1] == ((), "uint32")
        cond = codes((2, 16), 64, seed=6)
        a, b = sampled["generate"](cond, 3), sampled["generate"](cond, 3)
        assert torch.equal(a, b) and a.shape == (2, 40)

        httpd = make_server(str(tmp_path / "greedy"), port=0, device="cpu")
        sampled_srv = make_server(str(tmp_path / "sampled"), port=0,
                                  device="cpu")
    threads = [threading.Thread(target=h.serve_forever, daemon=True)
               for h in (httpd, sampled_srv)]
    for t in threads:
        t.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        one = _post(url + "/generate", cond[:1])
        two = _post(url + "/generate", cond)
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url + "/generate", np.full((1, 16), 64, np.int32))
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"http://127.0.0.1:{sampled_srv.server_address[1]}"
                  "/generate", cond)
        assert e.value.code == 404
    finally:
        for h in (httpd, sampled_srv):
            h.shutdown()
            h.server_close()
        for t in threads:
            t.join(timeout=10)
    assert one.dtype == two.dtype == np.int32
    assert one.shape == (1, 40) and two.shape == (2, 40)
    np.testing.assert_array_equal(two[:, :16], cond)
    assert two.min() >= 0 and two.max() < 64
    direct = loaded["generate"](cond).numpy()
    np.testing.assert_array_equal(two, direct)
    padded = np.concatenate([cond[:1], np.zeros((1, 16), np.int32)])
    np.testing.assert_array_equal(one, loaded["generate"](padded)[:1].numpy())
