"""``python -m vit_tpu_torch.export_tokenizer`` for every model it serves, on
the CPU: a port checkpoint written by ``Checkpointer.save`` from JAX init
weights, exported fp and int8 through the CLI, loaded by ``load_exported``
and held against the JAX model on the exported weights; the manifest's
fields, the int8 ``weights.npz`` layout against the JAX ``quantize_params``
tree, the fidelity fields against the JAX test's bounds
(``tests/test_quant.py:157-164``), HTTP round trips of ``/predict`` and
LlamaGen-TiTok's ``/encode``, and the refusals."""

import contextlib
import functools
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

import vit_tpu.core.config as jax_config
import vit_tpu_torch.core.config as torch_config
from torch_port_helpers import TITOK, codes, images, tiny_preset
from vit_tpu.core.quant import quantize_params as jax_quantize_params
from vit_tpu_torch.bridge import (flatten, module_state_dict_from_flax,
                                  unflatten)
from vit_tpu_torch.export_tokenizer import main as export_main
from vit_tpu_torch.serve.export import FAMILIES, load_exported
from vit_tpu_torch.serve.server import make_server
from vit_tpu_torch.train.checkpoint import Checkpointer
from vit_tpu_torch.train.optim import make_optimizer
from vit_tpu_torch.train.state import TrainState

REL = 1e-3
BS = 2
SHAPE = dict(image_size=32, patch_size=8, codebook_size=64, latent_dim=12)
ENHANCING_DIMS = dict(dim=128, depth=2, heads=2, dim_head=64, mlp_dim=256)
TATITOK = dict(image_size=32, patch_size=8, latent_tokens=8,
               codebook_size=64, latent_dim=12, transformer="small")
LLAMAGEN = dict(vq_codebook_size=64, vq_latent_tokens=16, latent_tokens=8,
                codebook_size=32, latent_dim=12, transformer="tiny")
VIT = dict(image_size=32, in_channels=3, patch_size=8, transformer="tiny",
           extra_tokens=1, dropout=0.0)
N_CLASSES = 10
VIDEOGPT = dict(frame_size=8, codebook_size=64, transformer="tiny",
                max_frames=6)
COND, GEN = 2, 2   # VideoGPT's exported frames
NAMES = tuple(FAMILIES)
INT8 = tuple(n for n in NAMES if n != "enhancing")
TOKENIZERS = ("titok", "vit_vqgan", "enhancing", "tatitok", "llamagen_titok")
# the fields of the JAX export's manifests (vit_tpu/serve/export.py:
# _write_artifacts and the three exports' dicts)
COMMON = {"model", "bs", "tag", "platforms", "attn_impl", "step", "quantize",
          "dp", "use_ema", "functions"}
JAX_FIELDS = {
    "tokenizer": COMMON | {"input", "n_tokens", "codebook_size",
                           "indices_dtype"},
    "vit_classifier": COMMON | {"image_size", "num_classes"},
    "videogpt": COMMON | {"input", "input_shape", "frame_size",
                          "codebook_size", "cond_frames", "gen_frames",
                          "temperature", "top_k"},
}


@contextlib.contextmanager
def presets():
    """The "tiny" preset and the Bytedance "small" cut to 2 layers × 2
    heads × 128, in both packages."""
    with tiny_preset(), pytest.MonkeyPatch.context() as mp:
        for mod in (jax_config, torch_config):
            mp.setitem(mod.BYTEDANCE_WIDTH, "small", 128)
            mp.setitem(mod.BYTEDANCE_LAYERS, "small", 2)
            mp.setitem(mod.BYTEDANCE_HEADS, "small", 2)
        yield


@pytest.fixture(scope="module", autouse=True)
def setting():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with presets():
        yield
    torch.set_num_threads(n)


def configs(name: str, **kw):
    """(JAX config, port config) of the tiny ``name``; ``kw`` to both."""
    import vit_tpu.models.enhancing_vqgan as je
    import vit_tpu.models.llamagen_titok as jl
    import vit_tpu.models.tatitok as jt
    import vit_tpu.models.titok as jtt
    import vit_tpu.models.videogpt as jv
    import vit_tpu.models.vit as jvit
    import vit_tpu.models.vit_vqgan as jq

    jax_cls = {"titok": (jtt.TiTokConfig, TITOK),
               "vit_vqgan": (jq.ViTVQGANConfig, dict(SHAPE,
                                                     transformer="tiny")),
               "enhancing": (je.EnhancingVQGANConfig,
                             dict(SHAPE, **ENHANCING_DIMS)),
               "tatitok": (jt.TATiTokConfig, TATITOK),
               "llamagen_titok": (jl.LlamaGenTiTokConfig, LLAMAGEN),
               "vit_classifier": (jvit.ViTConfig, VIT),
               "videogpt": (jv.VideoGPTConfig, VIDEOGPT)}[name]
    cls, fields = jax_cls
    extra = {"attn_impl": "xla"} if name == "tatitok" else {}
    return (cls(**fields, dtype=jnp.float32, **extra, **kw),
            FAMILIES[name][0](**fields, dtype=torch.float32, **kw))


def jax_net(name: str, cfg):
    import vit_tpu.models.enhancing_vqgan as je
    import vit_tpu.models.llamagen_titok as jl
    import vit_tpu.models.tatitok as jt
    import vit_tpu.models.titok as jtt
    import vit_tpu.models.videogpt as jv
    import vit_tpu.models.vit as jvit
    import vit_tpu.models.vit_vqgan as jq

    if name == "vit_classifier":
        return jvit.ViTClassifier(cfg, num_classes=N_CLASSES)
    return {"titok": jtt.TiTok, "vit_vqgan": jq.ViTVQGAN,
            "enhancing": je.EnhancingViTVQGAN, "tatitok": jt.TATiTok,
            "llamagen_titok": jl.LlamaGenTiTok,
            "videogpt": jv.VideoGPT}[name](cfg)


def init_input(name: str):
    if name == "llamagen_titok":
        return (jnp.zeros((1, LLAMAGEN["vq_latent_tokens"]), jnp.int32),)
    if name == "videogpt":
        return (jnp.zeros((1, 1, VIDEOGPT["frame_size"]), jnp.int32),)
    return (jnp.zeros((1, 32, 32, 3)),)


def inputs(name: str, seed: int) -> np.ndarray:
    if name == "llamagen_titok":
        return codes((BS, LLAMAGEN["vq_latent_tokens"]),
                     LLAMAGEN["vq_codebook_size"], seed)
    if name == "videogpt":
        return codes((BS, COND * VIDEOGPT["frame_size"]),
                     VIDEOGPT["codebook_size"], seed)
    return images(BS, seed)


def cli(ckpt, out, name: str, *flags: str):
    extra = (["--cond_frames", str(COND), "--gen_frames", str(GEN)]
             if name == "videogpt" else [])
    return export_main(["--ckpt", str(ckpt), "--out", str(out), "--model",
                        name, "--bs", str(BS), "--device", "cpu", *extra,
                        *flags])


@functools.lru_cache(maxsize=None)
def exported(name: str, root: str) -> dict:
    """``name``'s JAX init, its port checkpoint ("best", with an EMA
    average) and its fp (and int8) exports through the CLI."""
    from pathlib import Path

    cfg_j, cfg_t = configs(name)
    args = init_input(name) + ((None,) if name == "tatitok" else ())
    params = jax.tree.map(np.asarray, jax.jit(jax_net(name, cfg_j).init)(
        jax.random.PRNGKey(0), *args)["params"])
    model = FAMILIES[name][1](*((cfg_t, N_CLASSES)
                                if name == "vit_classifier" else (cfg_t,)))
    model.load_state_dict(module_state_dict_from_flax(params, model))
    root = Path(root) / name
    ckpt = Checkpointer(str(root / "ckpt"))
    ckpt.save(TrainState.create(model, make_optimizer(1e-4, 1, 10, 1e-5, 0.0),
                                ema_decay=0.5), config=cfg_t, tag="best")
    ckpt.save(TrainState.create(model, make_optimizer(1e-4, 1, 10, 1e-5,
                                                      0.0)),
              config=cfg_t, tag="last")
    out = {"params": params, "ckpt": root / "ckpt", "model": model,
           "fp": cli(root / "ckpt", root / "fp", name)}
    if name in INT8:
        out["int8"] = cli(root / "ckpt", root / "int8", name, "--quantize",
                          "int8")
    return out


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("families"))


def jax_outputs(name: str, tree: dict, quant, x: np.ndarray) -> dict:
    """The JAX model's outputs on ``tree``: a tokenizer's codes and their
    decode, the classifier's logits, VideoGPT's greedy rollout."""
    net = jax_net(name, configs(name, **({"quant": quant} if quant
                                         else {}))[0])
    p = jax.tree.map(jnp.asarray, tree)
    x = jnp.asarray(x)
    if name == "vit_classifier":
        return {"predict": jax.jit(lambda p, x: net.apply(
            {"params": p}, x, deterministic=True))(p, x)}
    if name == "videogpt":
        from vit_tpu.models.videogpt import generate

        return {"generate": generate(net, p, x, GEN * VIDEOGPT["frame_size"])}
    if name == "tatitok":
        enc = jax.jit(lambda p, x: net.apply(
            {"params": p}, x, method=net.encode)[1]["min_encoding_indices"])
        dec = jax.jit(lambda p, i: net.apply({"params": p}, i,
                                             method=net.decode_tokens))
    else:
        enc = jax.jit(lambda p, x: net.apply({"params": p}, x,
                                             method=net.encode))
        dec = jax.jit(lambda p, i: net.apply({"params": p}, i,
                                             method=net.decode_indices))
    idx = enc(p, x)
    return {"encode": idx, "decode": dec(p, idx)}


def npz_tree(out) -> dict:
    with np.load(out / "weights.npz") as npz:
        return unflatten({k: npz[k] for k in npz.files})


def rel(out, ref) -> float:
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("name, quant",
                         [(n, None) for n in NAMES] + [(n, "int8")
                                                       for n in INT8])
def test_export_matches_jax(name, quant, root):
    """The loaded export's functions against the JAX model on the same
    weights: codes and rollouts equal, decodes and logits within 1e-3 of
    the largest value."""
    art = exported(name, root)
    out = art["int8" if quant else "fp"]
    served = load_exported(str(out), "cpu")
    x = inputs(name, seed=11)
    want = jax_outputs(name, npz_tree(out), quant, x)
    if name in TOKENIZERS:
        idx = served["encode"](x)
        assert idx.dtype == torch.int32
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want["encode"]))
        dec = served["decode"](np.asarray(want["encode"]))
        assert rel(dec, want["decode"]) < REL
    elif name == "vit_classifier":
        logits = served["predict"](x)
        assert logits.shape == (BS, N_CLASSES)
        assert rel(logits, want["predict"]) < REL
    else:
        np.testing.assert_array_equal(served["generate"](x).numpy(),
                                      np.asarray(want["generate"]))
    if not quant:   # the fp export is the checkpoint's model itself
        assert flatten(npz_tree(out)).keys() == flatten(art["params"]).keys()


@pytest.mark.parametrize("name", NAMES)
def test_manifest_fields(name, root):
    """The JAX export's fields plus ``config`` and ``torch_version``, minus
    ``jax_version``; the checkpoint's tag and step recorded."""
    art = exported(name, root)
    for kind in ("fp", "int8") if name in INT8 else ("fp",):
        man = json.loads((art[kind] / "manifest.json").read_text())
        want = JAX_FIELDS.get(name, JAX_FIELDS["tokenizer"])
        if name in TOKENIZERS:
            want = want | ({"input_shape", "output"}
                           if name == "llamagen_titok" else {"image_size"})
        if kind == "int8" and name in TOKENIZERS:
            want = want | {"quant_encode_index_agreement",
                           "quant_decode_logit_argmax_agreement"
                           if name == "llamagen_titok"
                           else "quant_decode_psnr_db_vs_fp"}
        assert set(man) == want | {"config", "torch_version"}, kind
        assert man["model"] == name and man["bs"] == BS
        assert man["tag"] == "best" and man["step"] == 0
        assert man["quantize"] == (None if kind == "fp" else "int8")
        assert man["config"].get("quant") == man["quantize"] or \
            name == "enhancing"
        assert man["platforms"] == ["cpu", "cuda"]
        assert man["functions"] == sorted(load_exported(
            str(art[kind]), "cpu")["_in_avals"])


@pytest.mark.parametrize("name", INT8)
def test_int8_weights_layout(name, root):
    """The int8 ``weights.npz`` has the keys, dtypes and shapes of the JAX
    ``quantize_params`` tree of the same fp weights, every int8 level
    within one of JAX's, and a quarter of the fp transformer bytes."""
    art = exported(name, root)
    cfg_q = configs(name, quant="int8")[0]
    net_q = jax_net(name, cfg_q)
    args = init_input(name) + ((None,) if name == "tatitok" else ())
    target = jax.eval_shape(net_q.init, jax.random.PRNGKey(0), *args)[
        "params"]
    want = flatten(jax.tree.map(np.asarray, jax_quantize_params(
        target, jax.tree.map(jnp.asarray, art["params"]))))
    got = flatten(npz_tree(art["int8"]))
    assert got.keys() == want.keys()
    for k in want:
        assert (got[k].dtype, got[k].shape) == (want[k].dtype,
                                                want[k].shape), k
        if k.endswith("kernel_q"):
            assert np.abs(got[k].astype(int) - want[k]).max() <= 1, k
    kq = [k for k in got if k.endswith("/kernel_q")]
    assert kq and not any(k.endswith("qkv/kernel") for k in got)
    fp = flatten(npz_tree(art["fp"]))
    for k in kq:
        site = k.removesuffix("/kernel_q")
        assert got[k].nbytes * 4 == fp[site + "/kernel"].nbytes


@pytest.mark.parametrize("name", [n for n in TOKENIZERS if n in INT8])
def test_fidelity_fields_within_jax_bounds(name, root):
    man = json.loads((exported(name, root)["int8"] / "manifest.json")
                     .read_text())
    assert 0.5 < man["quant_encode_index_agreement"] <= 1.0
    if name == "llamagen_titok":
        assert 0.5 < man["quant_decode_logit_argmax_agreement"] <= 1.0
    else:
        assert man["quant_decode_psnr_db_vs_fp"] > 20.0


def _post(url, arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return np.load(io.BytesIO(resp.read()))


@contextlib.contextmanager
def serving(out):
    httpd = make_server(str(out), port=0, device="cpu")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)


@pytest.mark.parametrize("kind", ["fp", "int8"])
def test_http_predict(kind, root):
    """The classifier's /predict over HTTP (one row, padded to bs): the
    direct call's logits; no index check, no /encode."""
    out = exported("vit_classifier", root)[kind]
    x = inputs("vit_classifier", seed=12)
    direct = load_exported(str(out), "cpu")["predict"](x).numpy()
    with serving(out) as url:
        got = _post(url + "/predict", x[:1])
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url + "/encode", x[:1])
        assert e.value.code == 404
    assert got.shape == (1, N_CLASSES) and got.dtype == np.float32
    np.testing.assert_allclose(got, direct[:1], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["fp", "int8"])
def test_http_llamagen_encode(kind, root):
    """LlamaGen-TiTok's /encode takes VQ code ids, checked against the VQ's
    codebook; /decode gives logits over it."""
    out = exported("llamagen_titok", root)[kind]
    x = inputs("llamagen_titok", seed=13)
    served = load_exported(str(out), "cpu")
    with serving(out) as url:
        idx = _post(url + "/encode", x)
        logits = _post(url + "/decode", idx)
        for bad in (np.full_like(x, LLAMAGEN["vq_codebook_size"]), -x - 1):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(url + "/encode", bad)
            assert e.value.code == 400
    np.testing.assert_array_equal(idx, served["encode"](x).numpy())
    assert idx.max() < LLAMAGEN["codebook_size"]
    assert logits.shape == (BS, LLAMAGEN["vq_latent_tokens"],
                            LLAMAGEN["vq_codebook_size"])
    np.testing.assert_allclose(
        logits, served["decode"](idx).numpy(), rtol=1e-6, atol=1e-6)


def test_use_ema_and_tag(root):
    """``--use_ema`` exports the average ("best" holds one), ``--tag last``
    the other checkpoint."""
    art = exported("titok", root)
    out = cli(art["ckpt"], art["ckpt"].parent / "ema", "titok", "--use_ema")
    man = json.loads((out / "manifest.json").read_text())
    assert man["use_ema"] is True
    last = cli(art["ckpt"], art["ckpt"].parent / "last", "titok", "--tag",
               "last")
    assert json.loads((last / "manifest.json").read_text())["tag"] == "last"
    for a, b in zip(flatten(npz_tree(out)).values(),
                    flatten(npz_tree(last)).values()):
        np.testing.assert_array_equal(a, b)   # the average of one state


@pytest.mark.parametrize("case", [
    "enhancing_int8", "unknown_mode", "dp2", "dp_host_cpu", "text_guided",
    "ema_missing"])
def test_refusals(case, root, tmp_path):
    if case == "enhancing_int8":
        ckpt = exported("enhancing", root)["ckpt"]
        with pytest.raises(ValueError, match="'enhancing' model"):
            cli(ckpt, tmp_path / "o", "enhancing", "--quantize", "int8")
    elif case == "unknown_mode":
        from vit_tpu_torch.serve.export import export_tokenizer

        with pytest.raises(ValueError, match="unsupported quantize mode"):
            export_tokenizer(exported("titok", root)["ckpt"], tmp_path / "o",
                             quantize="int4", device="cpu")
        with pytest.raises(SystemExit):
            cli(exported("titok", root)["ckpt"], tmp_path / "o", "titok",
                "--quantize", "int4")
    elif case in ("dp2", "dp_host_cpu"):
        flags = ["--dp", "2"] if case == "dp2" else ["--dp_host_cpu"]
        with pytest.raises(NotImplementedError, match="ROADMAP Queue A #9"):
            cli(exported("videogpt", root)["ckpt"], tmp_path / "o",
                "videogpt", *flags)
    elif case == "text_guided":
        _, cfg = configs("tatitok", text_guidance=True,
                         text_context_length=5, text_embed_dim=16)
        model = FAMILIES["tatitok"][1](cfg)
        Checkpointer(str(tmp_path / "ck")).save(TrainState.create(
            model, make_optimizer(1e-4, 1, 10, 1e-5, 0.0)), config=cfg,
            tag="best")
        with pytest.raises(ValueError, match="text-guided TATiTok"):
            cli(tmp_path / "ck", tmp_path / "o", "tatitok")
    else:
        with pytest.raises(ValueError, match="holds no EMA average"):
            cli(exported("vit_classifier", root)["ckpt"], tmp_path / "o",
                "vit_classifier", "--use_ema", "--tag", "last")
    assert not (tmp_path / "o").exists()
