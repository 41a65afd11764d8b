"""The port's entries for the other tokenizer families on the CPU:
``python -m vit_tpu_torch.train_vit_vqgan``, ``train_enhancing_vitvqgan``
and ``train_llamagen_titok``. Their flag surfaces against the JAX entries'
``parse_args``; a few synthetic steps of each ``main`` on ``--device
cpu``; SIGTERM and ``--resume`` against the uninterrupted run; the
``--vq_ckpt`` hand-offs (a ``train_vit_vqgan`` checkpoint and a LlamaGen
``.pt``), whose codes are a direct encode of the same images; the
refusals, whose messages cite ROADMAP by number; the inits.

Tiny sizes: the "tiny" preset (2 layers × 2 heads × 128) for ViT-VQGAN and
LlamaGen-TiTok, the enhancing dims cut to the same; image 32, patch 8 (16
latents), codebook 64 × 12; LlamaGen-TiTok over 16 codes of 64 with 8
latents and a 32 × 12 codebook, or over the tiny LlamaGen VQ's 256 codes
(``tests/test_llamagen_vq.py``'s layout at 32 px)."""

import functools
import importlib.util
import os
import signal
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import vit_tpu_torch.core.config as torch_config
from vit_tpu_torch import (train_enhancing_vitvqgan, train_llamagen_titok,
                           train_vit_vqgan)
from vit_tpu_torch.models import enhancing_vqgan
from vit_tpu_torch.train import loop

ROOT = Path(__file__).resolve().parent.parent
TINY = dict(n_layers=2, n_heads=2, n_embd=128)
ENHANCING_DIMS = dict(dim=128, depth=2, heads=2, dim_head=64, mlp_dim=256)
IMAGE_ARGS = ["--dataset", "synthetic", "--image_size", "32", "--patch_size",
              "8", "--codebook_size", "64", "--bs", "4", "--log_every", "1",
              "--warmup_steps", "2", "--train_steps", "100", "--no_wandb",
              "--mixed", "false", "--device", "cpu"]
CODE_ARGS = ["--dataset", "synthetic", "--transformer", "tiny",
             "--vq_codebook_size", "64", "--vq_latent_tokens", "16",
             "--latent_tokens", "8", "--codebook_size", "32", "--bs", "4",
             "--log_every", "1", "--warmup_steps", "2", "--train_steps",
             "100", "--no_wandb", "--mixed", "false", "--device", "cpu"]
ENTRIES = ("vit_vqgan", "enhancing", "llamagen_titok")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def tiny(monkeypatch):
    """The "tiny" preset, and the enhancing entry's dims cut to it."""
    monkeypatch.setitem(torch_config.transformer_configs, "tiny",
                        lambda **kw: torch_config.TransformerConfig(**TINY,
                                                                    **kw))
    monkeypatch.setattr(train_enhancing_vitvqgan, "EnhancingVQGANConfig",
                        functools.partial(enhancing_vqgan.EnhancingVQGANConfig,
                                          **ENHANCING_DIMS))


def argv(entry: str, tmp: Path, *extra: str) -> "list[str]":
    base = (CODE_ARGS if entry == "llamagen_titok"
            else IMAGE_ARGS + (["--transformer", "tiny"]
                               if entry == "vit_vqgan" else []))
    return [*base, "--ckpt_dir", str(tmp / "ckpt"), "--run_dir",
            str(tmp / "runs"), *extra]


def run(entry: str, monkeypatch, tmp: Path, *extra: str,
        kill_at: "int | None" = None):
    """``main`` of ``entry`` with its step wrapped: the loss and the input
    (codes or images) of each call recorded, SIGTERM to this process during
    call ``kill_at``. Returns (state, losses, inputs)."""
    if entry == "llamagen_titok":
        mod, attr = train_llamagen_titok, "make_llamagen_titok_train_step"
        main = train_llamagen_titok.main
    else:
        mod, attr = loop, "make_tokenizer_train_step"
        main = (train_vit_vqgan if entry == "vit_vqgan"
                else train_enhancing_vitvqgan).main
    factory = getattr(mod, attr)
    losses, inputs = [], []

    def make(model, **kw):
        step = factory(model, **kw)

        def wrapped(state, x, usage):
            inputs.append(x.clone())
            if len(inputs) == kill_at:
                os.kill(os.getpid(), signal.SIGTERM)
            out = step(state, x, usage)
            losses.append(out[2]["train/loss"].item())
            return out

        return wrapped

    monkeypatch.setattr(mod, attr, make)
    prev = signal.getsignal(signal.SIGTERM)
    try:
        state = main(argv(entry, tmp, *extra))
    finally:
        signal.signal(signal.SIGTERM, prev)
        monkeypatch.setattr(mod, attr, factory)
    return state, losses, inputs


def jax_entry(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  ROOT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("entry,jax_name", [
    (train_vit_vqgan, "train_vit_vqgan"),
    (train_enhancing_vitvqgan, "train_enhancing_vitvqgan"),
    (train_llamagen_titok, "train_llamagen_titok")],
    ids=lambda e: getattr(e, "__name__", e).split(".")[-1])
def test_flags_and_defaults_match_the_jax_entry(entry, jax_name,
                                                monkeypatch):
    """Every flag of the JAX entry with its default; the port adds
    ``--device`` only."""
    mod = jax_entry(jax_name)
    monkeypatch.setattr(sys, "argv", [f"{jax_name}.py"])
    want = vars(mod.parse_args())
    got = vars(entry.parse_args([]))
    assert set(got) - set(want) == {"device"}
    assert {k: got[k] for k in want} == want


@pytest.mark.parametrize("entry", ENTRIES)
def test_main_trains_on_cpu(entry, monkeypatch, tmp_path):
    """Three synthetic steps: finite losses, the step count, "best" and
    "last" with their configs, the metrics file."""
    state, losses, inputs = run(entry, monkeypatch, tmp_path,
                                "--steps_per_epoch", "3", "--epochs", "1")
    assert state.step.item() == 3 and len(losses) == 3
    assert all(np.isfinite(losses))
    for tag in ("best", "last"):
        assert (tmp_path / "ckpt" / tag / "state.pt").exists()
        assert (tmp_path / "ckpt" / f"{tag}_config.json").exists()
    assert list((tmp_path / "runs").glob("*/*.jsonl"))
    if entry == "llamagen_titok":
        assert inputs[0].dtype == torch.int32
        assert inputs[0].shape == (4, 16)


@pytest.mark.parametrize("entry", ENTRIES)
def test_sigterm_then_resume_matches_the_straight_run(entry, monkeypatch,
                                                      tmp_path):
    """SIGTERM during the second step saves "last" at step 2 and returns;
    ``--resume`` continues there, and its steps 3-6 give the uninterrupted
    run's losses. LlamaGen-TiTok runs with ``--micro_steps 2`` (batches of
    2), so the cut falls at an update's end."""
    extra = ["--steps_per_epoch", "3", "--epochs", "2"]
    if entry == "llamagen_titok":
        extra += ["--micro_steps", "2"]
    _, straight, _ = run(entry, monkeypatch, tmp_path / "straight", *extra)
    state, cut, _ = run(entry, monkeypatch, tmp_path / "cut", *extra,
                        kill_at=2)
    assert state.step.item() == 2
    np.testing.assert_allclose(cut, straight[:2], rtol=1e-6, atol=1e-8)
    state, resumed, _ = run(entry, monkeypatch, tmp_path / "cut", *extra,
                            "--resume")
    assert state.step.item() == 6
    np.testing.assert_allclose(resumed, straight[2:], rtol=1e-6, atol=1e-8)


def test_synthetic_codes_are_keyed_by_seed_and_epoch():
    args = train_llamagen_titok.parse_args(
        ["--dataset", "synthetic", "--bs", "8", "--micro_steps", "2",
         "--steps_per_epoch", "2"])
    stream = train_llamagen_titok.SyntheticCodes(args)
    first, second = list(stream), list(stream)
    assert first[0][0].shape == (4, 256) and first[0][0].dtype == np.int32
    assert not np.array_equal(first[0][0], second[0][0])
    stream._epoch = 0
    np.testing.assert_array_equal(list(stream)[1][0], first[1][0])
    assert first[0][0].max() < 16384


@pytest.fixture
def vit_vqgan_ckpt(monkeypatch, tmp_path) -> Path:
    """A tiny ``train_vit_vqgan`` run's checkpoint directory (2 steps)."""
    run("vit_vqgan", monkeypatch, tmp_path / "vq", "--steps_per_epoch", "2",
        "--epochs", "1")
    return tmp_path / "vq" / "ckpt"


def test_vq_ckpt_hands_off_from_train_vit_vqgan(vit_vqgan_ckpt, monkeypatch,
                                                tmp_path, capsys):
    """``--vq_ckpt <dir>``: the codes of each step are the "best"
    ViT-VQGAN's encode of the synthetic images at its image size, with bs
    images a micro-step (a warning names ROADMAP Queue C #11); the image
    step decodes through it."""
    from vit_tpu_torch.data.synthetic import SyntheticImageLoader

    _, losses, inputs = run(
        "llamagen_titok", monkeypatch, tmp_path, "--vq_ckpt",
        str(vit_vqgan_ckpt), "--steps_per_epoch", "2", "--epochs", "1",
        "--micro_steps", "2", "--image_every", "1")
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "Queue C #11" in capsys.readouterr().out
    vq = train_llamagen_titok.load_vit_vqgan(vit_vqgan_ckpt).eval()
    batches = SyntheticImageLoader(32, 4, steps_per_epoch=2, seed=0,
                                   mode="shapes")
    for (images, _), codes in zip(batches, inputs):
        with torch.no_grad():
            want = vq.encode(torch.from_numpy(images))
        assert codes.shape == (4, 16)
        assert torch.equal(codes, want)


def test_vq_ckpt_reads_a_llamagen_pt(monkeypatch, tmp_path):
    """``--vq_ckpt <file.pt>``: a LlamaGen-layout file of the tiny VQ,
    written by ``llamagen_state_dict``; at 32 px (the entry's 256 cut for
    the CPU) its 16 × 16 codes are the loaded VQ's encode of the same
    synthetic images."""
    from vit_tpu_torch.data.synthetic import SyntheticImageLoader
    from vit_tpu_torch.models.llamagen_vq import (LlamaGenVQ,
                                                  LlamaGenVQConfig,
                                                  llamagen_state_dict)
    from vit_tpu_torch.utils.init import init_llamagen_vq_

    vq = LlamaGenVQ(LlamaGenVQConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                                     enc_attn=(0, 1), dec_attn=(2, 0),
                                     z_channels=16, embed_dim=8, n_embed=64))
    init_llamagen_vq_(vq, torch.Generator().manual_seed(0))
    path = tmp_path / "vq.pt"
    torch.save({"model": llamagen_state_dict(vq)}, path)
    monkeypatch.setattr(train_llamagen_titok, "LLAMAGEN_IMAGE", 32)
    _, losses, inputs = run(
        "llamagen_titok", monkeypatch, tmp_path, "--vq_ckpt", str(path),
        "--vq_latent_tokens", "256", "--steps_per_epoch", "2", "--epochs",
        "1", "--image_every", "1")
    assert len(losses) == 2 and all(np.isfinite(losses))
    batches = SyntheticImageLoader(32, 4, steps_per_epoch=2, seed=0,
                                   mode="shapes")
    for (images, _), codes in zip(batches, inputs):
        assert torch.equal(codes, vq.eval().encode(torch.from_numpy(images)))


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("flags", [
    ["--attn_impl", "xla"], ["--scan_layers", "true"],
    ["--mesh", "1,1,1"], ["--pp_microbatches", "2"]],
    ids=lambda f: "_".join(a.lstrip("-") for a in f))
def test_refuses_unported_flags(entry, flags, monkeypatch, tmp_path):
    """Each flag whose path is not ported raises before anything is built
    or written, naming its ROADMAP item."""
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A #"):
        run(entry, monkeypatch, tmp_path, *flags)
    assert not (tmp_path / "ckpt").exists()


@pytest.mark.parametrize("entry", ENTRIES)
def test_refuses_a_latent_width_k5_cannot_take(entry):
    """K5 takes every width D ≥ 1 on the card (ROADMAP Queue C #4,
    closed): ``--latent_dim 2000`` passes each entry's card check, and
    only D 0 is refused, by the wrapper on any device."""
    mod = {"vit_vqgan": train_vit_vqgan,
           "enhancing": train_enhancing_vitvqgan,
           "llamagen_titok": train_llamagen_titok}[entry]
    mod.check_ported(mod.parse_args(["--latent_dim", "2000", "--dataset",
                                     "synthetic", "--device", "cuda"]))
    from vit_tpu_torch.kernels import vq as k_vq

    with pytest.raises(ValueError, match="K5 takes D ≥ 1"):
        k_vq.nearest_code(torch.zeros(4, 0), torch.zeros(8, 0))


def test_llamagen_refuses_what_the_jax_entry_asserts_or_fails_on(
        vit_vqgan_ckpt, monkeypatch, tmp_path):
    """A real dataset without ``--vq_ckpt`` (the JAX entry's assertion);
    ImageNet's 256 px with a ViT-VQGAN of 32, an FSQ ViT-VQGAN, and a VQ
    whose 16 codes ``--vq_latent_tokens 256`` does not fit (ROADMAP Queue
    C #10): each before a step."""
    data = tmp_path / "data"
    data.mkdir()
    with pytest.raises(NotImplementedError,
                       match=r"needs --vq_ckpt.*train_llamagen_titok.py:150"):
        run("llamagen_titok", monkeypatch, tmp_path, "--dataset", "imagenet",
            "--data_dir", str(data))
    with pytest.raises(NotImplementedError,
                       match="takes 32 px.*ROADMAP Queue C #10"):
        run("llamagen_titok", monkeypatch, tmp_path, "--dataset", "imagenet",
            "--data_dir", str(data), "--vq_ckpt", str(vit_vqgan_ckpt))
    with pytest.raises(NotImplementedError,
                       match="16 codes of 64.*ROADMAP Queue C #10"):
        run("llamagen_titok", monkeypatch, tmp_path, "--vq_ckpt",
            str(vit_vqgan_ckpt), "--vq_latent_tokens", "256")
    cfg = (vit_vqgan_ckpt / "best_config.json").read_text()
    (vit_vqgan_ckpt / "best_config.json").write_text(
        cfg.replace('"quantizer": "vq"', '"quantizer": "fsq"'))
    with pytest.raises(NotImplementedError, match="FSQ.*ROADMAP Queue C #10"):
        run("llamagen_titok", monkeypatch, tmp_path, "--vq_ckpt",
            str(vit_vqgan_ckpt))
    assert not (tmp_path / "ckpt").exists()


@pytest.mark.parametrize("entry", ENTRIES)
def test_no_card_exits_nonzero(entry, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        run(entry, monkeypatch, tmp_path, "--device", "cuda")
    assert not (tmp_path / "ckpt").exists()


def test_inits_fill_every_parameter_with_its_law():
    """``init_enhancing_``: Xavier-uniform Linear weights within
    √(6/(fan_in + fan_out)), zero biases, unit LayerNorms;
    ``init_llamagen_titok_``: zero biases of its own Linears, tables of
    std 0.02·0.88 (the truncated normal's) and positional tables of std
    width^-½; ``init_llamagen_vq_``: an N(0, 1) codebook, zero conv
    biases, unit GroupNorms."""
    from vit_tpu_torch.models.llamagen_titok import (LlamaGenTiTok,
                                                     LlamaGenTiTokConfig)
    from vit_tpu_torch.models.llamagen_vq import (GroupNorm, LlamaGenVQ,
                                                  vq16_config)
    from vit_tpu_torch.utils.init import (init_enhancing_,
                                          init_llamagen_titok_,
                                          init_llamagen_vq_)

    g = torch.Generator().manual_seed(0)
    enh = enhancing_vqgan.EnhancingViTVQGAN(enhancing_vqgan.EnhancingVQGANConfig(
        32, 8, 64, 12, **ENHANCING_DIMS))
    for p in enh.parameters():
        p.data.fill_(float("nan"))
    init_enhancing_(enh, g)
    for m in enh.modules():
        if isinstance(m, torch.nn.Linear):
            bound = (6.0 / (m.in_features + m.out_features)) ** 0.5
            assert m.weight.abs().max() <= bound
            assert m.weight.abs().max() > 0.9 * bound
            assert m.bias is None or not m.bias.any()
    assert all(torch.isfinite(p).all() for p in enh.parameters())
    model = LlamaGenTiTok(LlamaGenTiTokConfig(1024, 16, 8, 32, 12, "tiny"))
    init_llamagen_titok_(model, g)
    assert abs(model.enc.tok_emb.std().item() - 0.02 * 0.8796) < 1e-3
    assert abs(model.enc.pos_emb.std().item() - 128 ** -0.5) < 1e-2
    assert not model.dec.emb_proj.bias.any()
    assert model.quant.codebook.abs().max() <= 1 / 32
    vq = LlamaGenVQ(vq16_config())
    init_llamagen_vq_(vq, g)
    assert abs(vq.codebook.std().item() - 1.0) < 2e-2
    assert all(not m.bias.any() for m in vq.modules()
               if isinstance(m, torch.nn.Conv2d))
    assert all(bool((m.weight == 1).all()) for m in vq.modules()
               if isinstance(m, GroupNorm))
