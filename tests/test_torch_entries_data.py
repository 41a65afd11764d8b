"""The port's training entries on real data at tiny sizes on the CPU: each
``--dataset``, ``--loader_backend`` and ``--loader_processes`` value that
``train_titok``, ``train_vit`` and ``train_videogpt`` refused before the
data layer was ported now runs, on fixtures the tests write; a dataset
whose package is missing is refused naming the package; and K5's runtime-D
form: ``--latent_dim 6`` accepted, its host plan, its plain version against
the JAX package's XLA oracle at D 6 and 24."""

import io
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import tiny_preset

from vit_tpu.kernels.vq import nearest_code_xla
from vit_tpu_torch.data import native
from vit_tpu_torch.kernels import vq as k_vq

TITOK = ["--transformer", "tiny", "--patch_size", "8", "--latent_tokens",
         "4", "--codebook_size", "32", "--no_wandb", "--device", "cpu",
         "--mixed", "false", "--epochs", "1", "--max_epoch_steps", "2",
         "--log_every", "1", "--warmup_steps", "1", "--image_every", "1000"]
VIT = ["--transformer", "tiny", "--image_size", "32", "--patch_size", "8",
       "--bs", "4", "--num_classes", "3", "--no_wandb", "--device", "cpu",
       "--epochs", "1", "--log_every", "1", "--warmup_steps", "1"]
GPT = ["--image_size", "16", "--frame_size", "4", "--codebook_size", "32",
       "--transformer", "tiny", "--max_frames", "4", "--condition_frames", "2",
       "--bs", "2", "--epochs", "1", "--log_every", "1", "--mixed", "false",
       "--gen_every", "1000", "--device", "cpu", "--no_wandb"]
CLIP_FRAMES = 12


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for the tiny models: under the suite's parallel
    workers, a thread a core in every worker only adds contention."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def clips(root, size: int, count: int = 5) -> None:
    rng = np.random.default_rng(size)
    for v in range(count):
        d = root / f"f{v % 2}"
        d.mkdir(parents=True, exist_ok=True)
        np.savez(d / f"v{v}.npz",
                 video=rng.integers(0, 256, (CLIP_FRAMES, size, size, 3),
                                    np.uint8),
                 actions=rng.integers(0, 9, (CLIP_FRAMES,)))


def jpeg(rng, h: int, w: int) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(
        buf, format="JPEG")
    return buf.getvalue()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """DMLab clips at 16 and 64 px, ImageNet folders (8 train, 4 val JPEGs
    in 3 classes), jpg + cls tar shards and a Minecraft folder of 128-px
    ``.mp4`` clips."""
    root = tmp_path_factory.mktemp("data")
    clips(root / "dmlab16", 16)
    clips(root / "dmlab64", 64, count=2)
    rng = np.random.default_rng(0)
    for split, n in (("train", 8), ("val", 4)):
        for i in range(n):
            d = root / "imagenet" / split / f"c{i % 3}"
            d.mkdir(parents=True, exist_ok=True)
            (d / f"{i}.JPEG").write_bytes(jpeg(rng, 30 + i, 40 - i))
    from vit_tpu_torch.data.wds import ShardWriter

    with ShardWriter(str(root / "wds" / "s-%03d.tar"), maxcount=4) as w:
        for i in range(8):
            w.write({"__key__": f"k{i:03d}",
                     "jpg": rng.integers(0, 256, (36, 36, 3), np.uint8),
                     "cls": i % 3})
    cv2 = pytest.importorskip("cv2")
    (root / "minecraft" / "a").mkdir(parents=True)
    out = cv2.VideoWriter(str(root / "minecraft" / "a" / "v.mp4"),
                          cv2.VideoWriter_fourcc(*"mp4v"), 10, (128, 128))
    for _ in range(10):
        out.write(rng.integers(0, 256, (128, 128, 3), np.uint8))
    out.release()
    return root


def dirs(tmp_path) -> list:
    return ["--ckpt_dir", str(tmp_path / "ckpt"), "--run_dir",
            str(tmp_path / "runs")]


def step_lines(out: str) -> list:
    return [float(m.group(1)) for m in re.finditer(r" loss=(\S+)", out)]


# -- the lifted flags ---------------------------------------------------------

@pytest.mark.parametrize("flags", [
    ["--dataset", "dmlab", "--image_size", "64", "--bs", "16",
     "--patch_size", "16"],
    ["--dataset", "imagenet", "--image_size", "16", "--bs", "4"],
    ["--dataset", "minecraft", "--image_size", "128", "--bs", "8",
     "--patch_size", "32"],
    ["--dataset", "imagenet", "--image_size", "16", "--bs", "4",
     "--loader_backend", "grain"],
    ["--dataset", "imagenet", "--image_size", "16", "--bs", "4",
     "--loader_processes", "2"],
], ids=["dataset_dmlab", "dataset_imagenet", "dataset_minecraft",
        "loader_backend_grain", "loader_processes_2"])
def test_train_titok_reads_real_data(flags, data, tmp_path, capsys):
    """``train_titok`` takes two logged steps on each dataset the JAX entry
    reads, and says which decoder its JPEGs take."""
    from vit_tpu_torch.train_titok import main

    if "grain" in flags:
        pytest.importorskip("grain.python")
    where = {"dmlab": "dmlab64", "imagenet": "imagenet",
             "minecraft": "minecraft"}[flags[1]]
    with tiny_preset():
        main([*TITOK, *flags, "--data_dir", str(data / where),
              *dirs(tmp_path)])
    out = capsys.readouterr().out
    losses = step_lines(out)
    assert len(losses) == 2 and all(np.isfinite(losses)), out
    if flags[1] == "imagenet":
        assert ("DECODER: native libjpeg" if native.is_available()
                else "DECODER: Pillow") in out


def test_train_titok_dmlab_takes_image_64_only(data, tmp_path):
    """The reference's ``image_size == 64`` assert for DMLab."""
    from vit_tpu_torch.train_titok import main

    with tiny_preset(), pytest.raises(AssertionError):
        main([*TITOK, "--dataset", "dmlab", "--image_size", "32",
              "--data_dir", str(data / "dmlab64"), *dirs(tmp_path)])


@pytest.mark.parametrize("flags", [
    ["--dataset", "imagenet"], ["--dataset", "wds"],
    ["--dataset", "wds", "--wds_streaming", "true"],
    ["--dataset", "imagenet", "--loader_backend", "grain"],
    ["--dataset", "imagenet", "--loader_processes", "2"],
], ids=["dataset_imagenet", "dataset_wds", "wds_streaming",
        "loader_backend_grain", "loader_processes_2"])
def test_train_vit_reads_real_data(flags, data, tmp_path, capsys):
    """``train_vit`` trains an epoch on each dataset and evaluates on its
    validation stream."""
    from vit_tpu_torch.train_vit import main

    if "grain" in flags:
        pytest.importorskip("grain.python")
    where = (["--wds_shards", str(data / "wds" / "s-*.tar")]
             if flags[1] == "wds" else ["--data_dir",
                                        str(data / "imagenet")])
    with tiny_preset():
        logs = main([*VIT, *flags, *where, *dirs(tmp_path)])
    assert [r["i"] for r in logs["train"]] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in logs["train"])
    assert len(logs["valid"]) == 1 and np.isfinite(logs["valid"][0]["loss"])
    assert "DECODER: " in capsys.readouterr().out


def test_train_vit_wds_needs_shards():
    from vit_tpu_torch.train_vit import check_ported, parse_args

    with pytest.raises(NotImplementedError, match="--wds_shards"):
        check_ported(parse_args(["--dataset", "wds"]))


def test_train_videogpt_trains_on_dmlab_clips(data, tmp_path, monkeypatch):
    """``train_videogpt --dataset dmlab`` (its default): the first clip the
    step gets is the numpy batch of the same fixture, bit for bit: the
    first ``bs`` clips of ``default_rng(0)``'s shuffle, cut at the offset
    of ``default_rng((seed, 0xC407, 0))`` to ``max_frames``, divided by
    255 in float32."""
    from vit_tpu_torch import train_videogpt
    from vit_tpu_torch.data.video import DmlabDataset

    seen = []
    make = train_videogpt.make_videogpt_train_step

    def spy(model):
        step = make(model)

        def run(state, tokenizer, videos, generator=None):
            seen.append(videos.clone())
            return step(state, tokenizer, videos, generator)
        return run

    monkeypatch.setattr(train_videogpt, "make_videogpt_train_step", spy)
    with tiny_preset():
        state = train_videogpt.main([*GPT, "--data_dir",
                                     str(data / "dmlab16"), *dirs(tmp_path)])
    assert int(state.step) == len(seen) == 2    # 5 clips, bs 2, drop_last
    paths = DmlabDataset(str(data / "dmlab16")).video_paths
    order = np.arange(len(paths))
    np.random.default_rng(0).shuffle(order)
    videos = np.stack([np.load(paths[i])["video"] for i in order[:2]])
    offset = int(np.random.default_rng((0, 0xC407, 0)).integers(
        0, CLIP_FRAMES - 4))
    want = videos[:, offset:offset + 4].astype(np.float32) / 255.0
    assert seen[0].dtype == torch.float32
    assert np.array_equal(seen[0].numpy(), want)


@pytest.mark.parametrize("entry, flags", [
    ("train_videogpt", []),
    ("train_titok", ["--dataset", "dmlab", "--image_size", "64"]),
    ("train_titok", ["--dataset", "imagenet"]),
    ("train_vit", []),
], ids=["videogpt_default", "titok_dmlab", "titok_imagenet", "vit_default"])
def test_entry_without_data_dir_refuses_and_reads_nothing(
        entry, flags, tmp_path, monkeypatch):
    """Without --data_dir an entry refuses, naming the flag, before it
    builds or writes anything; it reads no dataset beside its working
    directory (the reference scripts' ``../teco/...`` default) either."""
    import importlib
    from pathlib import Path

    clips(tmp_path / "teco" / "dmlab" / "train", 16, count=1)
    (tmp_path / "work").mkdir()
    monkeypatch.chdir(tmp_path / "work")
    listed = []
    iterdir = Path.iterdir
    monkeypatch.setattr(Path, "iterdir",
                        lambda self: listed.append(self) or iterdir(self))
    main = importlib.import_module(f"vit_tpu_torch.{entry}").main
    with pytest.raises(ValueError, match="--data_dir"):
        main([*flags, "--device", "cpu", *dirs(tmp_path)])
    assert listed == [] and not (tmp_path / "ckpt").exists()
    assert not (tmp_path / "runs").exists()


# -- refusals name the missing package ----------------------------------------

def no_native(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    monkeypatch.setattr(native, "build_error", "blocked by the test")


@pytest.mark.parametrize("entry, flags, blocked, named", [
    ("train_titok", ["--dataset", "minecraft"], ["cv2"], "cv2"),
    ("train_titok", ["--dataset", "imagenet"], ["PIL", "native"], "PIL"),
    ("train_titok", ["--dataset", "imagenet", "--loader_backend", "grain"],
     ["grain", "grain.python"], "grain"),
    ("train_vit", ["--dataset", "wds", "--wds_shards", "x"], ["PIL"], "PIL"),
    ("train_vit", ["--dataset", "wds", "--wds_shards", "x",
                   "--wds_streaming", "true"], ["PIL", "native"], "PIL"),
    ("train_vit", ["--dataset", "imagenet", "--loader_backend", "grain"],
     ["grain", "grain.python"], "grain"),
], ids=["titok_minecraft", "titok_imagenet", "titok_grain", "vit_wds",
        "vit_wds_streaming", "vit_grain"])
def test_refusal_names_the_missing_package(entry, flags, blocked, named,
                                           monkeypatch, tmp_path):
    """With the package's import blocked, the entry refuses before anything
    is built or written, naming the package; DMLab needs none."""
    import importlib
    import sys

    main = importlib.import_module(f"vit_tpu_torch.{entry}").main
    for module in blocked:
        if module == "native":
            no_native(monkeypatch)
        else:
            monkeypatch.setitem(sys.modules, module, None)
    with pytest.raises(NotImplementedError, match=named):
        main([*flags, "--device", "cpu", *dirs(tmp_path)])
    assert not (tmp_path / "ckpt").exists()
    from vit_tpu_torch.data import decoders

    assert decoders.missing("dmlab") == ""
    assert decoders.found()[blocked[0].split(".")[0]] is False


# -- K5 at any latent width ---------------------------------------------------

def test_latent_dim_6_is_accepted_and_widths_out_of_reach_refused(
        tmp_path, capsys):
    """``--latent_dim 6`` passes the entry's card check and trains on the
    CPU; a width above K5's ``MAX_DIM`` is refused on the card (not on the
    CPU), naming ROADMAP Queue C #4."""
    from vit_tpu_torch.train_titok import check_ported, main, parse_args

    check_ported(parse_args(["--latent_dim", "6", "--dataset", "synthetic"]))
    with pytest.raises(NotImplementedError, match="Queue C #4"):
        check_ported(parse_args(["--latent_dim", str(k_vq.MAX_DIM + 1),
                                 "--dataset", "synthetic"]))
    check_ported(parse_args(["--latent_dim", str(k_vq.MAX_DIM + 1),
                             "--dataset", "synthetic", "--device", "cpu"]))
    assert k_vq.out_of_reach(6) == "" and "no such limit" in \
        k_vq.out_of_reach(k_vq.MAX_DIM + 1)
    with tiny_preset():
        main([*TITOK, "--dataset", "synthetic", "--image_size", "16",
              "--bs", "2", "--latent_dim", "6", "--steps_per_epoch", "1",
              *dirs(tmp_path)])
    assert len(step_lines(capsys.readouterr().out)) == 1


@pytest.mark.parametrize("d", [5, 6, 24, 64, 101, 159, 160, 200, 1024])
@pytest.mark.parametrize("n, c", [(16384, 2048), (16384, 16384), (333, 500)])
def test_runtime_dim_plan_covers_every_code_once(d, n, c):
    """K5's plan for the runtime-D form on 132 SMs: 64 rows a block, 8 a
    thread; every code in exactly one slice, none empty, each slice whole
    tiles of 128 codes (the source's cut of ``splits``), about four blocks
    an SM where the rows alone give fewer, and no dynamic shared memory."""
    p = k_vq.plan(n, c, d, 132)
    assert p["rows_per_lane"] == k_vq.rows_per_lane(d) == 8
    assert p["rows_per_block"] == k_vq.rows_per_block(d) == 64
    assert (p["row_blocks"] - 1) * p["rows_per_block"] < n <= \
        p["row_blocks"] * p["rows_per_block"]
    slices = [range(s * p["slice"], min(c, (s + 1) * p["slice"]))
              for s in range(p["splits"])]
    assert all(len(r) > 0 for r in slices)
    assert [i for r in slices for i in r] == list(range(c))
    tiles = -(-c // 128)
    assert k_vq.ANY_CODES == 128
    assert p["slice"] == -(-tiles // p["splits"]) * 128
    assert p["splits"] <= min(tiles, max(1, -(-4 * 132 // p["row_blocks"])))
    assert p["blocks"] >= min(4 * 132, p["row_blocks"] * tiles) // 2
    assert p["smem_bytes"] == 0


@pytest.mark.parametrize("d", [6, 24])
@pytest.mark.parametrize("l2", [True, False])
def test_plain_nearest_code_matches_xla_at_odd_widths(d, l2):
    """The plain version (the CPU path, and the card's reference) against
    ``nearest_code_xla`` at D 6 and 24, codes index for index."""
    rng = np.random.default_rng(d)
    z = rng.standard_normal((300, d)).astype(np.float32)
    cb = rng.standard_normal((77, d)).astype(np.float32)
    want = np.asarray(nearest_code_xla(jnp.asarray(z), jnp.asarray(cb),
                                       l2_normalize=l2))
    got = k_vq.nearest_code(torch.from_numpy(z).reshape(3, 100, d),
                            torch.from_numpy(cb), l2_normalize=l2)
    assert got.dtype == torch.int32 and got.shape == (3, 100)
    assert np.array_equal(got.reshape(-1).numpy(), want)


def test_port_imports_no_decoder_at_import():
    """Every port module imports without Pillow, OpenCV or Grain loaded
    (the card's machine may lack them): the data modules import them where
    an image or video is decoded, or a Grain loader iterates."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import importlib, pkgutil, sys\n"
        "import vit_tpu_torch\n"
        "for m in pkgutil.walk_packages(vit_tpu_torch.__path__, "
        "'vit_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('PIL', 'cv2', 'grain'))\n"
        "assert not bad, bad\n"
        "assert 'vit_tpu_torch.data.wds' in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code],
                          cwd=Path(__file__).resolve().parents[1],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
