"""``python -m vit_tpu_torch.convert2webdataset`` against the JAX package's
``convert2webdataset.py`` on fixtures written here: a two-class ImageNet
folder of Pillow JPEGs (train in two shards, val in one), DMLab ``.npz``
clips in both modes, and UCF-101 ``.avi`` videos written by OpenCV (their
labels from the class folders). The shard names, the member names in order, ``cls``,
``sequence.npy`` (bit for bit, dtype too), the decoded JPEG pixels and the
printed counts must be the same."""

import contextlib
import importlib.util
import io
import sys
import tarfile
from pathlib import Path

import numpy as np
import pytest

from vit_tpu_torch.convert2webdataset import main as port_main
from vit_tpu_torch.data.video import DmlabDataset

ROOT = Path(__file__).resolve().parents[1]


def jax_main(argv):
    spec = importlib.util.spec_from_file_location(
        "jax_convert2webdataset", ROOT / "convert2webdataset.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["convert2webdataset.py", *argv])
        mod.main()


def run(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def members(path: Path) -> "list[tuple[str, bytes]]":
    with tarfile.open(path) as tar:
        return [(m.name, tar.extractfile(m).read()) for m in tar.getmembers()]


def decoded(name: str, data: bytes):
    from PIL import Image

    if name.endswith(".jpg"):
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    if name.endswith(".npy"):
        return np.load(io.BytesIO(data))
    return data


def assert_same_shards(a: Path, b: Path) -> int:
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir()) and names
    n = 0
    for name in names:
        ma, mb = members(a / name), members(b / name)
        assert [m for m, _ in ma] == [m for m, _ in mb], name
        for (m, da), (_, db) in zip(ma, mb):
            va, vb = decoded(m, da), decoded(m, db)
            if isinstance(va, np.ndarray):
                assert va.dtype == vb.dtype and np.array_equal(va, vb), m
            else:
                assert va == vb, m
            n += 1
    return n


@pytest.fixture(scope="module")
def imagenet(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("imagenet")
    rng = np.random.default_rng(0)
    for split, per_class in (("train", 3), ("val", 1)):
        for cls in ("n01", "n02"):
            d = root / split / cls
            d.mkdir(parents=True)
            for i in range(per_class):
                Image.fromarray(rng.integers(0, 256, (20, 24, 3), np.uint8)
                                ).save(d / f"img_{i}.JPEG")
    return root


@pytest.fixture(scope="module")
def dmlab(tmp_path_factory):
    root = tmp_path_factory.mktemp("dmlab")
    rng = np.random.default_rng(1)
    for v in range(11):   # video 9 goes to val
        d = root / f"folder_{v % 2}"
        d.mkdir(exist_ok=True)
        np.savez(d / f"{v:03d}.npz",
                 video=rng.integers(0, 256, (20, 16, 16, 3), np.uint8),
                 actions=rng.integers(0, 4, (20,)))
    return root


def test_imagenet_shards_match_jax(imagenet, tmp_path):
    argv = ["--dataset", "imagenet", "--data_dir", str(imagenet),
            "--max_train_samples_per_shard", "4"]
    out_j = run(jax_main, [*argv, "--output_dir", str(tmp_path / "jax")])
    out_t = run(port_main, [*argv, "--output_dir", str(tmp_path / "port")])
    assert out_t == out_j == "wrote 6 train examples\nwrote 2 val examples\n"
    assert assert_same_shards(tmp_path / "jax", tmp_path / "port") == 16
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == [
        "imagenet-train-000000.tar", "imagenet-train-000001.tar",
        "imagenet-val-000000.tar"]
    (first_cls, data), = [m for m in members(
        tmp_path / "port" / "imagenet-train-000001.tar")
        if m[0].endswith(".cls")][-1:]
    assert first_cls == "00000005.cls" and data == b"1"


def test_missing_split_is_skipped(imagenet, tmp_path):
    data = tmp_path / "only_val"
    data.mkdir()
    (data / "val").symlink_to(imagenet / "val")
    argv = ["--dataset", "imagenet", "--data_dir", str(data)]
    out_j = run(jax_main, [*argv, "--output_dir", str(tmp_path / "jax")])
    out_t = run(port_main, [*argv, "--output_dir", str(tmp_path / "port")])
    assert out_t == out_j and out_t.startswith("skip train:")
    assert assert_same_shards(tmp_path / "jax", tmp_path / "port") == 4


@pytest.mark.parametrize("mode, flags, counts", [
    ("video", ["--stack_frames", "4", "--keep_every", "2"],
     "wrote 20 train / 2 val clips\n"),
    ("video", ["--stack_frames", "6", "--max_train_samples_per_shard", "7",
               "--max_val_samples_per_shard", "1"],
     "wrote 30 train / 3 val clips\n"),
    ("image", ["--stack_frames", "3", "--keep_every", "3",
               "--max_train_samples_per_shard", "10"],
     "wrote 22 frame strips\n"),
])
def test_dmlab_shards_match_jax(dmlab, tmp_path, mode, flags, counts):
    argv = ["--dataset", "dmlab", "--mode", mode, "--data_dir", str(dmlab),
            *flags]
    out_j = run(jax_main, [*argv, "--output_dir", str(tmp_path / "jax")])
    out_t = run(port_main, [*argv, "--output_dir", str(tmp_path / "port")])
    assert out_t == out_j == counts
    assert assert_same_shards(tmp_path / "jax", tmp_path / "port") > 0
    if mode == "video":
        got = dict(members(tmp_path / "port" / "dmlab-val-000000.tar"))
        clip = np.load(io.BytesIO(got["000009_000000.sequence.npy"]))
        # the dataset's ninth video, in its sorted folder-then-file order
        video = DmlabDataset(str(dmlab))[9][0]
        step = 2 if "--keep_every" in flags else 1
        np.testing.assert_array_equal(clip, video[0:clip.shape[0] * step:step])
        assert got["000009_000000.cls"] == b"0"


@pytest.fixture(scope="module")
def ucf(tmp_path_factory):
    cv2 = pytest.importorskip("cv2")
    root = tmp_path_factory.mktemp("ucf")
    rng = np.random.default_rng(2)
    for c, cls in enumerate(("ApplyEyeMakeup", "Basketball")):
        (root / cls).mkdir()
        for v in range(2):
            writer = cv2.VideoWriter(str(root / cls / f"v_{v}.avi"),
                                     cv2.VideoWriter_fourcc(*"MJPG"), 10,
                                     (16, 16))
            for _ in range(9 + 3 * c):
                writer.write(rng.integers(0, 256, (16, 16, 3), np.uint8))
            writer.release()
    return root


@pytest.mark.parametrize("mode", ["video", "image"])
def test_ucf_shards_match_jax(ucf, tmp_path, mode):
    argv = ["--dataset", "ucf", "--mode", mode, "--data_dir", str(ucf),
            "--stack_frames", "4"]
    out_j = run(jax_main, [*argv, "--output_dir", str(tmp_path / "jax")])
    out_t = run(port_main, [*argv, "--output_dir", str(tmp_path / "port")])
    assert out_t == out_j == ("wrote 10 train / 0 val clips\n"
                              if mode == "video" else "wrote 10 frame strips\n")
    assert assert_same_shards(tmp_path / "jax", tmp_path / "port") == 20
    name = "ucf-train-000000.tar" if mode == "video" else \
        "ucf-frames-000000.tar"
    cls = [d for m, d in members(tmp_path / "port" / name)
           if m.endswith(".cls")]
    assert cls == [b"0"] * 4 + [b"1"] * 6
