"""Port parity for the decoding data layer, on images and videos the tests
encode themselves: ``vit_tpu_torch/data/transforms.py`` and
``data/imagenet.py`` (Pillow), ``data/native.py`` (the libjpeg pipeline
built from ``native/image_pipeline.cc`` into ``build/``), the ``jpg``
payloads of ``data/wds.py``, ``data/grain_loader.py`` (Grain) and
``data/video.py``'s OpenCV readers, each against its ``vit_tpu/data``
original, bit for bit."""

import io

import numpy as np
import pytest

pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

from vit_tpu.data import imagenet as jax_imagenet  # noqa: E402
from vit_tpu.data import native as jax_native  # noqa: E402
from vit_tpu.data import transforms as jax_transforms  # noqa: E402
from vit_tpu.data import video as jax_video  # noqa: E402
from vit_tpu.data import wds as jax_wds  # noqa: E402
from vit_tpu.data.grain_loader import GrainDataLoader as JaxGrain  # noqa: E402
from vit_tpu_torch.data import imagenet, native, transforms, video, wds  # noqa: E402
from vit_tpu_torch.data.grain_loader import GrainDataLoader, make_loader  # noqa: E402

SIZES = ((40, 30), (24, 50), (32, 32), (33, 47))


def jpeg_bytes(rng, w: int, h: int) -> bytes:
    img = Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="JPEG", quality=90)
    return buf.getvalue()


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """``<root>/{train,val}/<class>/<img>.JPEG``: three classes, eight
    train and four val images of mixed sizes and aspect ratios."""
    root = tmp_path_factory.mktemp("imagenet")
    rng = np.random.default_rng(5)
    for split, n in (("train", 8), ("val", 4)):
        for i in range(n):
            d = root / split / f"n{i % 3:03d}"
            d.mkdir(parents=True, exist_ok=True)
            w, h = SIZES[i % len(SIZES)]
            (d / f"img{i}.JPEG").write_bytes(jpeg_bytes(rng, w, h))
    return root


def test_transforms_match_jax(folders):
    """Resize of the shorter side, crops, flip and normalisation on every
    training image, bit for bit, from the same generator state."""
    for path in sorted((folders / "train").rglob("*.JPEG")):
        img = Image.open(path)
        for size in (16, 24):
            got = transforms.train_transform(img, size,
                                             np.random.default_rng(3))
            want = jax_transforms.train_transform(img, size,
                                                  np.random.default_rng(3))
            assert got.shape == (size, size, 3) and np.array_equal(got, want)
            assert np.array_equal(transforms.eval_transform(img, size),
                                  jax_transforms.eval_transform(img, size))
        assert transforms.resize_shorter(img, 20).size == \
            jax_transforms.resize_shorter(img, 20).size


def test_image_folder_matches_jax(folders):
    """``ImageFolderDataset``'s samples and labels, its eval items and, with
    ``np.random.seed`` set before each side and the items read in order,
    its training items (which mix a global draw into their seed)."""
    for train in (False, True):
        port = imagenet.ImageFolderDataset(folders / "train", 16, train=train)
        ref = jax_imagenet.ImageFolderDataset(folders / "train", 16,
                                              train=train)
        assert port.samples == ref.samples and port.class_to_idx == \
            ref.class_to_idx
        items = []
        for ds in (port, ref):
            np.random.seed(77)
            items.append([ds[i] for i in range(len(ds))])
        for (g, gl), (w, wl) in zip(*items):
            assert g.dtype == np.float32 and np.array_equal(g, w)
            assert gl == wl and gl.dtype == np.int32


@pytest.mark.skipif(not native.is_available(),
                    reason="the native pipeline did not build here")
def test_native_decode_batch_matches_jax(folders):
    """The port's build of ``native/image_pipeline.cc`` (in ``build/``, not
    the JAX package's library) against JAX's ``decode_batch``, train and
    eval, bit for bit."""
    assert str(native.library_path()).startswith(str(native.BUILD_DIR))
    assert "libvit_tpu_data" not in native._lib._name.split("/")[-1]
    jpegs = [p.read_bytes() for p in sorted(folders.rglob("*.JPEG"))]
    for train, seed in ((True, 11), (False, 0)):
        got = native.decode_batch(jpegs, 16, train=train, seed=seed,
                                  num_threads=3)
        want = jax_native.decode_batch(jpegs, 16, train=train, seed=seed,
                                       num_threads=3)
        assert got.shape == (12, 16, 16, 3) and np.array_equal(got, want)
    with pytest.raises(IOError, match="JPEG decodes failed"):
        native.decode_batch([b"not a jpeg"], 16)


@pytest.mark.parametrize("use_native", ["never", "auto"])
def test_imagenet_loaders_match_jax(folders, use_native):
    """``get_imagenet_loaders`` on both packages: the validation stream bit
    for bit, and a training epoch with ``np.random.seed`` set before each
    side (the native collate draws its seed in the one producer thread)."""
    if use_native == "auto" and not native.is_available():
        pytest.skip("the native pipeline did not build here")

    def run(mod):
        train, valid = mod.get_imagenet_loaders(
            16, 2, data_dir=str(folders), num_workers=1 if
            use_native == "never" else 2, use_native=use_native)
        np.random.seed(21)
        return [list(train), list(valid)]

    for got, want in zip(run(imagenet), run(jax_imagenet)):
        assert len(got) == len(want) > 0
        for (g, gl), (w, wl) in zip(got, want):
            assert np.array_equal(g, w) and np.array_equal(gl, wl)


def test_jpeg_shards_match_jax(tmp_path):
    """``jpg``/``png`` payloads encode and decode through Pillow as in the
    JAX package; ``WdsImageClassification`` and the streaming loader
    (Pillow and native) give JAX's batches."""
    rng = np.random.default_rng(2)
    items = [{"__key__": f"k{i:04d}",
              "jpg": rng.integers(0, 256, (20 + i, 28, 3), np.uint8),
              "png": rng.integers(0, 256, (8, 8, 3), np.uint8),
              "cls": i % 4} for i in range(6)]
    with wds.ShardWriter(str(tmp_path / "p-%03d.tar"), maxcount=4) as w:
        for s in items:
            w.write(s)
    with jax_wds.ShardWriter(str(tmp_path / "j-%03d.tar"), maxcount=4) as w:
        for s in items:
            w.write(s)
    for a, b in zip(*(sorted(tmp_path.glob(f"{p}-*.tar")) for p in "pj")):
        assert a.read_bytes() == b.read_bytes()
    shards = sorted(str(p) for p in tmp_path.glob("p-*.tar"))
    got = [s for p in shards for s in wds.iterate_shard(p)]
    want = [s for p in shards for s in jax_wds.iterate_shard(p)]
    for g, w_ in zip(got, want):
        assert np.array_equal(np.asarray(g["jpg"]), np.asarray(w_["jpg"]))
        assert np.array_equal(np.asarray(g["png"]), items[int(
            g["__key__"][1:])]["png"])
    for train in (True, False):
        port = wds.WdsImageClassification(shards, 16, train=train, seed=1)
        ref = jax_wds.WdsImageClassification(shards, 16, train=train, seed=1)
        for i in range(len(port)):
            assert np.array_equal(port[i][0], ref[i][0])
            assert port[i][1] == ref[i][1]
    for use_native in ([False, True] if native.is_available() else [False]):
        for train in (True, False):
            args = (shards, 16, 2)
            kw = dict(train=train, seed=3, shuffle_buffer=3, workers=1,
                      native=use_native)
            g = list(wds.streaming_image_loader(*args, **kw))
            w_ = list(jax_wds.streaming_image_loader(*args, **kw))
            assert len(g) == len(w_) == 3
            for (gi, gl), (wi, wl) in zip(g, w_):
                assert np.array_equal(gi, wi) and np.array_equal(gl, wl)


class Items:
    def __init__(self, n: int):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i: int):
        return np.arange(4, dtype=np.float32) + i, np.int32(i)


@pytest.mark.parametrize("kw", [
    dict(shuffle=True, seed=3), dict(shuffle=False, drop_last=False),
    dict(shuffle=True, seed=1, shard_id=1, num_shards=2)],
    ids=["shuffle", "in_order", "shard_1_of_2"])
def test_grain_loader_matches_jax(kw):
    """``GrainDataLoader`` (in-process reader threads) against JAX's, two
    epochs batch for batch, and ``make_loader``'s two backends."""
    pytest.importorskip("grain.python")
    port = GrainDataLoader(Items(21), 4, num_workers=2, **kw)
    ref = JaxGrain(Items(21), 4, num_workers=2, **kw)
    assert len(port) == len(ref)
    for _ in range(2):
        got, want = list(port), list(ref)
        assert len(got) == len(want) > 0
        for (g, gl), (w, wl) in zip(got, want):
            assert np.array_equal(g, w) and np.array_equal(gl, wl)
    assert isinstance(make_loader(Items(4), 2, backend="grain"),
                      GrainDataLoader)
    assert type(make_loader(Items(4), 2, processes=2)).__name__ == "DataLoader"
    with pytest.raises(ValueError, match="unknown loader backend"):
        make_loader(Items(4), 2, backend="torch")


def test_cv2_video_readers_match_jax(tmp_path):
    """``_read_video_cv2`` on an ``.avi`` (MJPG) and an ``.mp4`` the test
    writes, ``MinecraftDataset`` (the ``.mp4`` files, dummy actions) and
    ``UCF101Dataset`` (the ``.avi`` files, labels from folders) against the
    JAX package's, frame for frame; and ``get_minecraft_image_loaders``'
    length."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(8)
    for folder in ("walk", "jump"):
        (tmp_path / folder).mkdir()
        for name, fourcc in (("v0.avi", "MJPG"), ("v1.mp4", "mp4v")):
            out = cv2.VideoWriter(str(tmp_path / folder / name),
                                  cv2.VideoWriter_fourcc(*fourcc), 10,
                                  (24, 16))
            for _ in range(6):
                out.write(rng.integers(0, 256, (16, 24, 3), np.uint8))
            out.release()
    clip = video._read_video_cv2(tmp_path / "walk" / "v0.avi")
    assert clip.shape == (6, 16, 24, 3) and clip.dtype == np.uint8
    assert np.array_equal(clip, jax_video._read_video_cv2(
        tmp_path / "walk" / "v0.avi"))
    assert video._read_video_cv2(tmp_path / "walk" / "v1.mp4",
                                 max_frames=4).shape[0] == 4
    with pytest.raises(IOError, match="no frames"):
        (tmp_path / "bad.avi").write_bytes(b"x")
        video._read_video_cv2(tmp_path / "bad.avi")
    for port, ref in ((video.MinecraftDataset(str(tmp_path)),
                       jax_video.MinecraftDataset(str(tmp_path))),
                      (video.UCF101Dataset(str(tmp_path)),
                       jax_video.UCF101Dataset(str(tmp_path)))):
        assert len(port) == len(ref) == 2
        for i in range(2):
            (g, gl), (w, wl) = port[i], ref[i]
            assert np.array_equal(g, w) and np.array_equal(gl, wl)
    loader, _ = video.get_minecraft_image_loaders(16, str(tmp_path))
    ref_loader, _ = jax_video.get_minecraft_image_loaders(16, str(tmp_path))
    assert len(loader) == len(ref_loader) == 1000
    frames, _ = next(iter(loader))
    assert frames.shape == (16, 16, 24, 3) and frames.dtype == np.float32
