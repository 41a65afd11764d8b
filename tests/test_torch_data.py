"""Port parity for the data layer that needs no image decoder:
``vit_tpu_torch/data/loader.py`` (the threaded ``DataLoader``),
``data/video.py``'s DMLab datasets and loaders and ``data/wds.py``'s tar
shards, each against its ``vit_tpu/data`` original on fixtures written to a
temporary directory: batch for batch, bit for bit."""

import io
import json
import tarfile

import numpy as np
import pytest

from vit_tpu.data import loader as jax_loader
from vit_tpu.data import video as jax_video
from vit_tpu.data import wds as jax_wds
from vit_tpu.data.resume import resume_stream as jax_resume_stream
from vit_tpu.data.resume import set_stream_epoch as jax_set_stream_epoch
from vit_tpu_torch.data import loader, video, wds
from vit_tpu_torch.data.resume import resume_stream, set_stream_epoch

CLIP_FRAMES, CLIP_SIZE = 30, 8


class Items:
    """A map-style dataset of (index-derived array, label) pairs."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i: int):
        return np.full((2, 3), i, np.float32) * 0.5, np.int32(i)


def batches(it) -> list:
    return [tuple(np.asarray(a) for a in b) for b in it]


def assert_same(got: list, want: list) -> None:
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.fixture(scope="module")
def dmlab(tmp_path_factory):
    """Seven clips in the ``<root>/<folder>/<video>.npz`` layout, across
    three folders (one of them holding a stray file loaders must skip as a
    folder)."""
    root = tmp_path_factory.mktemp("dmlab")
    rng = np.random.default_rng(11)
    for f, count in (("a", 3), ("b", 2), ("c", 2)):
        (root / f).mkdir()
        for v in range(count):
            np.savez(root / f / f"{v:03d}.npz",
                     video=rng.integers(0, 256, (CLIP_FRAMES, CLIP_SIZE,
                                                 CLIP_SIZE, 3), np.uint8),
                     actions=rng.integers(0, 9, (CLIP_FRAMES,)))
    (root / "notes.txt").write_text("not a folder of clips")
    return root


# -- the threaded DataLoader --------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(shuffle=True, seed=0),
    dict(shuffle=True, seed=5, drop_last=False),
    dict(shuffle=False, drop_last=False),
    dict(shuffle=True, seed=2, shard_id=1, num_shards=3),
    dict(shuffle=True, seed=2, shard_id=0, num_shards=2, drop_last=False,
         num_workers=1, prefetch=1),
], ids=["shuffle", "keep_last", "in_order", "shard_1_of_3", "one_worker"])
def test_dataloader_matches_jax(kw):
    """Three epochs of the port's ``DataLoader`` and JAX's, batch for batch
    (each epoch reshuffled by ``seed + epoch``), with their lengths."""
    ds = Items(23)
    port = loader.DataLoader(ds, 4, **kw)
    ref = jax_loader.DataLoader(ds, 4, **kw)
    assert len(port) == len(ref)
    for _ in range(3):
        assert_same(batches(port), batches(ref))


def test_dataloader_skip_and_resume_match_jax():
    """``_skip_next`` through ``resume_stream`` at epoch 2, batch 3, on
    both packages; and the resumed port stream equals the tail of the
    uninterrupted one."""
    ds = Items(30)
    whole = loader.DataLoader(ds, 4, seed=9)
    epochs = [batches(whole) for _ in range(3)]
    port = loader.DataLoader(ds, 4, seed=9)
    ref = jax_loader.DataLoader(ds, 4, seed=9)
    assert set_stream_epoch(port, 2) and jax_set_stream_epoch(ref, 2)
    got = batches(resume_stream(port, 3))
    assert_same(got, batches(jax_resume_stream(ref, 3)))
    assert_same(got, epochs[2][3:])
    assert port._epoch == 3 and port._skip_next == 0
    assert_same(batches(port), batches(ref))   # the next epoch in full


def test_default_collate_matches_jax():
    samples = [(np.arange(3) + i, None, np.float32(i)) for i in range(4)]
    got, want = loader.default_collate(samples), jax_loader.default_collate(
        samples)
    assert got[1] is None and want[1] is None
    for i in (0, 2):
        assert got[i].dtype == want[i].dtype and np.array_equal(got[i],
                                                                want[i])


# -- DMLab --------------------------------------------------------------------

def test_dmlab_dataset_matches_jax(dmlab):
    port, ref = video.DmlabDataset(str(dmlab)), jax_video.DmlabDataset(
        str(dmlab))
    assert port.video_paths == ref.video_paths and len(port) == 7
    for i in range(len(port)):
        (pv, pa), (rv, ra) = port[i], ref[i]
        assert pv.dtype == np.uint8 and np.array_equal(pv, rv)
        assert np.array_equal(pa, ra)


def test_dmlab_missing_dir_raises_as_jax(tmp_path):
    for mod in (video, jax_video):
        with pytest.raises(ValueError, match="--data_dir"):
            mod.DmlabDataset(None)
        with pytest.raises(FileNotFoundError, match="DMLab"):
            mod.DmlabDataset(str(tmp_path / "nowhere"))


def test_dmlab_video_loader_matches_jax(dmlab):
    """``get_dmlab_video_loaders`` (8 threads, shuffled) against JAX's for
    two epochs, bit for bit: whole uint8 clips and their actions."""
    port, _ = video.get_dmlab_video_loaders(2, str(dmlab))
    ref, _ = jax_video.get_dmlab_video_loaders(2, str(dmlab))
    assert len(port) == len(ref) == 3
    for _ in range(2):
        got = batches(port)
        assert_same(got, batches(ref))
        assert got[0][0].shape == (2, CLIP_FRAMES, CLIP_SIZE, CLIP_SIZE, 3)


def test_dmlab_video_loader_resumes_mid_epoch(dmlab):
    """Epoch 1 resumed at batch 1 equals the uninterrupted run's epoch 1
    from batch 1, in both packages."""
    whole, _ = video.get_dmlab_video_loaders(2, str(dmlab))
    want = [batches(whole) for _ in range(2)][1][1:]
    for get, set_epoch, resume in (
            (video.get_dmlab_video_loaders, set_stream_epoch, resume_stream),
            (jax_video.get_dmlab_video_loaders, jax_set_stream_epoch,
             jax_resume_stream)):
        resumed, _ = get(2, str(dmlab))
        set_epoch(resumed, 1)
        assert_same(batches(resume(resumed, 1)), want)


def test_images_from_video_match_jax_at_one_worker(dmlab):
    """``ImagesFromVideoDataset`` mixes a global ``np.random`` draw into each
    item's seed, so its frames follow the draws' order: read by one
    worker in the loader's first-epoch order, with ``np.random.seed`` set
    before each side, the port's batches (``frames_collate`` over bs / 8
    clips × 8 frames) equal JAX's, bit for bit, float32 in [0, 1]."""
    order, _ = loader.DataLoader(range(7000), 2)._indices()

    def stream(mod):
        ds = mod.ImagesFromVideoDataset(mod.DmlabDataset(str(dmlab)))
        np.random.seed(1234)
        return [mod.frames_collate([ds[int(i)] for i in order[b:b + 2]])
                for b in (0, 2, 4)]

    got, want = stream(video), stream(jax_video)
    for (g, gn), (w, wn) in zip(got, want):
        assert gn is None and wn is None
        assert g.shape == (16, CLIP_SIZE, CLIP_SIZE, 3)
        assert g.dtype == np.float32 and np.array_equal(g, w)
        assert 0.0 <= g.min() and g.max() <= 1.0


def test_dmlab_image_loader_frames_come_from_their_clips(dmlab):
    """``get_dmlab_image_loaders`` at its 8 threads: the loader's length is
    JAX's, and each item's 8 frames are frames of the clip its shuffled
    index names (``idx % videos``), divided by 255, bit for bit (which
    frames depends on the threads' global draws)."""
    port, _ = video.get_dmlab_image_loaders(16, str(dmlab))
    ref, _ = jax_video.get_dmlab_image_loaders(16, str(dmlab))
    assert len(port) == len(ref) == 7 * 1000 // 2
    clips = video.DmlabDataset(str(dmlab))
    order = np.arange(7 * 1000)
    np.random.default_rng(0).shuffle(order)
    frames, _ = next(iter(port))
    assert frames.shape == (16, CLIP_SIZE, CLIP_SIZE, 3)
    for b in range(2):
        clip = clips[int(order[b]) % 7][0].astype(np.float32) / 255.0
        for f in frames[8 * b:8 * b + 8]:
            assert any(np.array_equal(f, c) for c in clip)


def test_video_batch_generator_matches_jax(dmlab):
    got = video.video_batch_generator(video.DmlabDataset(str(dmlab)), 8,
                                      videos_per_batch=2, seed=4)
    want = jax_video.video_batch_generator(
        jax_video.DmlabDataset(str(dmlab)), 8, videos_per_batch=2, seed=4)
    for _ in range(3):
        (g, _), (w, _) = next(got), next(want)
        assert g.shape == (8, CLIP_SIZE, CLIP_SIZE, 3)
        assert g.dtype == np.float32 and np.array_equal(g, w)


def test_frames_collate_matches_jax():
    batch = [(np.random.default_rng(i).random((8, 4, 4, 3), np.float32),
              None) for i in range(3)]
    (g, _), (w, _) = video.frames_collate(batch), jax_video.frames_collate(
        batch)
    assert g.shape == (24, 4, 4, 3) and np.array_equal(g, w)


# -- tar shards ---------------------------------------------------------------

def samples(n: int, start: int = 0) -> list:
    rng = np.random.default_rng(start)
    return [{"__key__": f"s{start + i:05d}",
             "npy": rng.standard_normal((3, 2)).astype(np.float32),
             "cls": int(rng.integers(0, 10)),
             "json": {"i": start + i, "tag": ["x", start + i]},
             "txt": f"raw {start + i}".encode()} for i in range(n)]


def write(mod, tmp_path, name: str, items: list, maxcount: int) -> list:
    with mod.ShardWriter(str(tmp_path / f"{name}-%03d.tar"),
                         maxcount=maxcount) as w:
        for s in items:
            w.write(s)
    return w.paths


def members(path) -> list:
    with tarfile.open(path) as tar:
        return [(m.name, tar.extractfile(m).read()) for m in tar
                if m.isfile()]


@pytest.mark.parametrize("writer, reader", [("port", "jax"), ("jax", "port")])
def test_shards_cross_read(tmp_path, writer, reader):
    """Shards one package writes, the other reads: the same member names
    and bytes, the same decoded samples, raw bytes with ``decode=False``."""
    mods = {"port": wds, "jax": jax_wds}
    items = samples(7)
    paths = write(mods[writer], tmp_path, writer, items, 3)
    other = write(mods[reader], tmp_path, reader, items, 3)
    assert len(paths) == len(other) == 3
    for a, b in zip(paths, other):
        assert members(a) == members(b)
    got = [s for p in paths for s in mods[reader].iterate_shard(p)]
    assert [s["__key__"] for s in got] == [s["__key__"] for s in items]
    for g, s in zip(got, items):
        assert np.array_equal(g["npy"], s["npy"]) and g["npy"].dtype == np.float32
        assert g["cls"] == s["cls"] and g["json"] == s["json"]
        assert g["txt"] == s["txt"]
    raw = [s for p in paths for s in mods[reader].iterate_shard(p, decode=False)]
    assert raw[0]["cls"] == str(items[0]["cls"]).encode()
    assert json.loads(raw[0]["json"]) == items[0]["json"]
    assert np.array_equal(np.load(io.BytesIO(raw[0]["npy"])), items[0]["npy"])


def test_pth_and_multipart_extensions_match_jax(tmp_path):
    """``pth`` payloads (torch tensors) and multi-part extensions
    (``seq.npy``) encode and decode as in the JAX package."""
    item = {"__key__": "k0", "pth": np.arange(6, dtype=np.float32).reshape(2, 3),
            "seq.npy": np.arange(4, dtype=np.int64)}
    port = write(wds, tmp_path, "p", [item], 10)
    ref = write(jax_wds, tmp_path, "j", [item], 10)
    (g,), (w,) = (list(jax_wds.iterate_shard(port[0])),
                  list(wds.iterate_shard(ref[0])))
    for s in (g, w):
        assert np.array_equal(s["pth"], item["pth"])
        assert np.array_equal(s["seq.npy"], item["seq.npy"])


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("shards")
    return write(wds, tmp, "d", samples(23), 4)   # 6 shards, the last of 3


def keyed(sample):
    return np.asarray(sample["npy"]), np.int32(sample["cls"])


@pytest.mark.parametrize("kw", [
    dict(shuffle_buffer=5, seed=3), dict(shuffle_buffer=0),
    dict(shuffle_buffer=4, seed=1, shard_id=1, num_shards=2)],
    ids=["shuffled", "in_order", "shard_1_of_2"])
def test_streaming_order_and_split_match_jax(shards, kw):
    """``StreamingWebDataset`` at one worker (its order is then fixed):
    two epochs in JAX's order, each epoch's shard order from ``(seed,
    epoch)``; the shard split the same (the partial last shard dropped
    before an equal split), and ``StreamingBatcher`` batching it as JAX's."""
    port = wds.StreamingWebDataset(shards, workers=1, transform=keyed, **kw)
    ref = jax_wds.StreamingWebDataset(shards, workers=1, transform=keyed,
                                      **kw)
    assert port.shard_paths == ref.shard_paths
    if kw.get("num_shards"):
        assert port.shard_paths == sorted(shards)[:-1][1::2]
    pb = wds.StreamingBatcher(port, 3, drop_last=False)
    rb = jax_wds.StreamingBatcher(ref, 3, drop_last=False)
    for _ in range(2):
        assert_same(batches(pb), batches(rb))
    assert port._epoch == 2


def test_streaming_many_workers_cover_every_sample(shards):
    """At four workers the interleaving is not fixed, but each epoch holds
    every sample once, as iterate_shard reads them."""
    ds = wds.StreamingWebDataset(shards, workers=4, shuffle_buffer=6,
                                 transform=keyed)
    want = sorted(np.asarray(s["npy"]).tobytes() for p in shards
                  for s in jax_wds.iterate_shard(p))
    for _ in range(2):
        got = sorted(np.asarray(npy).tobytes() for npy, _ in ds)
        assert len(got) == 23 and got == want


def test_map_webdataset_matches_jax(shards):
    port, ref = wds.WebDataset(shards), jax_wds.WebDataset(shards)
    assert len(port) == len(ref) == 23
    for i in (0, 7, 22):
        assert port[i]["__key__"] == ref[i]["__key__"]
        assert np.array_equal(port[i]["npy"], ref[i]["npy"])


def test_too_few_shards_for_the_split_raises(shards):
    for mod in (wds, jax_wds):
        with pytest.raises(ValueError, match="hosts"):
            mod.StreamingWebDataset(shards[:2], num_shards=2)
