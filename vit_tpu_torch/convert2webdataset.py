"""Offline dataset → WebDataset tar shards (counterpart of
``convert2webdataset.py``). Runs on the host; no device.

  python -m vit_tpu_torch.convert2webdataset --dataset imagenet \\
      --data_dir <folder ImageNet> --output_dir <dir>
      folder layout (``<split>/<class>/<image>``) → ``jpg`` + ``cls``
      shards ``imagenet-{train,val}-%06d.tar``, a missing split skipped
  python -m vit_tpu_torch.convert2webdataset --dataset dmlab|minecraft|ucf \\
      --mode video --data_dir <clips> --output_dir <dir>
      clips of ``--stack_frames`` frames, every ``--keep_every``-th, as
      ``sequence.npy`` shards ``<dataset>-{train,val}-%06d.tar``; a video
      whose index ends in 9 goes to val (a 90/10 split)
  ... --mode image
      the same clips as strips of frames side by side, one ``jpg`` each,
      in ``<dataset>-frames-%06d.tar``

Shards go through ``data/wds.py:ShardWriter``, the videos come from
``data/video.py``'s dataset classes, and the keys, payloads and printed
counts are the JAX script's.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from vit_tpu_torch.data.wds import ShardWriter


def get_video_dataset(args):
    from vit_tpu_torch.data.video import (DmlabDataset, MinecraftDataset,
                                          UCF101Dataset)

    if args.dataset == "dmlab":
        return DmlabDataset(args.data_dir)
    if args.dataset == "minecraft":
        return MinecraftDataset(args.data_dir)
    if args.dataset == "ucf":
        return UCF101Dataset(args.data_dir)
    raise ValueError(args.dataset)


def convert_imagenet(args) -> None:
    """Folder ImageNet → ``jpg`` + ``cls`` shards, split by split; classes
    are indexed in sorted order."""
    from PIL import Image

    for split in ("train", "val"):
        root = Path(args.data_dir) / split
        if not root.is_dir():
            print(f"skip {split}: {root} not found")
            continue
        classes = sorted(d.name for d in root.iterdir() if d.is_dir())
        cls_idx = {c: i for i, c in enumerate(classes)}
        pattern = str(Path(args.output_dir) / f"imagenet-{split}-%06d.tar")
        maxcount = (args.max_train_samples_per_shard if split == "train"
                    else args.max_val_samples_per_shard)
        with ShardWriter(pattern, maxcount=maxcount) as writer:
            i = 0
            for c in classes:
                for f in sorted((root / c).iterdir()):
                    img = Image.open(f).convert("RGB")
                    writer.write({"__key__": "%08d" % i, "jpg": img,
                                  "cls": cls_idx[c]})
                    i += 1
        print(f"wrote {i} {split} examples")


def clips(video: np.ndarray, args):
    """(start, clip) of every whole clip of ``stack_frames`` frames, taking
    every ``keep_every``-th frame, the clips back to back."""
    span = args.stack_frames * args.keep_every
    for start in range(0, video.shape[0] - span + 1, span):
        yield start, video[start:start + span:args.keep_every]


def _label(label) -> int:
    return int(label) if np.ndim(label) == 0 else 0


def convert_video_dataset_to_video_wds(args) -> None:
    """Clips → ``sequence.npy`` shards, 90/10 by video index."""
    dataset = get_video_dataset(args)
    out = Path(args.output_dir)
    train_w = ShardWriter(str(out / f"{args.dataset}-train-%06d.tar"),
                          maxcount=args.max_train_samples_per_shard)
    val_w = ShardWriter(str(out / f"{args.dataset}-val-%06d.tar"),
                        maxcount=args.max_val_samples_per_shard)
    n_train = n_val = 0
    for video_i in range(len(dataset)):
        video, label = dataset[video_i]
        for start, clip in clips(np.asarray(video), args):
            sample = {"__key__": f"{video_i:06d}_{start:06d}",
                      "sequence.npy": clip, "cls": _label(label)}
            if video_i % 10 == 9:
                val_w.write(sample)
                n_val += 1
            else:
                train_w.write(sample)
                n_train += 1
    train_w.close()
    val_w.close()
    print(f"wrote {n_train} train / {n_val} val clips")


def convert_video_dataset_to_image_wds(args) -> None:
    """Clips → one ``jpg`` a clip, its frames side by side."""
    dataset = get_video_dataset(args)
    out = Path(args.output_dir)
    with ShardWriter(str(out / f"{args.dataset}-frames-%06d.tar"),
                     maxcount=args.max_train_samples_per_shard) as writer:
        n = 0
        for video_i in range(len(dataset)):
            video, label = dataset[video_i]
            for start, clip in clips(np.asarray(video), args):
                strip = np.concatenate(list(clip), axis=1)
                writer.write({"__key__": f"{video_i:06d}_{start:06d}",
                              "jpg": strip.astype(np.uint8),
                              "cls": _label(label)})
                n += 1
    print(f"wrote {n} frame strips")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dataset", type=str, required=True,
                        choices=["imagenet", "dmlab", "minecraft", "ucf"])
    parser.add_argument("--mode", type=str, default="video",
                        choices=["video", "image"])
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--stack_frames", type=int, default=32)
    parser.add_argument("--keep_every", type=int, default=1)
    parser.add_argument("--max_train_samples_per_shard", type=int,
                        default=10000)
    parser.add_argument("--max_val_samples_per_shard", type=int,
                        default=10000)
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    Path(args.output_dir).mkdir(parents=True, exist_ok=True)
    if args.dataset == "imagenet":
        convert_imagenet(args)
    elif args.mode == "video":
        convert_video_dataset_to_video_wds(args)
    else:
        convert_video_dataset_to_image_wds(args)


if __name__ == "__main__":
    main()
