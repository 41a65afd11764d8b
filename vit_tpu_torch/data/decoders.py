"""Which decoding packages this machine has, and what each data path needs.

The DMLab clips (``.npz``) and the ``npy``/``cls``/``json`` tar shards need
none. JPEGs need Pillow or the native libjpeg pipeline (``data/native.py``;
the ImageNet folders and streamed shards take whichever the choice rule
picks), the map-style webdataset view needs Pillow, the Minecraft videos
need OpenCV, and ``--loader_backend grain`` needs Grain. Nothing here is
imported until a function asks.
"""

from __future__ import annotations

import importlib


def have(module: str) -> bool:
    """Whether ``module`` imports here."""
    try:
        importlib.import_module(module)
    except Exception:   # ImportError, or a broken installation
        return False
    return True


def found() -> dict:
    """{"PIL", "cv2", "grain", "native"}: which of the decoders this
    machine has (``native``: whether the libjpeg pipeline builds)."""
    from vit_tpu_torch.data import native

    return {"PIL": have("PIL"), "cv2": have("cv2"),
            "grain": have("grain.python"), "native": native.is_available()}


def jpeg_decoder() -> str:
    """The decoder the JPEG paths take by the JAX package's rule: the
    native pipeline when its library builds, else Pillow; '' if neither."""
    from vit_tpu_torch.data import native

    if native.is_available():
        return "native libjpeg (data/native.py)"
    return "Pillow" if have("PIL") else ""


def missing(dataset: str, *, backend: str = "threads",
            streaming: bool = False) -> str:
    """Why this machine cannot read ``dataset`` with ``backend``, naming
    the package, or '' when it can."""
    if dataset == "imagenet" and backend == "grain" and not have(
            "grain.python"):
        return ("--loader_backend grain needs the grain package, which this "
                "machine lacks")
    if dataset == "minecraft" and not have("cv2"):
        return ("--dataset minecraft decodes its .mp4 videos with OpenCV, "
                "and this machine has no cv2 package")
    if dataset == "wds" and not streaming and not have("PIL"):
        return ("--dataset wds without --wds_streaming decodes its jpg "
                "payloads with Pillow, and this machine has no PIL package")
    if dataset == "imagenet" or (dataset == "wds" and streaming):
        if not jpeg_decoder():
            from vit_tpu_torch.data import native

            return (f"--dataset {dataset} decodes JPEGs with Pillow or the "
                    f"native libjpeg pipeline, and this machine has no PIL "
                    f"package and the pipeline did not build "
                    f"({native.build_error[:200]})")
    return ""
