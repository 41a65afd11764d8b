"""The port's serving path on the CPU: export → load → HTTP server, against
direct model calls, plus the import boundary (no jax in vit_tpu_torch)."""

import io
import json
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_port_helpers import (configs, images, jax_params, port_model,
                                tiny_preset)
from vit_tpu_torch.kernels import attention as k_attn
from vit_tpu_torch.kernels import vq as k_vq
from vit_tpu_torch.serve import server as srv_mod
from vit_tpu_torch.serve.export import export_tokenizer, load_exported


def _post(url, arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return np.load(io.BytesIO(resp.read()))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A tiny TiTok exported at bs 4 and served on the CPU with a 300 ms
    micro-batching window; Batcher instances are recorded."""
    out = tmp_path_factory.mktemp("export")
    batchers = []

    class RecordingBatcher(srv_mod.Batcher):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            batchers.append(self)

    with tiny_preset(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(srv_mod, "Batcher", RecordingBatcher)
        cfg_j, cfg_t = configs("float32")
        model = port_model(cfg_t, jax_params(cfg_j))
        export_tokenizer(model, str(out), bs=4)
        httpd = srv_mod.make_server(str(out), port=0, batch_window_ms=300,
                                    device="cpu")
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            yield model, out, url, batchers
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=10)


def test_export_manifest_and_load(served):
    model, out, url, _ = served
    manifest = json.loads((out / "manifest.json").read_text())
    assert manifest["config"]["transformer"] == "tiny"
    assert manifest["bs"] == 4 and manifest["n_tokens"] == 8
    with urllib.request.urlopen(url + "/manifest", timeout=30) as resp:
        assert json.loads(resp.read()) == manifest
    with tiny_preset():
        loaded = load_exported(str(out), "cpu")
    assert loaded["_in_avals"] == {"encode": [((4, 32, 32, 3), "float32")],
                                   "decode": [((4, 8), "int32")]}
    x = images(2, seed=7)
    np.testing.assert_array_equal(loaded["encode"](x).numpy(),
                                  model.encode(torch.from_numpy(x)).numpy())


def test_http_encode_decode_match_model(served):
    model, _, url, _ = served
    x = images(3, seed=8)
    idx = _post(url + "/encode", x)
    assert idx.dtype == np.int32 and idx.shape == (3, 8)
    np.testing.assert_array_equal(idx, model.encode(torch.from_numpy(x)).numpy())
    rec = _post(url + "/decode", idx)
    assert rec.dtype == np.float32 and rec.shape == (3, 32, 32, 3)
    np.testing.assert_allclose(
        rec, model.decode_indices(torch.from_numpy(idx)).numpy(), atol=1e-6,
        rtol=0)
    assert k_attn.launches == 0 and k_vq.launches == 0  # CPU: plain versions


def test_concurrent_requests_coalesce(served):
    model, _, url, batchers = served
    before = sum(b.calls for b in batchers)
    xs = [images(1, seed=20 + i) for i in range(4)]
    outs = [None] * 4

    def go(i):
        outs[i] = _post(url + "/encode", xs[i])

    threads = [threading.Thread(target=go, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    # 4 one-row requests inside one window: fewer device calls than requests
    assert sum(b.calls for b in batchers) - before < 4
    for x, out in zip(xs, outs):
        np.testing.assert_array_equal(
            out, model.encode(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("path, arr", [
    ("/encode", np.zeros((1, 16, 16, 3), np.float32)),   # wrong image size
    ("/encode", np.zeros((1, 32, 32, 3), np.float64)),   # wrong dtype
    ("/encode", np.zeros((5, 32, 32, 3), np.float32)),   # batch above bs
    ("/decode", np.full((1, 8), 64, np.int32)),          # index out of range
])
def test_bad_request_is_400(served, path, arr):
    _, _, url, _ = served
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url + path, arr)
    assert e.value.code == 400


def test_port_never_imports_jax():
    root = Path(__file__).resolve().parents[1]
    code = (
        "import importlib, pkgutil, sys\n"
        "import vit_tpu_torch\n"
        "for m in pkgutil.walk_packages(vit_tpu_torch.__path__, "
        "'vit_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'flax', 'optax', 'orbax', 'vit_tpu'))\n"
        "assert not bad, bad\n"
        "entries = ('vit_tpu_torch.train_vit', 'vit_tpu_torch.bench_vpu', "
        "'vit_tpu_torch.bench_kernels', 'vit_tpu_torch.kernels.fma_probe', "
        "'vit_tpu_torch.utils.precision', 'vit_tpu_torch.train_titok', "
        "'vit_tpu_torch.train.loop', 'vit_tpu_torch.train_mae', "
        "'vit_tpu_torch.train_puzzle', 'vit_tpu_torch.train_vit_vqgan', "
        "'vit_tpu_torch.train_enhancing_vitvqgan', "
        "'vit_tpu_torch.train_llamagen_titok')\n"
        "assert all(e in sys.modules for e in entries), entries\n"
        "print(len([k for k in sys.modules if k.startswith('vit_tpu_torch')]))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20
