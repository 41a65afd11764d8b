"""Minimal HTTP inference server over an export directory (counterpart of
``vit_tpu/serve/server.py:45-246``).

Serves a ``vit_tpu_torch.serve.export`` directory on one device. Arrays travel
as ``.npy`` bytes:

  GET  /manifest        → manifest.json
  POST /<fn>            body: .npy array → response: .npy array
                          (tokenizers: /encode /decode; VideoGPT:
                          /generate, greedy exports only)

Requests smaller than the export's ``bs`` are zero-padded up to it and the
response sliced back; larger ones are rejected. ``bs`` 0 takes any batch as
it comes. ``--batch_window_ms W`` turns on cross-request micro-batching:
concurrent requests coalesce for up to W ms into one device call per bs rows
(``Batcher``).

CLI:  python -m vit_tpu_torch.serve.server --dir exported/titok --port 8421 --warmup

Client:
  buf = io.BytesIO(); np.save(buf, images)
  resp = urllib.request.urlopen(
      urllib.request.Request(url + "/encode", data=buf.getvalue(),
                             method="POST"))
  indices = np.load(io.BytesIO(resp.read()))
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


class Batcher:
    """Coalesce concurrent requests into one device call (micro-batching).

    A padded fixed-batch call costs the same whether 1 or bs rows are real,
    so this worker collects rows across requests for up to ``window_s``
    (counted from the first request of a flight) or until the flight is full,
    runs ONE padded call, and scatters the rows back. Request order within a
    flight is preserved; a request never spans two flights (the server caps
    request batch at bs). A device-call failure propagates to every request
    in that flight.
    """

    def __init__(self, fn, bs: int, window_s: float):
        self.fn, self.bs, self.window = fn, bs, window_s
        self.q: "queue.Queue[dict]" = queue.Queue()
        self.calls = 0  # device calls issued (for tests/metrics)
        threading.Thread(target=self._run, daemon=True).start()

    def __call__(self, arr: np.ndarray) -> np.ndarray:
        item = {"arr": arr, "ev": threading.Event()}
        self.q.put(item)
        item["ev"].wait()
        if "err" in item:
            raise item["err"]
        return item["out"]

    def _flush(self, flight):
        rows = np.concatenate([it["arr"] for it in flight], axis=0)
        try:
            if rows.shape[0] < self.bs:
                pad = np.zeros((self.bs - rows.shape[0],) + rows.shape[1:],
                               rows.dtype)
                rows = np.concatenate([rows, pad], axis=0)
            self.calls += 1
            out = np.asarray(self.fn(rows))
            off = 0
            for it in flight:
                k = it["arr"].shape[0]
                it["out"] = out[off:off + k]
                off += k
        except Exception as e:  # propagate to every waiter in the flight
            for it in flight:
                it["err"] = e
        finally:
            for it in flight:
                it["ev"].set()

    def _run(self):
        carry = None
        while True:
            first = carry if carry is not None else self.q.get()
            carry = None
            flight, rows = [first], first["arr"].shape[0]
            deadline = time.monotonic() + self.window
            while rows < self.bs:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = self.q.get(timeout=timeout)
                except queue.Empty:
                    break
                if rows + nxt["arr"].shape[0] > self.bs:
                    carry = nxt  # doesn't fit: opens the next flight
                    break
                flight.append(nxt)
                rows += nxt["arr"].shape[0]
            self._flush(flight)


def make_server(export_dir: str, host: str = "127.0.0.1", port: int = 8421,
                warmup: bool = False, batch_window_ms: float = 0.0,
                device: str = "cuda") -> ThreadingHTTPServer:
    """Build (not start) a ThreadingHTTPServer bound to the export dir, with
    the model on ``device``. Call ``.serve_forever()`` on the result;
    ``.shutdown()`` stops it.

    ``batch_window_ms > 0`` enables cross-request micro-batching (`Batcher`)
    on fixed-batch exports: concurrent requests coalesce into one device call
    per ``bs`` rows, at up to that much added latency for a lone request."""
    from vit_tpu_torch.serve.export import load_exported

    served = load_exported(export_dir, device)
    manifest = served["manifest"]
    avals = served["_in_avals"]  # {fn: [((dims-or-None...), dtype_name)]}
    # the npy-over-HTTP protocol carries ONE array per request: a sampled
    # VideoGPT generate, which also takes a seed, is not served here.
    # Every served fn hands back a device tensor; fetch it to the host here.
    fns = {k: (lambda a, f=served[k]: f(a).cpu().numpy())
           for k in avals if len(avals[k]) == 1}
    bs = int(manifest["bs"])
    n_codes = manifest["codebook_size"]
    batchers = ({k: Batcher(v, bs, batch_window_ms / 1e3)
                 for k, v in fns.items()}
                if batch_window_ms > 0 and bs else None)

    if warmup:
        # first call of each fn builds the kernels and warms the allocator
        # (an unknown batch size — None — warms up at size 1)
        for name, fn in fns.items():
            (shape, dtype), = avals[name]
            fn(np.zeros(tuple(d if d is not None else 1 for d in shape), dtype))

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _reply(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/", "/manifest"):
                self._reply(200, json.dumps(manifest).encode(),
                            "application/json")
            else:
                self._reply(404, b"unknown path", "text/plain")

        def do_POST(self):
            # always drain the body first: an early reply with unread bytes
            # desyncs HTTP/1.1 keep-alive (the leftover npy payload would be
            # parsed as the next request line)
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n)
            name = self.path.lstrip("/")
            fn = fns.get(name)
            if fn is None:
                self._reply(404, f"no function {name!r}; have "
                            f"{sorted(fns)}".encode(), "text/plain")
                return
            try:  # request validation → 400
                arr = np.load(io.BytesIO(body), allow_pickle=False)
                k = arr.shape[0]
                (shape, dtype), = avals[name]
                if arr.shape[1:] != shape[1:] or arr.dtype != np.dtype(dtype):
                    raise ValueError(
                        f"expected (batch,)+{shape[1:]} {dtype}, got "
                        f"{arr.shape} {arr.dtype}")
                if bs and k > bs:
                    raise ValueError(
                        f"batch {k} > exported bs {bs}; split the request")
                # an out-of-range index would fault the device-side gather
                if name in ("decode", "generate") and arr.size and (
                        arr.min() < 0 or arr.max() >= n_codes):
                    raise ValueError(f"indices must lie in [0, {n_codes})")
                if batchers is None and bs and k < bs:
                    # no micro-batching: pad this request up to bs here
                    # (the Batcher pads whole flights itself)
                    pad = np.zeros((bs - k,) + arr.shape[1:], arr.dtype)
                    arr = np.concatenate([arr, pad], axis=0)
            except Exception as e:
                self._reply(400, f"{type(e).__name__}: {e}".encode(),
                            "text/plain")
                return
            try:  # execution faults (build/OOM/dtype plumbing) → 500,
                  # so retry policies don't misattribute them to the caller
                call = batchers[name] if batchers else fn
                result = np.asarray(call(arr))[:k]
                buf = io.BytesIO()
                np.save(buf, result)
                self._reply(200, buf.getvalue(), "application/octet-stream")
            except Exception as e:
                self._reply(500, f"{type(e).__name__}: {e}".encode(),
                            "text/plain")

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", required=True, help="export directory")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8421)
    ap.add_argument("--device", default="cuda",
                    help="torch device the model runs on")
    ap.add_argument("--warmup", action="store_true",
                    help="build the kernels before accepting requests")
    ap.add_argument("--batch_window_ms", type=float, default=0.0,
                    help="micro-batching: coalesce concurrent requests for "
                    "up to this long into one device call per exported-bs "
                    "rows (0 = off; fixed-batch exports only)")
    args = ap.parse_args(argv)

    srv = make_server(args.dir, args.host, args.port, warmup=args.warmup,
                      batch_window_ms=args.batch_window_ms,
                      device=args.device)
    print(f"serving {args.dir} on http://{args.host}:{args.port} "
          f"(POST .npy to /<fn>)", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.shutdown()


if __name__ == "__main__":
    main()
