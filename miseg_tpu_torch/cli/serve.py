"""`serve` — HTTP inference server over a port bundle (counterpart of
`miseg_tpu/cli/serve.py`).

A stdlib ThreadingHTTPServer that takes a NIfTI scan, runs the same
deterministic chain as offline evaluation (load, orient to RAS, resample
to the bundle's spacing, scale, pad: `data/multi_modal.py`'s
`eval_transforms`), the bundle's sliding-window prediction on the device,
argmax on the device, the inverse transforms on the host back to the
scan's own voxel grid, and answers with the segmentation as a NIfTI —
`predict_whs` as a service.

    python -m miseg_tpu_torch.cli.serve --bundle bundles/cswin_fs48 --port 8093

Endpoints:
    GET  /health              -> 200 JSON: bundle meta (its volume
                                 programs among it) + status, the window
                                 form served, and the tags of the volume
                                 programs loaded (on the card: captured)
                                 so far
    POST /predict?modality=0  -> body: .nii / .nii.gz bytes (a gzip
         [&remap=whs]            Content-Encoding is undone first);
         [&mode=gaussian]        answer: .nii.gz segmentation in the
                                 scan's grid and affine (class ids, or
                                 MM-WHS label values with remap=whs)
A failed request gets a 400 with a JSON error, an unknown route a 404.
Every answer to /predict carries a `Server-Timing` header: ms of upload,
preprocess, wait (for the device lock), predict (synchronised), argmax
(with the copy to the host), inverse, encode and total.

Device work is serialised by one lock (requests stay on the default
stream); decoding, preprocessing and encoding of other requests overlap
it.  Every device step runs under `inference_mode`: a handler thread
starts with grad mode on, and the kernel wrappers would otherwise run
inside their autograd Functions.  `make_server` builds every kernel and
the resampler and runs one window before it listens (on the card that
window captures the served window's CUDA graph), so no request pays for
a build.  A request whose preprocessed shape matches one of the bundle's
volume programs runs it (`ServedModel.predict`): on the card the first
such request captures it as a CUDA graph, later ones replay it.  Any
other request replays the window graph once for each window.
"""

from __future__ import annotations

import argparse
import gzip
import io
import json
import logging
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ..data import transforms as T
from ..data.nifti import save_nifti
from ..serve import ServedModel, load_bundle
from ..utils import native
from ..utils.platform import resolve_device
from .predict_whs import MMWHS_LABEL_MAP, remap_labels

_log = logging.getLogger(__name__)


def _eval_chain(meta: dict) -> T.Compose:
    """The offline evaluation chain, rebuilt from the bundle's meta
    (`data/multi_modal.py` `eval_transforms`).  A bundle without
    `spacing` (version 1) raises: resampling at an assumed spacing would
    segment the scan at the wrong scale."""
    if "spacing" not in meta:
        raise ValueError(
            f"bundle version {meta.get('bundle_version', 0)} records no 'spacing': the "
            "preprocessing chain needs the spacing the model was trained at; re-export "
            "the bundle (version 2 writes it)")
    keys = ["image", "label"]
    return T.Compose([
        T.LoadImaged(keys=keys, allow_missing_keys=True),
        T.EnsureChannelLastd(keys=keys, allow_missing_keys=True),
        T.Orientationd(keys=keys, axcodes="RAS", allow_missing_keys=True),
        T.Spacingd(keys=keys, pixdim=tuple(meta["spacing"]),
                   mode=("bilinear", "nearest"), allow_missing_keys=True),
        T.ScaleIntensityd(keys=["image"]),
        T.SpatialPadd(keys=keys, spatial_size=tuple(meta["roi"]), value=0,
                      allow_missing_keys=True),
        T.ToTensord(keys=keys),
    ])


class InferenceService:
    """Bundle + preprocessing chain + device lock: one `infer` call is one
    segmentation in the scan's own grid."""

    def __init__(self, served: ServedModel):
        self.served = served
        self.chain = _eval_chain(served.meta)
        self._device_lock = threading.Lock()

    def preprocess(self, nifti_bytes: bytes) -> dict:
        """The chain over an uploaded scan: image `[X, Y, Z, 1]` at the
        bundle's spacing, its meta, and the op record to invert."""
        # the chain loads from a path; stage the upload
        suffix = ".nii.gz" if nifti_bytes[:2] == b"\x1f\x8b" else ".nii"
        with tempfile.NamedTemporaryFile(suffix=suffix) as f:
            f.write(nifti_bytes)
            f.flush()
            # "label" = the image records the invertible ops
            return self.chain({"image": f.name, "label": f.name})

    def infer(self, nifti_bytes: bytes, modality: int, *, mode: str = "gaussian",
              remap: str | None = None, timings: dict | None = None) -> bytes:
        """The segmentation of one scan as `.nii.gz` bytes; `timings`, when
        given, receives the seconds of each stage."""
        clock = [time.perf_counter()]

        def mark(stage):
            clock.append(time.perf_counter())
            if timings is not None:
                timings[stage] = clock[-1] - clock[-2]

        sample = self.preprocess(nifti_bytes)
        image = torch.from_numpy(np.ascontiguousarray(sample["image"]))[None]
        mark("preprocess")
        with self._device_lock:
            mark("wait")
            with torch.inference_mode():
                logits = self.served.predict(image, [modality], mode=mode)
                if logits.is_cuda:
                    torch.cuda.synchronize(logits.device)
                mark("predict")
                pred = logits[0].argmax(dim=-1).to(torch.int32).cpu().numpy()
                del logits
            mark("argmax")

        inv = dict(sample)
        inv["label"] = pred[..., None].astype(np.float32)
        inverted = self.chain.inverse(inv, key="label")
        final = np.rint(np.asarray(inverted["label"])).astype(np.int32)
        if remap == "whs":
            final = remap_labels(final, MMWHS_LABEL_MAP)
        mark("inverse")

        affine = sample["image_meta"]["original_affine"]
        with tempfile.TemporaryDirectory() as d:
            out_path = f"{d}/pred.nii.gz"
            save_nifti(out_path, final.astype(np.uint16), affine)
            with open(out_path, "rb") as f:
                out = f.read()
        mark("encode")
        return out


def make_handler(service: InferenceService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if urlparse(self.path).path == "/health":
                served = service.served
                self._json(200, {"status": "ok", **served.meta, "window_form": served.form,
                                 "volume_programs_loaded": served.loaded_volume_programs()})
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            start = time.perf_counter()
            url = urlparse(self.path)
            if url.path != "/predict":
                self._json(404, {"error": f"no route {url.path}"})
                return
            q = parse_qs(url.query)
            timings: dict[str, float] = {}
            try:
                modality = int(q.get("modality", ["0"])[0])
                mode = q.get("mode", ["gaussian"])[0]
                remap = q.get("remap", [None])[0]
                length = int(self.headers.get("Content-Length", 0))
                if length <= 0:
                    raise ValueError("empty body (expect NIfTI bytes)")
                body = self.rfile.read(length)
                if self.headers.get("Content-Encoding") == "gzip":
                    body = gzip.GzipFile(fileobj=io.BytesIO(body)).read()
                timings["upload"] = time.perf_counter() - start
                out = service.infer(body, modality, mode=mode, remap=remap,
                                    timings=timings)
            except Exception as e:  # noqa: BLE001 — report, keep serving
                _log.warning("POST %s failed", self.path, exc_info=True)
                self._json(400, {"error": f"{type(e).__name__}: {e}"})
                return
            timings["total"] = time.perf_counter() - start
            self.send_response(200)
            self.send_header("Content-Type", "application/gzip")
            self.send_header("Content-Disposition",
                             'attachment; filename="pred.nii.gz"')
            self.send_header("Content-Length", str(len(out)))
            self.send_header("Server-Timing", ", ".join(
                f"{k};dur={v * 1e3:.3f}" for k, v in timings.items()))
            self.end_headers()
            self.wfile.write(out)

    Handler.service = service
    return Handler


def make_server(bundle_dir: str, host: str = "127.0.0.1", port: int = 8093,
                device=None) -> ThreadingHTTPServer:
    """A server (not yet serving) over the bundle at `bundle_dir` on
    `device` (the CUDA card unless given; raises when there is none).
    Builds the kernels and the resampler and runs one window first."""
    device = resolve_device(device)
    if device.type == "cuda":
        from ..ops.kernels import build
        build.build_all()
    native.load()
    service = InferenceService(load_bundle(bundle_dir, device))
    meta = service.served.meta
    bs = int(meta["sw_batch_size"])
    service.served(torch.zeros((bs, *meta["roi"], int(meta["in_channels"]))),
                   torch.zeros((bs,), dtype=torch.int32))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return ThreadingHTTPServer((host, port), make_handler(service))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--bundle", required=True,
                   help="serving bundle dir (from miseg_tpu_torch.cli.export)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8093)
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the CUDA card)")
    args = p.parse_args(argv)
    server = make_server(args.bundle, args.host, args.port, device=args.device)
    print(f"serving {args.bundle} on http://{args.host}:{server.server_port} "
          f"(GET /health, POST /predict?modality=N)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
