"""Browser demo: upload an image, see detections (PyTorch; counterpart of
custom_d_fine_tpu/cli/demo.py).

Parity target: reference demo/demo.py (gradio upload-image UI around
Torch_model). gradio is not in this image, so this is a zero-dependency
stdlib http.server app exposing the same flow: POST an image, get back the
rendered detections.

Usage: python -m custom_d_fine_tpu_torch.cli.demo [--config cfg] [--port 7860] [k=v ...]
"""

from __future__ import annotations

import argparse
import io
from http.server import BaseHTTPRequestHandler, HTTPServer
from pathlib import Path

import cv2
import numpy as np

PAGE = b"""<!doctype html>
<title>D-FINE demo</title>
<h2>D-FINE demo</h2>
<form method=post enctype=multipart/form-data action=/predict>
  <input type=file name=image accept=image/*>
  <input type=submit value=Detect>
</form>
"""


def make_handler(model, label_to_name):
    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.end_headers()
            self.wfile.write(PAGE)

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            # naive multipart parse: find the file payload
            sep = body.find(b"\r\n\r\n")
            payload = body[sep + 4:]
            end = payload.rfind(b"\r\n--")
            payload = payload[:end] if end > 0 else payload
            img = cv2.imdecode(np.frombuffer(payload, np.uint8), cv2.IMREAD_COLOR)
            if img is None:
                self.send_response(400)
                self.end_headers()
                self.wfile.write(b"could not decode image")
                return
            from ..utils.vis import draw_detections

            det = model(img)[0]
            vis = draw_detections(img, det, label_to_name)
            ok, buf = cv2.imencode(".jpg", vis)
            self.send_response(200)
            self.send_header("Content-Type", "image/jpeg")
            self.end_headers()
            self.wfile.write(buf.tobytes())

        def log_message(self, *a):
            pass

    return Handler


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default=None)
    parser.add_argument("--weights", default=None)
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    from ..infer.model import TorchModel
    from ..utils.config import load_config, resolve_experiment_dir
    from ..utils.logging import logger

    cfg = load_config(args.config, args.overrides)
    t = cfg["train"]
    t["path_to_save"] = resolve_experiment_dir(t["path_to_save"])
    label_to_name = {int(k): v for k, v in t["label_to_name"].items()}
    weights = args.weights or str(Path(t["path_to_save"]) / "model.pt")
    model = TorchModel(
        weights if Path(weights).exists() else None,
        cfg["model_name"], len(label_to_name),
        img_size=tuple(t["img_size"]), task=cfg.get("task", "detect"),
        conf_thresh=t.get("conf_thresh", 0.5), keep_ratio=t.get("keep_ratio", False),
        device=t.get("device"),
    )
    server = HTTPServer(("0.0.0.0", args.port), make_handler(model, label_to_name))
    logger.info(f"demo listening on :{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
