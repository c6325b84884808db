"""REST API — signature generation service, the JAX package's contract:

  GET  /health            -> {"status", "model_loaded", "load_error",
                              "platform", "device_kind", "num_devices"}
  GET  /info              -> model info (503 if unloaded)
  POST /generate          -> {"n": 1..1000, "seed", "noise_scale",
                              "format": "zip" | "base64", "class_id"}
                             ZIP body or JSON of base64 PNGs (503 if unloaded)
  POST /generate/single   -> one PNG body ({"seed", "noise_scale", "class_id"})

Bad input is a 422 with ``{"detail": ...}``, an unloaded model a 503, an
unexpected error a 500; CORS is open. The checkpoint comes from the argument,
$GAN_CHECKPOINT_PATH or ./checkpoints; host/port from $API_HOST/$API_PORT.
``ApiCore`` holds all endpoint logic and is testable without sockets; the
server is stdlib ``http.server``. The model runs on ``device`` ("cuda" unless
the caller asks for the CPU).
"""

from __future__ import annotations

import base64
import json
import math
import os
import threading
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

from siggan_tpu_torch.core.platform import DeviceLike, device_info, resolve_device

MAX_BATCH = 1000


@dataclass
class ModelState:
    """The loaded session, shared by the handler threads."""
    session: Any = None
    checkpoint_path: Optional[str] = None
    load_error: Optional[str] = None
    lock: threading.Lock = field(default_factory=threading.Lock)

    @property
    def loaded(self) -> bool:
        return self.session is not None


class ApiError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


class ApiCore:
    """Framework-agnostic endpoint logic."""

    def __init__(self, state: Optional[ModelState] = None,
                 device: DeviceLike = "cuda"):
        self.state = state or ModelState()
        self.device = device

    # -- lifecycle ------------------------------------------------------
    def load_model(self, checkpoint_path: Optional[str] = None) -> None:
        """Load the checkpoint; a checkpoint that fails to load is kept in
        ``load_error`` and reported by /health and the 503s, as the JAX
        server does. A missing CUDA device raises here."""
        path = (checkpoint_path or os.environ.get("GAN_CHECKPOINT_PATH")
                or "./checkpoints")
        device = resolve_device(self.device)
        try:
            from siggan_tpu_torch.infer.generate import load_session
            self.state.session = load_session(path, device=device)
            self.state.checkpoint_path = str(path)
            self.state.load_error = None
        except Exception as e:  # reported through /health, not raised
            self.state.session = None
            self.state.load_error = f"{type(e).__name__}: {e}"

    # -- endpoints ------------------------------------------------------
    def health(self) -> Dict[str, Any]:
        return {"status": "ok",
                "model_loaded": self.state.loaded,
                "load_error": self.state.load_error,
                **device_info(self.device)}

    def info(self) -> Dict[str, Any]:
        self._require_model()
        s = self.state.session
        from siggan_tpu_torch.models.generator import param_count
        return {
            "checkpoint": self.state.checkpoint_path,
            "latent_dim": s.cfg.latent_dim,
            "image_size": s.cfg.image_size,
            "image_channels": s.cfg.image_channels,
            "g_param_count": param_count(s.model),
            "num_classes": s.cfg.num_classes,
            "max_batch": MAX_BATCH,
        }

    def _class_id(self, body: Dict[str, Any]):
        class_id = body.get("class_id")
        if class_id is None:
            return None
        nc = self.state.session.cfg.num_classes
        if not isinstance(class_id, int) or isinstance(class_id, bool):
            raise ApiError(422, "class_id must be an integer")
        if nc == 0:
            raise ApiError(422, "class_id given but the loaded checkpoint "
                                "is unconditional (num_classes == 0)")
        if not 0 <= class_id < nc:
            raise ApiError(422, f"class_id must be in [0, {nc})")
        return class_id

    def generate(self, body: Dict[str, Any]) -> Tuple[bytes, str]:
        """POST /generate -> (payload bytes, content_type)."""
        self._require_model()
        n = self._int(body, "n", default=1, lo=1, hi=MAX_BATCH)
        seed = self._int(body, "seed", default=42, lo=0, hi=2 ** 31 - 1)
        noise_scale = self._float(body, "noise_scale", default=1.0,
                                  lo=0.0, hi=10.0)
        fmt = body.get("format", "zip")
        if fmt not in ("zip", "base64"):
            raise ApiError(422, f"format must be 'zip' or 'base64', got {fmt!r}")
        class_id = self._class_id(body)
        with self.state.lock:
            kw = {} if class_id is None else {"class_id": class_id}
            images = self.state.session.sample(
                n, seed=seed, noise_scale=noise_scale, **kw)
        from siggan_tpu_torch.infer.export import png_bytes, zip_bytes
        if fmt == "zip":
            return zip_bytes(images), "application/zip"
        payload = json.dumps({
            "n": n, "seed": seed,
            "images": [base64.b64encode(png_bytes(img)).decode()
                       for img in images],
        }).encode()
        return payload, "application/json"

    def generate_single(self, body: Dict[str, Any]) -> Tuple[bytes, str]:
        self._require_model()
        seed = self._int(body, "seed", default=42, lo=0, hi=2 ** 31 - 1)
        noise_scale = self._float(body, "noise_scale", default=1.0,
                                  lo=0.0, hi=10.0)
        class_id = self._class_id(body)
        with self.state.lock:
            kw = {} if class_id is None else {"class_id": class_id}
            images = self.state.session.sample(1, seed=seed,
                                               noise_scale=noise_scale, **kw)
        from siggan_tpu_torch.infer.export import png_bytes
        return png_bytes(images[0]), "image/png"

    # -- helpers ---------------------------------------------------------
    def _require_model(self) -> None:
        if not self.state.loaded:
            raise ApiError(503, "model not loaded"
                           + (f" ({self.state.load_error})"
                              if self.state.load_error else ""))

    @staticmethod
    def _float(body: Dict, key: str, default: float, lo: float,
               hi: float) -> float:
        v = body.get(key, default)
        try:
            v = float(v)
        except (TypeError, ValueError):
            raise ApiError(422, f"{key} must be a number")
        if not math.isfinite(v) or not lo <= v <= hi:
            raise ApiError(422, f"{key} must be in [{lo}, {hi}]")
        return v

    @staticmethod
    def _int(body: Dict, key: str, default: int, lo: int, hi: int) -> int:
        v = body.get(key, default)
        try:
            v = int(v)
        except (TypeError, ValueError):
            raise ApiError(422, f"{key} must be an integer, got {v!r}")
        if not lo <= v <= hi:
            raise ApiError(422, f"{key} must be in [{lo}, {hi}], got {v}")
        return v


def make_handler(core: ApiCore):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, status: int, payload: bytes, ctype: str) -> None:
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            self.send_header("Access-Control-Allow-Origin", "*")
            self.end_headers()
            self.wfile.write(payload)

        def _json(self, status: int, obj: Dict) -> None:
            self._send(status, json.dumps(obj).encode(), "application/json")

        def do_OPTIONS(self):
            self.send_response(204)
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Access-Control-Allow-Methods", "GET, POST")
            self.send_header("Access-Control-Allow-Headers", "Content-Type")
            self.end_headers()

        def do_GET(self):
            try:
                if self.path == "/health":
                    self._json(200, core.health())
                elif self.path == "/info":
                    self._json(200, core.info())
                else:
                    self._json(404, {"detail": "not found"})
            except ApiError as e:
                self._json(e.status, {"detail": e.message})

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(length) if length else b"{}"
                try:
                    body = json.loads(raw or b"{}")
                except json.JSONDecodeError:
                    raise ApiError(422, "request body is not valid JSON")
                if not isinstance(body, dict):
                    raise ApiError(422, "request body must be a JSON object")
                if self.path == "/generate":
                    payload, ctype = core.generate(body)
                elif self.path == "/generate/single":
                    payload, ctype = core.generate_single(body)
                else:
                    self._json(404, {"detail": "not found"})
                    return
                self._send(200, payload, ctype)
            except ApiError as e:
                self._json(e.status, {"detail": e.message})
            except Exception as e:  # the 500 envelope; the server keeps running
                self._json(500, {"detail": f"{type(e).__name__}: {e}"})

    return Handler


def serve(host: Optional[str] = None, port: Optional[int] = None,
          checkpoint: Optional[str] = None,
          device: DeviceLike = "cuda") -> ThreadingHTTPServer:
    """Load the model and bind the server (``port=0`` picks a free port);
    the caller runs ``serve_forever``."""
    host = host or os.environ.get("API_HOST", "0.0.0.0")
    port = int(port if port is not None else os.environ.get("API_PORT", 8000))
    core = ApiCore(device=device)
    core.load_model(checkpoint)
    server = ThreadingHTTPServer((host, port), make_handler(core))
    server.core = core
    return server
