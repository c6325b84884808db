"""The control panel: a web app over the port's generation, gallery,
preprocessing and training, with no framework.

Port of the JAX package's ``serve/app.py`` (itself the reference's Streamlit
UI made framework-free): a self-contained single-page app
(``static/index.html``, no external assets) served by the standard library's
HTTP server, with JSON endpoints for each page, the same endpoints and JSON
as the JAX panel's:

 - Generate: a checkpoint list over the trusted roots only (``checkpoints/``
   and ``runs/`` under the work directory), seeded batched generation with a
   noise scale, the discriminator-scored oversample-and-keep-best quality
   filter, a cancelable batch-by-batch generation job, latent interpolation.
   Generation runs ``infer/generate.py::load_session``: a 64 px ReLU
   unconditional ``use_pallas`` run goes through the generator kernel (B4)
   and raises if a launch fails; D's scores come from
   ``GeneratorSession.score_with_discriminator``, with D cached per
   (checkpoint, which).
 - Gallery: pagination, selection ZIP, save to a folder, contact sheets,
   binarize / transparency post-processing (PNGs read by the port's own
   decoder).
 - Preprocess and Train: the port's ``cli.preprocess`` and ``cli.train`` as
   logged subprocesses on the panel's device (``serve/monitor.py``), stop
   file, live status, run history and the multi-run comparison chart.
 - About: the version, the device, and the card's memory.

The checkpoint trust model is kept: only directories under the trusted
roots load, unless unsafe mode is switched on with an acknowledgement. The
panel and its subprocesses run on ``device`` ("cuda" unless the caller asks
for the CPU).
"""

from __future__ import annotations

import base64
import io
import json
import math
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any, Dict, List, Optional

from siggan_tpu_torch.core.platform import DeviceLike, device_info, resolve_device
from siggan_tpu_torch.serve import monitor

STATIC_DIR = Path(__file__).parent / "static"


class AppCore:
    """Every endpoint's logic, testable without sockets. Raises when
    ``device`` names a card and none is present."""

    def __init__(self, workdir: str | Path = ".", device: DeviceLike = "cuda"):
        self.workdir = Path(workdir).absolute()
        self.device = resolve_device(device)
        self.trusted_roots = [self.workdir / "checkpoints", self.workdir / "runs"]
        self.unsafe_mode = False  # the trust model's acknowledged override
        self._sessions: Dict[str, Any] = {}
        self._discriminators: Dict[str, Any] = {}
        self._lock = threading.Lock()
        # One model call at a time: handler threads and generation jobs
        # share the sessions and the card.
        self._run_lock = threading.Lock()
        self._preprocess_jobs: Dict[str, Dict] = {}
        self._gen_jobs: Dict[str, Dict] = {}
        self._gen_seq = 0

    # -- checkpoint discovery + trust -------------------------------------
    def find_checkpoints(self) -> List[Dict[str, Any]]:
        """Every run directory (an ``index.json`` with ``epochs``) under the
        trusted roots: the port's runs and runs imported from the JAX
        package."""
        found = []
        for root in self.trusted_roots:
            if not root.is_dir():
                continue
            for idx in sorted(root.rglob("index.json")):
                ckpt_dir = idx.parent
                try:
                    index = json.loads(idx.read_text())
                except json.JSONDecodeError:
                    continue
                if "epochs" not in index:
                    continue
                found.append({
                    "path": str(ckpt_dir.relative_to(self.workdir)),
                    "epochs": index.get("epochs", []),
                    "latest": index.get("latest"),
                    "best": index.get("best"),
                })
        return found

    def _validate_checkpoint(self, rel_path: str) -> Path:
        p = (self.workdir / rel_path).resolve()
        for root in self.trusted_roots:
            try:
                p.relative_to(root.resolve())
                return p
            except ValueError:
                continue
        if self.unsafe_mode:
            # Explicitly acknowledged override: any path becomes loadable
            # until unsafe mode is switched off again.
            return p
        raise PermissionError(
            f"checkpoint path {rel_path!r} is outside the trusted roots "
            f"(checkpoints/, runs/); enable unsafe mode to override")

    def set_unsafe_mode(self, body: Dict[str, Any]) -> Dict[str, Any]:
        """Toggle the checkpoint-trust override. Turning it ON requires an
        explicit acknowledgement (the panel's confirm checkbox)."""
        enabled = bool(body.get("enabled", False))
        if enabled and not body.get("acknowledge"):
            raise ValueError(
                "enabling unsafe mode requires acknowledge=true "
                "(loads checkpoints from arbitrary paths)")
        self.unsafe_mode = enabled
        return {"unsafe_mode": self.unsafe_mode}

    def _session(self, rel_path: str, which: str = "latest"):
        key = f"{rel_path}@{which}"
        with self._lock:
            if key not in self._sessions:
                from siggan_tpu_torch.infer.generate import load_session
                path = self._validate_checkpoint(rel_path)
                self._sessions[key] = load_session(str(path), which, device=self.device)
            return self._sessions[key]

    # -- generate page -----------------------------------------------------
    def generate(self, body: Dict[str, Any]) -> Dict[str, Any]:
        rel = body["checkpoint"]
        which = body.get("which", "latest")
        n = max(1, min(int(body.get("n", 16)), 256))
        seed = int(body.get("seed", 42))
        noise_scale = float(body.get("noise_scale", 1.0))
        quality_filter = bool(body.get("quality_filter", False))
        keep_fraction = _keep_fraction(body)
        ckw = _class_kw(body)  # conditional (v2.0) checkpoints

        session = self._session(rel, which)
        if quality_filter:
            # Oversample and keep the ones D scores highest.
            n_gen = min(int(n / keep_fraction), 512)
            with self._run_lock:
                images = session.sample(n_gen, seed=seed, noise_scale=noise_scale,
                                        **ckw)
            scores = self._d_scores(rel, which, images, _score_labels(ckw, len(images)))
            order = scores.argsort()[::-1][:n]
            images, scores = images[order], scores[order]
        else:
            with self._run_lock:
                images = session.sample(n, seed=seed, noise_scale=noise_scale,
                                        **ckw)
            scores = None

        out_dir = self.workdir / "samples" / f"gen_{time.strftime('%Y%m%d_%H%M%S')}"
        from siggan_tpu_torch.infer.export import png_bytes, save_pngs
        from siggan_tpu_torch.utils.visualizer import to_uint8
        u8 = _apply_post(to_uint8(images), _post_opts(body))
        paths = save_pngs(u8, out_dir, denormalize=False)
        return {
            "count": len(paths),
            "output_dir": str(out_dir),
            "output_rel": str(out_dir.relative_to(self.workdir)),
            "thumbnails": [base64.b64encode(
                png_bytes(img, denormalize=False)).decode()
                for img in u8[:64]],
            "scores": [float(s) for s in scores] if scores is not None else None,
        }

    def _d_scores(self, rel: str, which, images, y=None):
        # The discriminator is cached per (checkpoint, which) like the
        # generator sessions: reading it per scored click repeats the IO.
        discriminator = self._discriminator(rel, which)
        session = self._session(rel, which)
        with self._run_lock:
            return session.score_with_discriminator(images, discriminator, y=y)

    def interpolate(self, body: Dict[str, Any]) -> Dict[str, Any]:
        session = self._session(body["checkpoint"], body.get("which", "latest"))
        with self._run_lock:
            frames = session.interpolate(seed=int(body.get("seed", 0)),
                                         steps=max(2, min(int(body.get("steps", 10)), 32)),
                                         **_class_kw(body))
        return {"frames": [_b64_png(f) for f in frames]}

    # -- resumable / cancelable generation job -------------------------------
    # A background job writes PNGs batch by batch, polls a cancel flag
    # between batches (partials are kept), and finalizes (the quality
    # filter's top-K keep, deleting the rest) over the batches that
    # completed.
    def generate_start(self, body: Dict[str, Any]) -> Dict[str, Any]:
        rel = body["checkpoint"]
        which = body.get("which", "latest")
        n = max(1, min(int(body.get("n", 64)), 1000))
        batch = max(1, min(int(body.get("batch_size", 16)), 256))
        seed = int(body.get("seed", 42))
        noise_scale = float(body.get("noise_scale", 1.0))
        quality_filter = bool(body.get("quality_filter", False))
        keep_fraction = _keep_fraction(body)
        post = _post_opts(body)
        ckw = _class_kw(body)

        session = self._session(rel, which)  # load (and validate) up front
        # Unique under concurrent requests: second-resolution timestamps
        # collide, so the tiebreaker is a locked monotonic counter.
        with self._lock:
            self._gen_seq += 1
            job_id = (f"gen_{time.strftime('%Y%m%d_%H%M%S')}"
                      f"_{self._gen_seq}")
        out_dir = self.workdir / "samples" / job_id
        n_target = (min(int(n / max(keep_fraction, 0.05)), 1024)
                    if quality_filter else n)
        job: Dict[str, Any] = {
            "id": job_id, "n": n, "n_target": n_target, "done": 0,
            "output_dir": str(out_dir),
            "output_rel": str(out_dir.relative_to(self.workdir)),
            "cancelled": False, "finished": False, "error": None,
            "kept": None, "scores": None,
        }
        self._gen_jobs[job_id] = job

        def worker():
            from siggan_tpu_torch.infer.export import save_pngs
            from siggan_tpu_torch.utils.visualizer import to_uint8
            try:
                all_scores: List[float] = []
                n_batches = -(-n_target // batch)
                for bidx in range(n_batches):
                    if job["cancelled"]:
                        break
                    take = min(batch, n_target - job["done"])
                    # A seed per batch, base + batch index: resumable by
                    # construction.
                    with self._run_lock:
                        imgs = session.sample(take, seed=seed + bidx,
                                              noise_scale=noise_scale,
                                              batch_size=take, **ckw)
                    if quality_filter:
                        all_scores += [float(s) for s in self._d_scores(
                            rel, which, imgs, _score_labels(ckw, len(imgs)))]
                    u8 = _apply_post(to_uint8(imgs), post)
                    save_pngs(u8, out_dir, start_index=job["done"],
                              denormalize=False)
                    job["done"] += take
                # Finalize: the top-K keep over the completed batches.
                files = sorted(out_dir.glob("signature_*.png"))
                if quality_filter and all_scores:
                    order = sorted(range(len(files)),
                                   key=lambda i: -all_scores[i])[:n]
                    keep = {files[i] for i in order}
                    for f in files:
                        if f not in keep:
                            f.unlink()
                    job["scores"] = sorted(all_scores, reverse=True)[:n]
                    job["kept"] = len(keep)
                else:
                    job["kept"] = len(files)
            except Exception as e:  # surface to the poller
                job["error"] = f"{type(e).__name__}: {e}"
            finally:
                job["finished"] = True

        threading.Thread(target=worker, daemon=True).start()
        return {"job": job_id, "n_target": n_target, "output_rel": job["output_rel"]}

    def generate_status(self, job_id: str) -> Dict[str, Any]:
        job = self._gen_jobs.get(job_id)
        if job is None:
            return {"error": "unknown job"}
        out = dict(job)
        files = sorted(Path(job["output_dir"]).glob("signature_*.png"))
        out["thumbnails"] = [
            base64.b64encode(f.read_bytes()).decode() for f in files[-16:]]
        out["n_files"] = len(files)
        return out

    def generate_cancel(self, body: Dict[str, Any]) -> Dict[str, Any]:
        job = self._gen_jobs.get(body.get("job", ""))
        if job is None:
            return {"error": "unknown job"}
        job["cancelled"] = True  # partials are kept
        return {"cancelled": True, "done": job["done"]}

    def _discriminator(self, rel: str, which):
        """The run's discriminator on the panel's device, cached per
        (checkpoint, which)."""
        key = f"{rel}@{which}"
        with self._lock:
            cached = self._discriminators.get(key)
        if cached is None:
            from siggan_tpu_torch.ckpt.manager import load_discriminator
            path = self._validate_checkpoint(rel)
            cached, _ = load_discriminator(path, self.device, which)
            with self._lock:
                self._discriminators[key] = cached
        return cached

    # -- gallery: pagination, selection, export -----------------------------
    def _samples_dir(self, rel_dir: str) -> Path:
        root = (self.workdir / "samples").resolve()
        p = (self.workdir / rel_dir).resolve()
        try:
            p.relative_to(root)
        except ValueError:
            raise PermissionError(f"{rel_dir!r} is outside samples/")
        if not p.is_dir():
            raise FileNotFoundError(rel_dir)
        return p

    def gallery(self, rel_dir: str, page: int = 0,
                page_size: int = 24) -> Dict[str, Any]:
        p = self._samples_dir(rel_dir)
        files = sorted(p.glob("*.png"))
        page_size = max(1, min(page_size, 100))
        pages = max(1, -(-len(files) // page_size))
        page = max(0, min(page, pages - 1))
        sel = files[page * page_size:(page + 1) * page_size]
        return {
            "dir": rel_dir, "total": len(files), "page": page, "pages": pages,
            "items": [{"name": f.name,
                       "b64": base64.b64encode(f.read_bytes()).decode()}
                      for f in sel],
        }

    def gallery_zip(self, body: Dict[str, Any]) -> bytes:
        """ZIP of a selection of images, with the optional binarize /
        transparency post-processing applied at export time."""
        p = self._samples_dir(body["dir"])
        names = body.get("names") or [f.name for f in sorted(p.glob("*.png"))]
        post = _post_opts(body)
        import zipfile
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
            for name in names:
                f = p / Path(name).name  # no traversal via names
                if not f.is_file():
                    continue
                zf.writestr(f.name, _maybe_post_png(f, post))
        return buf.getvalue()

    def save_to_folder(self, body: Dict[str, Any]) -> Dict[str, Any]:
        """Copy selected images to a destination folder (any local folder;
        the sources stay restricted to samples/)."""
        p = self._samples_dir(body["dir"])
        dest = Path(body.get("dest") or (self.workdir / "exports"))
        if not dest.is_absolute():
            dest = self.workdir / dest
        dest.mkdir(parents=True, exist_ok=True)
        names = body.get("names") or [f.name for f in sorted(p.glob("*.png"))]
        post = _post_opts(body)
        saved = []
        for name in names:
            f = p / Path(name).name
            if not f.is_file():
                continue
            out = dest / f.name
            out.write_bytes(_maybe_post_png(f, post))
            saved.append(out.name)
        return {"dest": str(dest), "saved": len(saved), "names": saved}

    def contact_sheet_png(self, rel_dir: str) -> bytes:
        """Contact sheet of a generation directory (its first 64 PNGs, read
        as grey by the port's decoder)."""
        import numpy as np
        from siggan_tpu_torch.data.dataset import decode_gray
        from siggan_tpu_torch.infer.export import encode_png
        from siggan_tpu_torch.utils.visualizer import make_grid
        p = self._samples_dir(rel_dir)
        files = sorted(p.glob("*.png"))[:64]
        if not files:
            raise FileNotFoundError(f"no images in {rel_dir}")
        arrs = [decode_gray(f)[..., None] for f in files]
        return encode_png(make_grid(np.stack(arrs), nrow=8))

    def runs_compare_png(self, names: List[str], key: str = "g_loss") -> bytes:
        """The multi-run metric chart of runs under runs/."""
        import tempfile
        from siggan_tpu_torch.utils.visualizer import plot_run_comparison
        runs = {}
        for name in names:
            run_dir = (self.workdir / "runs" / Path(name).name)
            metrics = monitor.discover_metrics(run_dir)
            if metrics:
                runs[name] = metrics
        if not runs:
            raise FileNotFoundError("no metrics found for requested runs")
        with tempfile.TemporaryDirectory() as td:
            out = plot_run_comparison(runs, Path(td) / "cmp.png", key=key)
            return Path(out).read_bytes()

    # -- preprocess page ----------------------------------------------------
    def preprocess(self, body: Dict[str, Any]) -> Dict[str, Any]:
        input_dir = body["input_dir"]
        output_dir = body.get("output_dir") or str(
            self.workdir / "data" / "preprocessed")
        args = [sys.executable, "-m", "siggan_tpu_torch.cli.preprocess",
                "--input_dir", input_dir, "--output_dir", output_dir,
                "--device", str(self.device)]
        if body.get("binarize"):
            args.append("--binarize")
        log = self.workdir / "logs" / "preprocess.log"
        log.parent.mkdir(parents=True, exist_ok=True)
        with open(log, "ab") as lf:
            proc = subprocess.Popen(args, stdout=lf, stderr=subprocess.STDOUT)
        job = {"pid": proc.pid, "log": str(log), "output_dir": output_dir,
               "started": time.time()}
        self._preprocess_jobs[str(proc.pid)] = job
        return job

    def preprocess_status(self, pid: str) -> Dict[str, Any]:
        job = self._preprocess_jobs.get(pid)
        if not job:
            return {"error": "unknown job"}
        return {**job, "alive": monitor.pid_alive(int(pid)),
                "log_tail": monitor.tail_file(job["log"], 15)}

    # -- train page -----------------------------------------------------------
    def train_start(self, body: Dict[str, Any]) -> Dict[str, Any]:
        existing = monitor.read_training_state(self.workdir)
        if existing and existing["alive"]:
            return {"error": "a training run is already active",
                    "state": existing}
        monitor.clear_stale_state(self.workdir)
        run_name = body.get("run_name") or time.strftime("run_%Y%m%d_%H%M%S")
        run_dir = self.workdir / "runs" / run_name
        extra: List[str] = []
        for flag in ("epochs", "batch_size", "latent_dim", "image_size",
                     "seed", "sample_interval", "checkpoint_interval",
                     "n_critic", "g_lr", "d_lr", "label_smoothing",
                     "fid_interval", "ema_decay", "aux_weight",
                     "num_classes", "g_conditioning", "lr_schedule",
                     "diffaugment"):
            if flag in body:
                extra += [f"--{flag}", str(body[flag])]
        if body.get("spectral_norm"):
            extra.append("--spectral_norm")
        extra += ["--device", str(self.device)]
        return monitor.launch_training(run_dir, body["data_dir"], extra,
                                       self.workdir)

    def train_status(self) -> Dict[str, Any]:
        status = monitor.run_status(self.workdir)
        if status.get("latest_sample"):
            try:
                status["latest_sample_b64"] = base64.b64encode(
                    Path(status["latest_sample"]).read_bytes()).decode()
            except OSError:
                pass
        return status

    def train_stop(self) -> Dict[str, Any]:
        return {"stopped": monitor.request_stop(self.workdir)}

    def export_zip(self, rel_dir: str) -> bytes:
        """ZIP a generation output directory. Only directories under
        workdir/samples are served."""
        root = (self.workdir / "samples").resolve()
        p = (self.workdir / rel_dir).resolve()
        try:
            p.relative_to(root)
        except ValueError:
            raise PermissionError(f"{rel_dir!r} is outside samples/")
        if not p.is_dir():
            raise FileNotFoundError(rel_dir)
        import zipfile
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
            for f in sorted(p.glob("*.png")):
                zf.write(f, f.name)
        return buf.getvalue()

    def runs(self) -> List[Dict[str, Any]]:
        return monitor.list_runs(self.workdir / "runs")

    def about(self) -> Dict[str, Any]:
        """The version, the device (``device_info``) and, on a card, its
        memory from ``torch.cuda.memory_stats`` (None on the CPU)."""
        import torch
        import siggan_tpu_torch
        out = {"version": siggan_tpu_torch.__version__, **device_info(self.device),
               "workdir": str(self.workdir),
               "unsafe_mode": self.unsafe_mode, "memory": None}
        if self.device.type == "cuda":
            stats = torch.cuda.memory_stats(self.device)
            out["memory"] = {
                "bytes_in_use": stats.get("allocated_bytes.all.current"),
                "bytes_limit": torch.cuda.get_device_properties(self.device).total_memory,
                "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
            }
        return out


def _b64_png(img) -> str:
    from siggan_tpu_torch.infer.export import png_bytes
    return base64.b64encode(png_bytes(img)).decode()


def _keep_fraction(body: Dict[str, Any]) -> float:
    """Clamped to [0.05, 1] (the UI clamps too, but the API must not trust
    it: >1 silently under-delivered, NaN crashed the arithmetic)."""
    try:
        kf = float(body.get("keep_fraction", 0.5))
    except (TypeError, ValueError):
        return 0.5
    if not math.isfinite(kf):
        return 0.5
    return min(max(kf, 0.05), 1.0)


def _score_labels(ckw: Dict[str, Any], n: int):
    """Labels for D-scoring a quality-filter batch: the class the batch was
    generated with, or None for unconditional requests (conditional
    checkpoints without class_id fail in score_with_discriminator with a
    clear message)."""
    if "class_id" in ckw:
        import numpy as _np
        return _np.full(n, ckw["class_id"], _np.int32)
    return None


def _class_kw(body: Dict[str, Any]) -> Dict[str, Any]:
    """Optional conditional class for v2.0 checkpoints: {} when absent so
    unconditional sessions never see the kwarg; range/type validation lives
    in GeneratorSession.sample (surfaces as the request's error message)."""
    cid = body.get("class_id")
    if cid in (None, ""):
        return {}
    return {"class_id": int(cid)}


def _post_opts(body: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Binarize / transparency post-processing options."""
    if not body.get("binarize"):
        return None
    return {"threshold": max(0, min(int(body.get("threshold", 128)), 255)),
            "transparent": bool(body.get("transparent", False))}


def _apply_post(u8, post: Optional[Dict[str, Any]]):
    if post is None:
        return u8
    from siggan_tpu_torch.infer.export import postprocess_binarize
    return postprocess_binarize(u8, threshold=post["threshold"],
                                transparent=post["transparent"])


def _maybe_post_png(path: Path, post: Optional[Dict[str, Any]]) -> bytes:
    """Read a PNG; re-encode through post-processing when requested (grey,
    or RGBA with transparency)."""
    if post is None:
        return path.read_bytes()
    from siggan_tpu_torch.data.dataset import decode_gray
    from siggan_tpu_torch.infer.export import encode_png
    return encode_png(_apply_post(decode_gray(path)[None, ..., None], post)[0])


# -- HTTP plumbing -------------------------------------------------------------

def make_handler(core: AppCore):
    routes_get = {
        "/api/checkpoints": lambda q: core.find_checkpoints(),
        "/api/train/status": lambda q: core.train_status(),
        "/api/runs": lambda q: core.runs(),
        "/api/about": lambda q: core.about(),
    }
    routes_post = {
        "/api/generate": core.generate,
        "/api/generate/start": core.generate_start,
        "/api/generate/cancel": core.generate_cancel,
        "/api/interpolate": core.interpolate,
        "/api/preprocess": core.preprocess,
        "/api/save": core.save_to_folder,
        "/api/unsafe_mode": core.set_unsafe_mode,
        "/api/train/start": core.train_start,
        "/api/train/stop": lambda body: core.train_stop(),
    }

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def _json(self, status: int, obj) -> None:
            payload = json.dumps(obj).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def _binary(self, payload: bytes, ctype: str,
                    filename: Optional[str] = None) -> None:
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            if filename:
                self.send_header("Content-Disposition",
                                 f"attachment; filename={filename}")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_GET(self):
            path = self.path.split("?")[0]
            if path in ("/", "/index.html"):
                page = (STATIC_DIR / "index.html").read_bytes()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(page)))
                self.end_headers()
                self.wfile.write(page)
                return
            if path.startswith("/api/preprocess/status/"):
                self._json(200, core.preprocess_status(path.rsplit("/", 1)[-1]))
                return
            if path.startswith("/api/generate/status/"):
                self._json(200, core.generate_status(path.rsplit("/", 1)[-1]))
                return
            if path.startswith("/api/gallery"):
                from urllib.parse import parse_qs, urlparse
                q = parse_qs(urlparse(self.path).query)
                try:
                    self._json(200, core.gallery(
                        (q.get("dir") or [""])[0],
                        page=int((q.get("page") or ["0"])[0]),
                        page_size=int((q.get("page_size") or ["24"])[0])))
                except PermissionError as e:
                    self._json(403, {"detail": str(e)})
                except FileNotFoundError as e:
                    self._json(404, {"detail": f"not found: {e}"})
                return
            if path.startswith("/api/contact_sheet"):
                from urllib.parse import parse_qs, urlparse
                q = parse_qs(urlparse(self.path).query)
                try:
                    payload = core.contact_sheet_png((q.get("dir") or [""])[0])
                except PermissionError as e:
                    self._json(403, {"detail": str(e)})
                    return
                except FileNotFoundError as e:
                    self._json(404, {"detail": f"not found: {e}"})
                    return
                self._binary(payload, "image/png")
                return
            if path.startswith("/api/runs/compare"):
                from urllib.parse import parse_qs, urlparse
                q = parse_qs(urlparse(self.path).query)
                names = [s for s in (q.get("runs") or [""])[0].split(",") if s]
                try:
                    payload = core.runs_compare_png(
                        names, key=(q.get("key") or ["g_loss"])[0])
                except FileNotFoundError as e:
                    self._json(404, {"detail": str(e)})
                    return
                self._binary(payload, "image/png")
                return
            if path.startswith("/api/export"):
                from urllib.parse import parse_qs, urlparse
                q = parse_qs(urlparse(self.path).query)
                rel = (q.get("dir") or [""])[0]
                try:
                    payload = core.export_zip(rel)
                except PermissionError as e:
                    self._json(403, {"detail": str(e)})
                    return
                except FileNotFoundError as e:
                    self._json(404, {"detail": f"not found: {e}"})
                    return
                self.send_response(200)
                self.send_header("Content-Type", "application/zip")
                self.send_header("Content-Disposition",
                                 "attachment; filename=signatures.zip")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)
                return
            fn = routes_get.get(path)
            if fn is None:
                self._json(404, {"detail": "not found"})
                return
            try:
                self._json(200, fn(None))
            except Exception as e:
                self._json(500, {"detail": f"{type(e).__name__}: {e}"})

        def do_POST(self):
            path = self.path.split("?")[0]
            if path == "/api/gallery/zip":
                try:
                    length = int(self.headers.get("Content-Length") or 0)
                    body = json.loads(self.rfile.read(length) or b"{}")
                    payload = core.gallery_zip(body)
                except PermissionError as e:
                    self._json(403, {"detail": str(e)})
                    return
                except FileNotFoundError as e:
                    self._json(404, {"detail": f"not found: {e}"})
                    return
                except (KeyError, ValueError) as e:
                    self._json(422, {"detail": f"{type(e).__name__}: {e}"})
                    return
                self._binary(payload, "application/zip", "selection.zip")
                return
            fn = routes_post.get(path)
            if fn is None:
                self._json(404, {"detail": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self.rfile.read(length) or b"{}")
                self._json(200, fn(body))
            except PermissionError as e:
                self._json(403, {"detail": str(e)})
            except FileNotFoundError as e:
                self._json(404, {"detail": f"not found: {e}"})
            except (KeyError, ValueError) as e:
                self._json(422, {"detail": f"{type(e).__name__}: {e}"})
            except Exception as e:
                self._json(500, {"detail": f"{type(e).__name__}: {e}"})

    return Handler


def serve(host: str = "0.0.0.0", port: int = 8501,
          workdir: str | Path = ".", device: DeviceLike = "cuda") -> ThreadingHTTPServer:
    """Bind the panel (``port=0`` picks a free port); the caller runs
    ``serve_forever``."""
    core = AppCore(workdir, device)
    server = ThreadingHTTPServer((host, port), make_handler(core))
    server.core = core
    return server
