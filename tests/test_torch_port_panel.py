"""The port's control panel (``serve/monitor.py``, ``serve/app.py``,
``cli/app.py``) on the CPU: the counterparts of ``tests/test_monitor_app.py``
and ``tests/test_panel_parity.py``, case for case, with the port's runs and
a run imported from the JAX package; and, against the JAX functions,
``postprocess_binarize`` (exact on the same uint8 input) and minibatch
discrimination (rtol 1e-4, atol 1e-5). The training subprocess is never
started here (``launch_training`` is monkeypatched, as in the JAX tests).
"""

import io
import json
import os
import threading
import time
import urllib.error
import urllib.request
import zipfile
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from siggan_tpu.infer.export import postprocess_binarize as j_postprocess_binarize
from siggan_tpu.models import minibatch as jminibatch
from siggan_tpu.utils.visualizer import plot_run_comparison as j_plot_run_comparison
from siggan_tpu_torch.ckpt.manager import CheckpointManager
from siggan_tpu_torch.cli import app as app_cli
from siggan_tpu_torch.core.config import ModelConfig, TrainConfig
from siggan_tpu_torch.core.state import create_train_state
from siggan_tpu_torch.infer.export import decode_png, postprocess_binarize
from siggan_tpu_torch.models import minibatch
from siggan_tpu_torch.ops.kernels import generator_fwd
from siggan_tpu_torch.serve import monitor
from siggan_tpu_torch.serve.app import AppCore, serve
from siggan_tpu_torch.train.collapse import check_loss_health
from siggan_tpu_torch.utils.visualizer import plot_run_comparison

FIXTURE_RUN = Path(__file__).parent / "data" / "torch_port" / "jax_run"


def core_at(workdir) -> AppCore:
    return AppCore(workdir, device="cpu")


# -- monitor --------------------------------------------------------------------

def test_pid_liveness():
    assert monitor.pid_alive(os.getpid())
    assert not monitor.pid_alive(2 ** 22 + 12345)
    assert not monitor.pid_alive(-1)


def test_pid_liveness_sees_its_own_child_end():
    """A child the panel started and never waited for is seen to end (the
    JAX package's check sees the zombie as alive)."""
    import subprocess
    import sys
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    t0 = time.time()
    while monitor.pid_alive(proc.pid):
        assert time.time() - t0 < 60, "the exited child still looks alive"
        time.sleep(0.05)
    assert proc.poll() is not None


def test_training_state_roundtrip_and_stale_gc(tmp_path):
    monitor.write_training_state(tmp_path, {"pid": os.getpid(), "run_dir": "x",
                                            "stop_file": str(tmp_path / "S"),
                                            "log_file": str(tmp_path / "l")})
    st = monitor.read_training_state(tmp_path)
    assert st["alive"] is True
    assert not monitor.clear_stale_state(tmp_path)
    monitor.write_training_state(tmp_path, {"pid": 2 ** 22 + 1, "run_dir": "x",
                                            "stop_file": "s", "log_file": "l"})
    assert monitor.clear_stale_state(tmp_path)
    assert monitor.read_training_state(tmp_path) is None


def test_request_stop_writes_stop_file(tmp_path):
    stop = tmp_path / "STOP"
    monitor.write_training_state(tmp_path, {
        "pid": os.getpid(), "run_dir": str(tmp_path),
        "stop_file": str(stop), "log_file": str(tmp_path / "log")})
    assert monitor.request_stop(tmp_path)
    assert stop.exists()


def test_metrics_discovery_cascade(tmp_path):
    logs = tmp_path / "logs"
    logs.mkdir()
    (logs / "training_output.log").write_text(
        "noise\nEpoch 0 | d_loss: 1.2 | g_loss: 0.7\n"
        "Epoch 1 | d_loss: 1.1 | g_loss: 0.8\n")
    m = monitor.discover_metrics(tmp_path)
    assert [e["epoch"] for e in m] == [0, 1] and m[1]["g_loss"] == 0.8
    (logs / "run.csv").write_text("epoch,d_loss,g_loss\n0,9.0,8.0\n")
    assert monitor.discover_metrics(tmp_path)[0]["d_loss"] == 9.0
    (logs / "run.json").write_text(json.dumps(
        {"metrics": [{"epoch": 0, "d_loss": 5.0, "g_loss": 4.0}]}))
    assert monitor.discover_metrics(tmp_path)[0]["d_loss"] == 5.0


def test_tail_file(tmp_path):
    p = tmp_path / "f.log"
    p.write_text("\n".join(f"line{i}" for i in range(100)))
    assert monitor.tail_file(p, 3) == ["line97", "line98", "line99"]
    assert monitor.tail_file(tmp_path / "missing.log") == []


def test_list_runs(tmp_path):
    runs = tmp_path / "runs"
    (runs / "a" / "logs").mkdir(parents=True)
    (runs / "a" / "logs" / "x.json").write_text(json.dumps(
        {"metrics": [{"epoch": 0, "g_loss": 1.0}]}))
    (runs / "a" / "samples").mkdir()
    out = monitor.list_runs(runs)
    assert out[0]["name"] == "a" and out[0]["epochs"] == 1
    assert monitor.list_runs(tmp_path / "nope") == []


def test_run_status_reads_health_and_latest_sample(tmp_path):
    run = tmp_path / "runs" / "r"
    (run / "logs").mkdir(parents=True)
    (run / "samples").mkdir()
    (run / "samples" / "epoch_0001.png").write_bytes(b"x")
    (run / "logs" / "training_output.log").write_text(
        "Epoch 0 | d_loss: 1.2 | g_loss: 0.7\nEpoch 1 | d_loss: 1.1 | g_loss: 0.8\n")
    monitor.write_training_state(tmp_path, {
        "pid": os.getpid(), "run_dir": str(run), "stop_file": "s",
        "log_file": str(run / "logs" / "training_output.log")})
    st = monitor.run_status(tmp_path)
    assert st["running"] and st["epochs_done"] == 2
    assert st["health"] == check_loss_health([1.2, 1.1], [0.7, 0.8])
    assert st["latest_sample"].endswith("epoch_0001.png") and len(st["log_tail"]) == 2


def test_launch_training_runs_the_port_cli(tmp_path, monkeypatch):
    """The subprocess is the port's ``cli.train`` with the panel's flags."""
    seen = {}

    class FakePopen:
        def __init__(self, cmd, **kw):
            seen["cmd"], self.pid = cmd, 4242

    monkeypatch.setattr(monitor.subprocess, "Popen", FakePopen)
    st = monitor.launch_training(tmp_path / "runs" / "r", "data", ["--device", "cpu"], tmp_path)
    assert seen["cmd"][1:3] == ["-m", "siggan_tpu_torch.cli.train"]
    assert seen["cmd"][-2:] == ["--device", "cpu"] and st["pid"] == 4242
    assert monitor.read_training_state(tmp_path)["pid"] == 4242


# -- app core ---------------------------------------------------------------------

def make_checkpoint(workdir, num_classes: int = 0) -> TrainConfig:
    """A port run with one saved epoch under ``workdir/checkpoints``; the
    unconditional one is served through B4 (its plain version here)."""
    cfg = TrainConfig(model=ModelConfig(latent_dim=8, base_features=32,
                                        num_classes=num_classes),
                      batch_size=8, compute_dtype="float32", seed=0,
                      use_pallas=num_classes == 0,
                      checkpoint_dir=str(workdir / "checkpoints"))
    mgr = CheckpointManager(cfg.checkpoint_dir, cfg)
    mgr.save(create_train_state(cfg, "cpu"), epoch=0,
             fixed_noise=torch.zeros(4, 8), g_loss=1.0)
    return cfg


def wait_job(core, job_id, timeout=120):
    t0 = time.time()
    while time.time() - t0 < timeout:
        st = core.generate_status(job_id)
        if st.get("finished"):
            return st
        time.sleep(0.05)
    raise TimeoutError(core.generate_status(job_id))


def sample_dir(workdir, name="gen_t", n=5):
    d = workdir / "samples" / name
    d.mkdir(parents=True)
    for i in range(n):
        Image.fromarray(np.full((8, 8), 30 * i, np.uint8)).save(d / f"signature_{i:06d}.png")
    return d


def test_checkpoint_trust_model(tmp_path):
    core = core_at(tmp_path)
    with pytest.raises(PermissionError):
        core._validate_checkpoint("../outside")
    with pytest.raises(PermissionError):
        core._validate_checkpoint("/etc")
    (tmp_path / "checkpoints").mkdir()
    assert str(core._validate_checkpoint("checkpoints/foo")).startswith(str(tmp_path))


def test_find_checkpoints_lists_port_and_imported_runs(tmp_path):
    import shutil
    ckpt = tmp_path / "runs" / "r1" / "checkpoints"
    ckpt.mkdir(parents=True)
    (ckpt / "index.json").write_text(json.dumps({"epochs": [1, 3], "latest": 3, "best": 1}))
    (tmp_path / "runs" / "r2").mkdir()
    (tmp_path / "runs" / "r2" / "index.json").write_text(json.dumps({"something": 1}))
    shutil.copytree(FIXTURE_RUN, tmp_path / "checkpoints" / "imported")
    found = {f["path"]: f for f in core_at(tmp_path).find_checkpoints()}
    assert sorted(found) == ["checkpoints/imported", "runs/r1/checkpoints"]
    assert found["runs/r1/checkpoints"]["latest"] == 3
    idx = json.loads((FIXTURE_RUN / "index.json").read_text())
    assert found["checkpoints/imported"] == {"path": "checkpoints/imported",
                                             "epochs": idx["epochs"], "latest": idx["latest"],
                                             "best": idx.get("best")}


def test_imported_run_generates_through_the_kernel_path(tmp_path):
    """A JAX run imported by the script serves in the panel through B4 (its
    plain version on the CPU), a launch counted per batch only on a card."""
    import shutil
    shutil.copytree(FIXTURE_RUN, tmp_path / "checkpoints" / "imported")
    core = core_at(tmp_path)
    before = generator_fwd.LAUNCHES.count
    r = core.generate({"checkpoint": "checkpoints/imported", "n": 3, "seed": 1})
    assert r["count"] == 3 and core._session("checkpoints/imported").uses_kernel
    assert generator_fwd.LAUNCHES.count == before


def test_train_start_rejects_double_start(tmp_path):
    core = core_at(tmp_path)
    monitor.write_training_state(tmp_path, {
        "pid": os.getpid(), "run_dir": str(tmp_path), "stop_file": "s", "log_file": "l"})
    out = core.train_start({"data_dir": "x"})
    assert "error" in out and "already active" in out["error"]


def test_train_start_forwards_round3_flags(tmp_path, monkeypatch):
    core = core_at(tmp_path)
    captured = {}

    def fake_launch(run_dir, data_dir, extra, workdir):
        captured["extra"] = extra
        return {"pid": 1}

    monkeypatch.setattr(monitor, "launch_training", fake_launch)
    core.train_start({"data_dir": "x", "epochs": 5, "fid_interval": 10,
                      "lr_schedule": "linear", "ema_decay": 0.999,
                      "diffaugment": "translation,cutout",
                      "g_conditioning": "concat", "num_classes": 4,
                      "spectral_norm": True})
    extra = captured["extra"]
    for flag, val in (("--lr_schedule", "linear"), ("--diffaugment", "translation,cutout"),
                      ("--ema_decay", "0.999"), ("--fid_interval", "10"),
                      ("--g_conditioning", "concat"), ("--num_classes", "4"),
                      ("--device", "cpu")):
        assert val == extra[extra.index(flag) + 1]
    assert "--spectral_norm" in extra


def test_export_zip_trust_and_content(tmp_path):
    core = core_at(tmp_path)
    gen = tmp_path / "samples" / "gen_x"
    gen.mkdir(parents=True)
    Image.fromarray(np.zeros((8, 8), np.uint8)).save(gen / "a.png")
    assert zipfile.ZipFile(io.BytesIO(core.export_zip("samples/gen_x"))).namelist() == ["a.png"]
    with pytest.raises(PermissionError):
        core.export_zip("../etc")
    with pytest.raises(PermissionError):
        core.export_zip("runs")
    with pytest.raises(FileNotFoundError):
        core.export_zip("samples/nope")


def test_generation_job_runs_to_completion(tmp_path):
    make_checkpoint(tmp_path)
    core = core_at(tmp_path)
    r = core.generate_start({"checkpoint": "checkpoints", "n": 6, "batch_size": 3, "seed": 1})
    st = wait_job(core, r["job"])
    assert st["error"] is None
    assert st["done"] == 6 and st["kept"] == 6
    assert st["n_files"] == 6 and len(st["thumbnails"]) == 6


def test_generation_job_cancel_keeps_partials(tmp_path):
    make_checkpoint(tmp_path)
    core = core_at(tmp_path)
    r = core.generate_start({"checkpoint": "checkpoints", "n": 1000, "batch_size": 1,
                             "seed": 1})
    assert core.generate_cancel({"job": r["job"]})["cancelled"] is True
    st = wait_job(core, r["job"])
    assert st["cancelled"] and st["finished"]
    assert st["done"] < 1000
    assert st["n_files"] == st["done"]


def test_generation_job_quality_filter_top_k(tmp_path):
    make_checkpoint(tmp_path)
    core = core_at(tmp_path)
    r = core.generate_start({"checkpoint": "checkpoints", "n": 4, "batch_size": 4,
                             "quality_filter": True, "keep_fraction": 0.5})
    assert r["n_target"] == 8
    st = wait_job(core, r["job"])
    assert st["error"] is None
    assert st["kept"] == 4 and st["n_files"] == 4
    assert len(st["scores"]) == 4 and st["scores"] == sorted(st["scores"], reverse=True)


def test_generate_quality_filter_keeps_the_best_scored(tmp_path):
    """``generate`` with the filter: the n kept are D's top n of the
    oversampled batch, in order (D cached per checkpoint and which)."""
    make_checkpoint(tmp_path)
    core = core_at(tmp_path)
    r = core.generate({"checkpoint": "checkpoints", "n": 4, "seed": 3,
                       "quality_filter": True, "keep_fraction": 0.5})
    session = core._session("checkpoints")
    images = session.sample(8, seed=3)
    scores = session.score_with_discriminator(images, core._discriminator("checkpoints",
                                                                          "latest"))
    assert r["count"] == 4
    np.testing.assert_allclose(r["scores"], np.sort(scores)[::-1][:4], rtol=1e-6)
    assert list(core._discriminators) == ["checkpoints@latest"]


def test_gallery_pagination_and_selection_zip(tmp_path):
    sample_dir(tmp_path, n=5)
    core = core_at(tmp_path)
    g0 = core.gallery("samples/gen_t", page=0, page_size=2)
    assert g0["total"] == 5 and g0["pages"] == 3 and len(g0["items"]) == 2
    g2 = core.gallery("samples/gen_t", page=2, page_size=2)
    assert len(g2["items"]) == 1
    assert core.gallery("samples/gen_t", page=99, page_size=2)["page"] == 2
    sel = [g0["items"][0]["name"], g2["items"][0]["name"]]
    z = zipfile.ZipFile(io.BytesIO(core.gallery_zip({"dir": "samples/gen_t", "names": sel})))
    assert sorted(z.namelist()) == sorted(sel)
    z2 = zipfile.ZipFile(io.BytesIO(core.gallery_zip(
        {"dir": "samples/gen_t", "names": ["../../etc/passwd"]})))
    assert z2.namelist() == []
    with pytest.raises(PermissionError):
        core.gallery("runs", 0, 2)


def test_save_to_folder_with_binarize_transparency(tmp_path):
    sample_dir(tmp_path, n=3)
    core = core_at(tmp_path)
    r = core.save_to_folder({"dir": "samples/gen_t", "dest": "exports/out",
                             "binarize": True, "threshold": 100, "transparent": True})
    assert r["saved"] == 3
    saved = tmp_path / "exports" / "out" / r["names"][0]
    img = Image.open(saved)
    assert img.mode == "RGBA"
    rgba = decode_png(saved.read_bytes())
    np.testing.assert_array_equal(rgba, np.asarray(img))
    grey = np.asarray(Image.open(tmp_path / "samples" / "gen_t" / r["names"][0]).convert("L"))
    np.testing.assert_array_equal(rgba, j_postprocess_binarize(
        grey[None, ..., None], threshold=100, transparent=True)[0])


def test_contact_sheet(tmp_path):
    sample_dir(tmp_path, n=4)
    core = core_at(tmp_path)
    sheet = Image.open(io.BytesIO(core.contact_sheet_png("samples/gen_t")))
    assert sheet.size[0] > 8 and sheet.size[1] > 8
    with pytest.raises(FileNotFoundError):
        core.contact_sheet_png("samples/empty_nope")


def test_unsafe_mode_override(tmp_path):
    core = core_at(tmp_path)
    outside = tmp_path / "elsewhere" / "ckpt"
    outside.mkdir(parents=True)
    with pytest.raises(PermissionError):
        core._validate_checkpoint("elsewhere/ckpt")
    with pytest.raises(ValueError):
        core.set_unsafe_mode({"enabled": True})
    assert core.set_unsafe_mode({"enabled": True, "acknowledge": True})["unsafe_mode"] is True
    assert core._validate_checkpoint("elsewhere/ckpt") == outside.resolve()
    core.set_unsafe_mode({"enabled": False})
    with pytest.raises(PermissionError):
        core._validate_checkpoint("elsewhere/ckpt")


def test_runs_compare_chart(tmp_path):
    for name, g in (("a", 1.0), ("b", 2.0)):
        logs = tmp_path / "runs" / name / "logs"
        logs.mkdir(parents=True)
        (logs / "m.json").write_text(json.dumps({"metrics": [
            {"epoch": 0, "g_loss": g}, {"epoch": 1, "g_loss": g / 2}]}))
    core = core_at(tmp_path)
    png = core.runs_compare_png(["a", "b"])
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    assert decode_png(png).shape == (495, 880, 3)
    with pytest.raises(FileNotFoundError):
        core.runs_compare_png(["nope"])


def test_run_comparison_chart_draws_each_run(tmp_path):
    """One polyline a run in its colour and a legend strip; the JAX chart
    (matplotlib) of the same runs also writes a PNG."""
    runs = {"a": [{"epoch": e, "g_loss": 1.0 / (e + 1)} for e in range(5)],
            "b": [{"epoch": e, "g_loss": 0.2 + 0.1 * e} for e in range(3)],
            "c": [{"epoch": 0, "d_loss": 1.0}]}
    img = decode_png(plot_run_comparison(runs, tmp_path / "t.png").read_bytes())
    assert plot_run_comparison({}, tmp_path / "none.png") is None
    for colour in ((31, 119, 180), (255, 127, 14), (44, 160, 44)):
        assert (img == colour).all(-1).sum() > 200, colour     # line or legend swatch
    assert (img == (0, 0, 0)).all(-1).sum() > 1000            # axes and labels
    assert j_plot_run_comparison(runs, tmp_path / "j.png").exists()


def test_postprocess_binarize_matches_jax():
    u8 = np.random.default_rng(0).integers(0, 256, (3, 9, 7, 1), dtype=np.uint8)
    for threshold in (0, 100, 128, 254):
        for transparent in (False, True):
            np.testing.assert_array_equal(
                postprocess_binarize(u8, threshold, transparent),
                j_postprocess_binarize(u8, threshold, transparent))
    np.testing.assert_array_equal(postprocess_binarize(u8[..., 0], 90, True),
                                  j_postprocess_binarize(u8[..., 0], 90, True))


def test_minibatch_discrimination_matches_jax():
    params = minibatch.init_fn(torch.Generator().manual_seed(0), 24, 10, 5)
    assert params["T"].shape == (24, 50)
    x = np.random.default_rng(1).standard_normal((6, 24)).astype(np.float32)
    jparams = {"T": jnp.asarray(params["T"].numpy()), "out_features": 10, "kernel_dims": 5}
    want = np.asarray(jminibatch.apply_fn(jparams, jnp.asarray(x)))
    got = minibatch.apply_fn(params, torch.from_numpy(x))
    assert got.shape == (6, 34)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_about_reports_the_device(tmp_path):
    a = core_at(tmp_path).about()
    assert a["platform"] == "cpu" and a["memory"] is None and a["unsafe_mode"] is False


def test_panel_refuses_a_missing_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        AppCore(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        app_cli.main(["--workdir", str(tmp_path), "--port", "0"])


def test_http_surface_end_to_end(tmp_path):
    sample_dir(tmp_path, n=3)
    make_checkpoint(tmp_path)
    server = serve(host="127.0.0.1", port=0, workdir=tmp_path, device="cpu")
    port = server.server_address[1]
    assert port != 0
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{port}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=30) as r:
            return r.headers.get("Content-Type"), r.read()

    def post(path, body):
        req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.headers.get("Content-Type"), r.read()

    try:
        ct, body = get("/")
        assert ct.startswith("text/html") and b"siggan_tpu_torch" in body
        about = json.loads(get("/api/about")[1])
        assert "memory" in about and "unsafe_mode" in about
        assert json.loads(get("/api/checkpoints")[1])[0]["path"] == "checkpoints"
        assert json.loads(get("/api/gallery?dir=samples/gen_t&page=0&page_size=2")[1])[
            "total"] == 3
        assert get("/api/contact_sheet?dir=samples/gen_t")[0] == "image/png"
        ct, body = post("/api/gallery/zip", {"dir": "samples/gen_t"})
        assert ct == "application/zip"
        assert len(zipfile.ZipFile(io.BytesIO(body)).namelist()) == 3
        assert json.loads(post("/api/save", {"dir": "samples/gen_t"})[1])["saved"] == 3
        gen = json.loads(post("/api/generate", {"checkpoint": "checkpoints", "n": 2})[1])
        assert gen["count"] == 2 and len(gen["thumbnails"]) == 2
        frames = json.loads(post("/api/interpolate", {"checkpoint": "checkpoints",
                                                      "steps": 3})[1])["frames"]
        assert len(frames) == 3
        assert json.loads(post("/api/unsafe_mode",
                               {"enabled": True, "acknowledge": True})[1])["unsafe_mode"]
        req = urllib.request.Request(base + "/api/unsafe_mode",
                                     data=json.dumps({"enabled": True}).encode(),
                                     headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 422
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=10)
    assert not t.is_alive()


def test_generate_conditional_class_id(tmp_path):
    make_checkpoint(tmp_path, num_classes=3)
    core = core_at(tmp_path)
    assert core.generate({"checkpoint": "checkpoints", "n": 2, "class_id": 2})["count"] == 2
    r0 = core.generate({"checkpoint": "checkpoints", "n": 2, "seed": 7, "class_id": 0})
    r1 = core.generate({"checkpoint": "checkpoints", "n": 2, "seed": 7, "class_id": 1})
    assert r0["thumbnails"] != r1["thumbnails"]
    with pytest.raises(ValueError):
        core.generate({"checkpoint": "checkpoints", "n": 1, "class_id": 99})
