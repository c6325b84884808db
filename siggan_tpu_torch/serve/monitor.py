"""Training-run monitoring over the filesystem protocol.

Port of the JAX package's ``serve/monitor.py``. The panel and the trainer
talk only through files: a training-state JSON with PID liveness checks, log
tailing, a metrics discovery cascade JSON -> CSV -> log parse, stop files,
and the loss-health heuristics of ``train/collapse.py``. Any frontend (the
panel, a notebook, a shell) can attach to a running or finished run. The
training subprocess is the port's ``cli.train``, on the device the panel
names.
"""

from __future__ import annotations

import csv
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

from siggan_tpu_torch.train.collapse import check_loss_health

STATE_FILE = ".training_state.json"


# -- pid liveness --------------------------------------------------------------

def pid_alive(pid: int) -> bool:
    """Whether process ``pid`` runs. A child of this process that has
    exited is reaped here: unreaped, it would stay a zombie that answers
    signal 0, and a panel that started a run would never see it end."""
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    try:
        done, _ = os.waitpid(pid, os.WNOHANG)
    except ChildProcessError:      # not our child: signal 0 answered
        return True
    return done == 0


# -- training state ----------------------------------------------------------

def state_path(workdir: str | Path) -> Path:
    return Path(workdir) / STATE_FILE


def write_training_state(workdir: str | Path, state: Dict[str, Any]) -> None:
    state_path(workdir).write_text(json.dumps(state, indent=2))


def read_training_state(workdir: str | Path) -> Optional[Dict[str, Any]]:
    p = state_path(workdir)
    if not p.exists():
        return None
    try:
        state = json.loads(p.read_text())
    except json.JSONDecodeError:
        return None
    state["alive"] = pid_alive(int(state.get("pid", -1)))
    return state


def clear_stale_state(workdir: str | Path) -> bool:
    """Garbage-collect state whose PID is gone."""
    state = read_training_state(workdir)
    if state is not None and not state["alive"]:
        state_path(workdir).unlink(missing_ok=True)
        return True
    return False


# -- launching / stopping -----------------------------------------------------

def launch_training(run_dir: str | Path, data_dir: str,
                    extra_args: Optional[List[str]] = None,
                    workdir: str | Path = ".") -> Dict[str, Any]:
    """Spawn the port's training CLI as a logged subprocess (its flags in
    ``extra_args``, ``--device`` among them)."""
    run_dir = Path(run_dir)
    (run_dir / "logs").mkdir(parents=True, exist_ok=True)
    log_file = run_dir / "logs" / "training_output.log"
    stop_file = run_dir / "STOP"
    stop_file.unlink(missing_ok=True)
    cmd = [sys.executable, "-m", "siggan_tpu_torch.cli.train",
           "--data_dir", str(data_dir), "--run_dir", str(run_dir),
           "--stop_file", str(stop_file)] + list(extra_args or [])
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    with open(log_file, "ab") as lf:
        proc = subprocess.Popen(cmd, stdout=lf, stderr=subprocess.STDOUT,
                                env=env, cwd=str(Path.cwd()))
    state = {
        "pid": proc.pid,
        "run_dir": str(run_dir),
        "data_dir": str(data_dir),
        "log_file": str(log_file),
        "stop_file": str(stop_file),
        "started": time.time(),
        "cmd": cmd,
    }
    write_training_state(workdir, state)
    return state


def request_stop(workdir: str | Path = ".") -> bool:
    """Cooperative stop via the stop file."""
    state = read_training_state(workdir)
    if not state:
        return False
    Path(state["stop_file"]).write_text("stop requested %s" % time.ctime())
    return True


def kill_training(workdir: str | Path = ".") -> bool:
    state = read_training_state(workdir)
    if not state or not state["alive"]:
        return False
    os.kill(int(state["pid"]), signal.SIGTERM)
    return True


# -- log tail / metrics discovery ---------------------------------------------

def tail_file(path: str | Path, n_lines: int = 50) -> List[str]:
    p = Path(path)
    if not p.exists():
        return []
    try:
        data = p.read_bytes()[-65536:]
    except OSError:
        return []
    return data.decode(errors="replace").splitlines()[-n_lines:]


def discover_metrics(run_dir: str | Path) -> List[Dict[str, Any]]:
    """The metrics of a run: the logger's JSON, else its CSV, else the
    console lines ``Epoch N | key: value | ...`` of its log."""
    run_dir = Path(run_dir)
    logs = run_dir / "logs"
    # 1) logger JSON
    for jf in sorted(logs.glob("*.json"), reverse=True):
        try:
            data = json.loads(jf.read_text())
            if isinstance(data, dict) and data.get("metrics"):
                return data["metrics"]
        except (json.JSONDecodeError, OSError):
            continue
    # 2) logger CSV
    for cf in sorted(logs.glob("*.csv"), reverse=True):
        try:
            with open(cf) as f:
                rows = list(csv.DictReader(f))
            if rows:
                return [{k: _maybe_float(v) for k, v in r.items()}
                        for r in rows]
        except OSError:
            continue
    # 3) console-line parse ("Epoch N | d_loss: x | ...")
    metrics = []
    for line in tail_file(logs / "training_output.log", 2000):
        if line.startswith("Epoch ") and "|" in line:
            try:
                parts = [p.strip() for p in line.split("|")]
                entry: Dict[str, Any] = {"epoch": int(parts[0].split()[1])}
                for p in parts[1:]:
                    k, v = p.split(":")
                    entry[k.strip()] = float(v)
                metrics.append(entry)
            except (ValueError, IndexError):
                continue
    return metrics


def _maybe_float(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return v


def run_status(workdir: str | Path = ".") -> Dict[str, Any]:
    """Everything a monitor page needs, in one call."""
    state = read_training_state(workdir)
    if state is None:
        return {"running": False, "state": None}
    run_dir = Path(state["run_dir"])
    metrics = discover_metrics(run_dir)
    # Keep only real numbers: a CSV read mid-rewrite (the logger rewrites
    # the whole file each save) or a DictWriter-restval row yields '' which
    # math.isnan() would TypeError on inside check_loss_health.
    d = [v for m in metrics if isinstance(
        (v := m.get("d_loss")), (int, float))]
    g = [v for m in metrics if isinstance(
        (v := m.get("g_loss")), (int, float))]
    samples = sorted((run_dir / "samples").glob("*.png"))
    return {
        "running": state["alive"],
        "state": state,
        "metrics": metrics,
        "health": check_loss_health(d, g),
        "log_tail": tail_file(state["log_file"], 40),
        "latest_sample": str(samples[-1]) if samples else None,
        "epochs_done": len(metrics),
    }


def list_runs(runs_root: str | Path = "runs") -> List[Dict[str, Any]]:
    """The run history: each run under ``runs_root`` with its metrics,
    checkpoints and samples."""
    root = Path(runs_root)
    out = []
    if not root.is_dir():
        return out
    for run in sorted(root.iterdir(), reverse=True):
        if not run.is_dir():
            continue
        metrics = discover_metrics(run)
        ckpt_index = run / "checkpoints" / "index.json"
        out.append({
            "name": run.name,
            "path": str(run),
            "epochs": len(metrics),
            "last_metrics": metrics[-1] if metrics else None,
            "has_checkpoints": ckpt_index.exists(),
            "n_samples": len(list((run / "samples").glob("*.png"))),
        })
    return out
