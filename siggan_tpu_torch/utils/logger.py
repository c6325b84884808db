"""Per-epoch metric logger: console line + CSV + JSON (a pure-Python copy
of the JAX package's ``utils/logger.py``).

Parity with ``utils/logger.py:10-95`` (GANLogger): timestamped experiment
name, append-a-dict-per-epoch, CSV and JSON writers, summary stats. Adds
throughput fields (images/sec, step time) as first-class metrics — the
observability the reference lacks (SURVEY §5 tracing gap).

In a data-parallel run only rank 0 writes (as the JAX trainer writes its
logs on process 0): the other ranks' loggers take ``write=False``, keep
their metrics in memory and write and print nothing.
"""

from __future__ import annotations

import csv
import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional


class GANLogger:
    def __init__(self, log_dir: str | Path, experiment_name: Optional[str] = None,
                 write: bool = True):
        stamp = time.strftime("%Y%m%d_%H%M%S")
        self.experiment_name = experiment_name or f"gan_training_{stamp}"
        self.log_dir = Path(log_dir)
        self.write = write
        if write:
            self.log_dir.mkdir(parents=True, exist_ok=True)
        self.metrics: List[Dict[str, Any]] = []
        self.config: Dict[str, Any] = {}
        self.start_time = time.time()

    def log_config(self, config: Dict[str, Any]) -> None:
        self.config = dict(config)

    def log_metrics(self, epoch: int, metrics: Dict[str, Any],
                    echo: bool = True) -> None:
        entry = {"epoch": epoch, "wall_time": round(time.time() - self.start_time, 2)}
        entry.update({k: (float(v) if hasattr(v, "__float__") else v)
                      for k, v in metrics.items()})
        self.metrics.append(entry)
        if echo and self.write:
            parts = [f"Epoch {epoch}"] + [
                f"{k}: {v:.4f}" for k, v in entry.items()
                if isinstance(v, float) and k != "wall_time"]
            print(" | ".join(parts), flush=True)

    # -- persistence ----------------------------------------------------
    def save_to_csv(self, filename: Optional[str] = None) -> Optional[Path]:
        if not self.write:
            return None
        path = self.log_dir / (filename or f"{self.experiment_name}.csv")
        if not self.metrics:
            path.write_text("")
            return path
        keys: List[str] = []
        for m in self.metrics:
            for k in m:
                if k not in keys:
                    keys.append(k)
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys)
            w.writeheader()
            w.writerows(self.metrics)
        return path

    def save_to_json(self, filename: Optional[str] = None) -> Optional[Path]:
        if not self.write:
            return None
        path = self.log_dir / (filename or f"{self.experiment_name}.json")
        path.write_text(json.dumps(
            {"experiment": self.experiment_name, "config": self.config,
             "metrics": self.metrics}, indent=2))
        return path

    def get_summary(self) -> Dict[str, Any]:
        if not self.metrics:
            return {"epochs_logged": 0}
        num_keys = {k for m in self.metrics for k, v in m.items()
                    if isinstance(v, (int, float)) and k != "epoch"}
        summary: Dict[str, Any] = {"epochs_logged": len(self.metrics)}
        for k in sorted(num_keys):
            vals = [m[k] for m in self.metrics if k in m]
            summary[k] = {"last": vals[-1], "min": min(vals), "max": max(vals),
                          "mean": sum(vals) / len(vals)}
        return summary
