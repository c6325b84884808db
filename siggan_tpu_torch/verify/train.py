"""Verifier training: BCE + 0.5 * contrastive, baseline against augmented.

Port of the JAX package's ``verify/train.py``: Adam(1e-3) with a StepLR
(x0.5 every 10 epochs, as optax's staircase ``exponential_decay`` over
``10 * steps_per_epoch`` updates, read at Adam's count before the
increment), loss = BCE(similarity logit, label) + 0.5 * contrastive (margin
2.0), accuracy at logit 0, the best-val-accuracy snapshot (a strict ``>``),
and ``train_model``: a BASELINE verifier on the real pairs and an AUGMENTED
one whose impostor pairs may draw GAN-generated signatures, the "does
synthetic data help?" experiment.

On the device: the pair arrays are moved once; each epoch's order is
``np.random.RandomState((seed, epoch)).permutation`` (the JAX order) and
each step gathers its rows on the device; the initial weights come from
the (seed, verifier init) CPU stream and the dropout masks from the (seed,
verifier dropout) stream of a generator on the device (``core/rng.py``;
JAX's threefry streams cannot be reproduced, so a seed trains other
weights than in JAX; ``train_step`` takes injected masks for the parity
tests); the metrics stay on the device
until the epoch's end. Training and scoring run in f32 with TF32 off
(``eval/common.py::full_f32``), so the card computes what the CPU does.

A verifier is saved as the JAX package saves it: a pickle of numpy trees
in JAX's layout, {params, bn, epoch, val_accuracy}, so a verifier trained
by either package scores in the other.
"""

from __future__ import annotations

import json
import pickle
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from siggan_tpu_torch import bridge
from siggan_tpu_torch.core import rng
from siggan_tpu_torch.core.platform import DeviceLike, resolve_device
from siggan_tpu_torch.core.state import Adam, OptState, StaircaseDecay
from siggan_tpu_torch.eval.common import batched_apply, full_f32
from siggan_tpu_torch.verify import models


@dataclass
class VerifierState:
    step: int
    model: models.Verifier       # parameters + BN running statistics
    tx: Adam
    opt: OptState


def make_optimizer(lr: float = 1e-3, step_size: int = 10, gamma: float = 0.5,
                   steps_per_epoch: int = 1) -> Adam:
    """optax's Adam (f32 moments) under a StepLR(step_size epochs, gamma)."""
    return Adam(StaircaseDecay(lr, step_size * steps_per_epoch, gamma), 0.9, 0.999,
                1e-8, "float32")


def create_state(seed: int, embedding_dim: int, tx: Adam,
                 device: DeviceLike = "cuda") -> VerifierState:
    dev = resolve_device(device)
    model = models.init_fn(rng.generator(seed, rng.STREAM_INIT_VERIFIER), embedding_dim, dev)
    return VerifierState(step=0, model=model, tx=tx, opt=tx.init(list(model.parameters())))


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax.sigmoid_binary_cross_entropy, per element."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def train_step(state: VerifierState, img1: torch.Tensor, img2: torch.Tensor,
               labels: torch.Tensor, *, use_contrastive: bool = True,
               masks: Optional[Sequence[torch.Tensor]] = None,
               gen: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """One update of ``state`` in place; returns the step's metrics as
    device scalars. Dropout masks are ``masks`` when given, else drawn from
    ``gen``."""
    model = state.model
    params = list(model.parameters())
    emb1, emb2, logits = model(img1, img2, train=True, masks=masks, gen=gen)
    bce = torch.mean(bce_with_logits(logits[:, 0], labels))
    closs = models.contrastive_loss(emb1, emb2, labels)
    loss = bce + 0.5 * closs if use_contrastive else bce
    grads = torch.autograd.grad(loss, params)
    state.tx.step(params, grads, state.opt)
    state.step += 1
    with torch.no_grad():
        acc = torch.mean(((logits[:, 0] > 0).float() == labels).float())
    return {"loss": loss.detach(), "bce_loss": bce.detach(),
            "contrastive_loss": closs.detach(), "accuracy": acc}


def predict_scores(model: models.Verifier, img1, img2, batch_size: int = 128) -> np.ndarray:
    """Similarity scores in [0, 1] of eval-mode pairs, in chunks on the
    model's device."""
    dev = next(model.parameters()).device
    return batched_apply(lambda a, b: torch.sigmoid(model(a, b, train=False)[2][:, 0]),
                         img1, img2, batch_size=batch_size, device=dev)


def evaluate(model: models.Verifier, data, batch_size: int = 128) -> Dict[str, float]:
    img1, img2, labels = data
    scores = predict_scores(model, img1, img2, batch_size)
    preds = (scores > 0.5).astype(np.float32)
    eps = 1e-12
    p = np.clip(scores, eps, 1 - eps)
    bce = float(-np.mean(labels * np.log(p) + (1 - labels) * np.log(1 - p)))
    return {"loss": bce, "accuracy": float((preds == labels).mean())}


def snapshot(model: models.Verifier, epoch: int, val_accuracy: float) -> Dict:
    """The checkpoint tree: JAX-layout numpy params and BN state."""
    params, bn = bridge.verifier_to_jax(model)
    return {"params": params, "bn": bn, "epoch": epoch, "val_accuracy": val_accuracy}


def train_verifier(train_data, val_data, *, epochs: int = 20,
                   batch_size: int = 32, lr: float = 1e-3,
                   embedding_dim: int = 128, seed: int = 0,
                   use_contrastive: bool = True,
                   save_path: Optional[str | Path] = None,
                   log: bool = True, device: DeviceLike = "cuda"
                   ) -> Tuple[VerifierState, Dict]:
    """Train one verifier; returns (the state holding the best-val-accuracy
    weights, history). ``history`` has JAX's "train" and "val" lists and
    the port's "epoch_seconds" (the train steps of each epoch, host clock
    to the metrics' arrival)."""
    dev = resolve_device(device)
    img1, img2, labels = train_data
    n = len(labels)
    steps_per_epoch = max(1, n // batch_size)
    state = create_state(seed, embedding_dim, make_optimizer(lr, steps_per_epoch=steps_per_epoch),
                         dev)
    gen = rng.reseed(torch.Generator(device=dev), seed, rng.STREAM_DROPOUT_VERIFIER)
    d_img1, d_img2, d_lab = (torch.from_numpy(np.asarray(a, np.float32)).to(dev)
                             for a in (img1, img2, labels))

    best_acc = -1.0
    best = None
    history: Dict = {"train": [], "val": [], "epoch_seconds": []}
    keys = ("loss", "bce_loss", "contrastive_loss", "accuracy")
    with full_f32():
        for epoch in range(epochs):
            t0 = time.perf_counter()
            order = torch.from_numpy(np.random.RandomState((seed, epoch)).permutation(n)).to(dev)
            dev_metrics = []
            for b in range(steps_per_epoch):
                sel = order[b * batch_size:(b + 1) * batch_size]
                m = train_step(state, d_img1[sel], d_img2[sel], d_lab[sel],
                               use_contrastive=use_contrastive, gen=gen)
                dev_metrics.append(torch.stack([m[k] for k in keys]))
            per_step = torch.stack(dev_metrics).cpu().numpy().astype(np.float64)
            history["epoch_seconds"].append(time.perf_counter() - t0)
            tr = {k: float(np.mean(per_step[:, i])) for i, k in enumerate(keys)}
            va = evaluate(state.model, val_data)
            history["train"].append(tr)
            history["val"].append(va)
            if log:
                ms = history["epoch_seconds"][-1] * 1e3 / steps_per_epoch
                print(f"epoch {epoch}: train_loss {tr['loss']:.4f} "
                      f"train_acc {tr['accuracy']:.3f} val_acc {va['accuracy']:.3f} "
                      f"({ms:.3f} ms/step)", flush=True)
            if va["accuracy"] > best_acc:
                best_acc = va["accuracy"]
                best = snapshot(state.model, epoch, va["accuracy"])
    if save_path and best is not None:
        save_verifier(best, save_path)
    if best is not None:
        state.model = model_from_snapshot(best, dev)
    return state, history


def save_verifier(snap: Dict, path: str | Path) -> Path:
    """Pickle a snapshot as numpy arrays (the JAX package's format)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)

    def arrays(t):
        if isinstance(t, dict):
            return {k: arrays(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(arrays(v) for v in t)
        return np.asarray(t)
    with open(path, "wb") as f:
        pickle.dump(arrays(snap), f)
    return path


def load_verifier(path: str | Path) -> Dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def model_from_snapshot(snap: Dict, device: DeviceLike = "cuda") -> models.Verifier:
    return bridge.verifier_from_jax(snap["params"], snap["bn"], resolve_device(device))


def train_model(data_dir: str, synthetic_dir: Optional[str], output_dir: str,
                *, epochs: int = 20, batch_size: int = 32, lr: float = 1e-3,
                pairs_per_user: int = 10, seed: int = 0,
                embedding_dim: int = 128, device: DeviceLike = "cuda") -> Dict:
    """The experiment: baseline (real only) and augmented (real +
    synthetic) verifiers, 80/20 split, best-val checkpoints
    (``verifier_{name}.pkl``) and ``training_history.json``."""
    from siggan_tpu_torch.verify.pairs import PairDataset

    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    results = {}
    for name, sdir in (("baseline", None), ("augmented", synthetic_dir)):
        if name == "augmented" and not synthetic_dir:
            continue
        ds = PairDataset(data_dir, sdir, pairs_per_user, seed=seed)
        print(f"[{name}] {ds.summary()}", flush=True)
        train_data, val_data = ds.split(0.2, seed=seed)
        t0 = time.perf_counter()
        _, history = train_verifier(
            train_data, val_data, epochs=epochs, batch_size=batch_size,
            lr=lr, seed=seed, embedding_dim=embedding_dim,
            save_path=out / f"verifier_{name}.pkl", device=device)
        results[name] = {"history": history,
                         "best_val_accuracy": max(v["accuracy"] for v in history["val"]),
                         "seconds": time.perf_counter() - t0,
                         "steps": epochs * max(1, len(train_data[2]) // batch_size)}
    (out / "training_history.json").write_text(json.dumps(results, indent=2))
    return results
