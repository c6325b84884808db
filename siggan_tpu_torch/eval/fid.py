"""Frechet Inception Distance, KID and precision/recall.

Port of the JAX package's ``eval/fid.py``: ``FIDScorer`` (``:21-103``)
extracts InceptionV3 pooled features in chunks on the card, in f32 with
TF32 off (``eval/common.py``); ``make_scorer`` (``:106-164``) builds one
from a backbone spec. The distances themselves (``frechet_distance``,
``kernel_distance``, ``precision_recall``, ``feature_diversity``; JAX
``:146-240``) are the same host numpy/scipy code in float64: an
(n1 x n2) SVD and a few n x n products once per evaluation, not a hot path.

The ``random-init`` backbone is ``inception.init_inception()``, the JAX
law from a torch generator, not the JAX package's draws: its FIDs compare
within the port only. Across packages, score with the same weights
(``torchvision:<file>`` in both, or the JAX tree loaded through
``bridge.inception_from_jax``). The ``verifier:<ckpt>`` backbone reads a
verifier pickle of either package, so its FIDs compare across packages.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from scipy import linalg

from siggan_tpu_torch.core.platform import DeviceLike, resolve_device
from siggan_tpu_torch.eval import inception
from siggan_tpu_torch.eval.common import batched_apply


class FIDScorer:
    def __init__(self, state_dict: Optional[Mapping] = None, batch_size: int = 32,
                 device: DeviceLike = "cuda",
                 extract_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                 backbone: Optional[str] = None):
        """InceptionV3 features on ``device``: a torchvision state dict when
        ``state_dict`` is given (tagged "torchvision"), the fixed-seed
        random init otherwise ("random-init"); the network is ``self.model``.
        Another feature space plugs in as ``extract_fn`` (NHWC images on
        ``device`` -> (N, D) features) with a ``backbone`` tag, as
        ``make_scorer("verifier:...")`` does."""
        self.device = resolve_device(device)
        self.batch_size = batch_size
        if extract_fn is not None:
            self.backbone, self._extract = backbone or "custom", extract_fn
            return
        self.backbone = "torchvision" if state_dict is not None else "random-init"
        model = (inception.init_inception() if state_dict is None else
                 inception.load_torchvision(inception.InceptionV3(), state_dict))
        self.model = model.to(self.device)

    def _extract(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(inception.prepare_images(x))

    def features(self, images) -> np.ndarray:
        """(N, H, W, 1|3) in [-1, 1] -> (N, D) f32 numpy."""
        return batched_apply(self._extract, images, batch_size=self.batch_size,
                             device=self.device)

    def kid(self, real: np.ndarray, fake: np.ndarray) -> Dict[str, float]:
        """Kernel Inception Distance in this scorer's feature space (the
        same real-set standardization as ``fid`` on the random backbone)."""
        fr, ff = self._conditioned_features(real, fake)
        return kernel_distance(fr, ff)

    def fid(self, real: np.ndarray, fake: np.ndarray) -> float:
        fr, ff = self._conditioned_features(real, fake)
        return frechet_distance(fr, ff)

    def fid_from_features(self, fr: np.ndarray, fake) -> float:
        """FID against a pre-extracted real feature matrix (``features()``
        output, unconditioned): the value of ``fid``, for callers that score
        many fake sets against one fixed real set (the trainer's FID)."""
        ff = self.features(fake)
        fr, ff = self._condition(np.asarray(fr), ff)
        return frechet_distance(fr, ff)

    def _conditioned_features(self, real, fake):
        return self._condition(self.features(real), self.features(fake))

    def _condition(self, fr: np.ndarray, ff: np.ndarray):
        if self.backbone == "random-init":
            # Standardize both sets by the real set's per-dimension stats: a
            # fixed affine map (still a Frechet metric, 0 for identical
            # sets) without which the random backbone compresses
            # real-vs-fake and real-vs-noise distances into a narrow band.
            # Comparable across runs of this backbone, not against
            # torchvision-FID bands.
            mu, sd = fr.mean(axis=0), fr.std(axis=0) + 1e-6
            fr = (fr - mu) / sd
            ff = (ff - mu) / sd
        return fr, ff


def make_scorer(spec: str = "random-init", batch_size: int = 32,
                device: DeviceLike = "cuda") -> FIDScorer:
    """A FID scorer from a backbone spec string.

    - ``"random-init"`` (default): the fixed-seed random InceptionV3, a
      relative metric standardized by the real set's feature stats.
    - ``"torchvision:<state_dict.pt>"``: pretrained InceptionV3 weights
      (``torch.load(weights_only=True)``, checked against the pinned
      manifest first), comparable to the reference's absolute FID bands.
    - ``"verifier:<ckpt.pkl>"``: a domain-trained backbone, the 512-d
      relu(fc1) features of a signature verifier's encoder
      (``verify/train.py``; a pickle of either package); colour images are
      averaged to grey and other sizes resized to the encoder's 64 px
      (bilinear, antialiased on a downscale, as ``jax.image.resize``).
      Its values form their own band: report the real-vs-real floor beside
      them (``eval/evaluate.py``).
    """
    if spec in (None, "", "random-init"):
        return FIDScorer(batch_size=batch_size, device=device)
    kind, _, path = spec.partition(":")
    if kind == "torchvision":
        from siggan_tpu_torch.eval.manifests import (INCEPTION_V3_REQUIRED,
                                                     INCEPTION_V3_SD, check_state_dict)
        sd = torch.load(path, map_location="cpu", weights_only=True)
        # Fail loudly, with a readable key/shape diff, on a wrong or
        # truncated file before it is loaded.
        check_state_dict(sd, INCEPTION_V3_SD, required=INCEPTION_V3_REQUIRED,
                         label=f"torchvision:{path}")
        return FIDScorer(state_dict=sd, batch_size=batch_size, device=device)
    if kind == "verifier":
        from siggan_tpu_torch.verify.models import IMAGE_SIZE
        from siggan_tpu_torch.verify.train import load_verifier, model_from_snapshot
        model = model_from_snapshot(load_verifier(path), device)
        s = IMAGE_SIZE

        def extract(x: torch.Tensor) -> torch.Tensor:
            if x.shape[-1] != 1:
                x = x.mean(dim=-1, keepdim=True)
            if x.shape[1] != s or x.shape[2] != s:
                x = F.interpolate(x.permute(0, 3, 1, 2), size=(s, s), mode="bilinear",
                                  align_corners=False, antialias=True).permute(0, 2, 3, 1)
            return model.encode(x, train=False, return_hidden=True)

        return FIDScorer(batch_size=batch_size, device=device, extract_fn=extract,
                         backbone=f"verifier:{path}")
    raise ValueError(f"unknown FID backbone spec: {spec!r}")


def feature_diversity(scorer: FIDScorer, images: np.ndarray,
                      window: int = 10) -> float:
    """Mean pairwise L2 feature distance over the reference's sliding
    window-of-10 pair scheme (``utils/metrics.py:103-115``) in the scorer's
    feature space: the trained-backbone analogue of LPIPS diversity."""
    n = len(images)
    if n < 2:
        return 0.0
    feats = scorer.features(np.asarray(images))
    dists = []
    for i in range(n):
        for j in range(i + 1, min(i + window, n)):
            dists.append(float(np.linalg.norm(feats[i] - feats[j])))
    return float(np.mean(dists))


def frechet_distance(feat1: np.ndarray, feat2: np.ndarray) -> float:
    """Frechet distance via the exact factored identity.

    With centred, 1/sqrt(n-1)-scaled data matrices A, B (so s_i = A^T A),
    the nonzero eigenvalues of s1 @ s2 are the squared singular values of
    A @ B^T, hence tr sqrtm(s1 @ s2) = sum svdvals(A @ B^T): exact and
    stable at any sample count (the textbook sqrtm of 2048^2 covariances
    returns finite garbage when n < 2048), an (n1 x n2) SVD. Identical sets
    give exactly 0.
    """
    feat1 = np.asarray(feat1, np.float64)
    feat2 = np.asarray(feat2, np.float64)
    mu1, mu2 = feat1.mean(axis=0), feat2.mean(axis=0)
    a = (feat1 - mu1) / np.sqrt(max(len(feat1) - 1, 1))
    b = (feat2 - mu2) / np.sqrt(max(len(feat2) - 1, 1))
    diff = mu1 - mu2
    tr1 = float(np.sum(a * a))           # tr(s1)
    tr2 = float(np.sum(b * b))           # tr(s2)
    tr_mean = float(np.sum(linalg.svdvals(a @ b.T)))
    fid = float(diff @ diff) + tr1 + tr2 - 2.0 * tr_mean
    return max(fid, 0.0)


def kernel_distance(feat1: np.ndarray, feat2: np.ndarray,
                    n_subsets: int = 10, subset_size: Optional[int] = None,
                    seed: int = 0) -> Dict[str, float]:
    """Kernel Inception Distance (Binkowski et al. 2018): unbiased MMD^2
    with the cubic polynomial kernel k(x, y) = (x.y/d + 1)^3, averaged over
    random subsets; unbiased at any sample count. Returns {"mean", "std"}
    over subsets (slightly negative for near-identical sets: the
    unbiasedness, not a fault)."""
    f1 = np.asarray(feat1, np.float64)
    f2 = np.asarray(feat2, np.float64)
    if min(len(f1), len(f2)) < 2:
        # The unbiased estimator divides by m*(m-1); a single sample has
        # no within-set term at all.
        raise ValueError("kernel_distance requires >= 2 samples per set")
    d = f1.shape[1]
    m = (min(subset_size, len(f1), len(f2)) if subset_size
         else min(len(f1), len(f2), 100))
    rs = np.random.RandomState(seed)
    vals = []
    for _ in range(n_subsets):
        x = f1[rs.choice(len(f1), m, replace=False)]
        y = f2[rs.choice(len(f2), m, replace=False)]
        kxx = (x @ x.T / d + 1.0) ** 3
        kyy = (y @ y.T / d + 1.0) ** 3
        kxy = (x @ y.T / d + 1.0) ** 3
        sum_off = lambda k: (k.sum() - np.trace(k)) / (m * (m - 1))  # noqa: E731
        vals.append(sum_off(kxx) + sum_off(kyy) - 2.0 * kxy.mean())
    return {"mean": float(np.mean(vals)), "std": float(np.std(vals))}


def precision_recall(real_feats: np.ndarray, fake_feats: np.ndarray,
                     k: int = 3) -> Dict[str, float]:
    """Improved precision and recall (Kynkaanniemi et al. 2019): k-NN
    radius manifolds in feature space. precision = the share of fake
    samples inside the real manifold (fidelity); recall = the share of real
    samples inside the fake manifold (coverage). Identical sets give
    1.0 / 1.0."""
    r = np.asarray(real_feats, np.float64)
    f = np.asarray(fake_feats, np.float64)

    def pairwise(a, b):
        return np.sqrt(np.maximum(
            (a * a).sum(1)[:, None] + (b * b).sum(1)[None] - 2 * a @ b.T, 0))

    def knn_radius(a):
        d = pairwise(a, a)
        np.fill_diagonal(d, np.inf)
        return np.sort(d, axis=1)[:, k - 1]          # distance to the k-th NN

    r_rad, f_rad = knn_radius(r), knn_radius(f)
    d_fr = pairwise(f, r)                             # fake x real
    precision = float((d_fr <= r_rad[None]).any(axis=1).mean())
    recall = float((d_fr.T <= f_rad[None]).any(axis=1).mean())
    return {"precision": precision, "recall": recall}
