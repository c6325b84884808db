"""Pinned state-dict manifests for the pretrained metric backbones.

The port's copy of the JAX package's ``eval/manifests.py:1-237`` (numpy
only; the port imports nothing of that package). The repository ships no
pretrained weights, so the proof that a published weight file loads is the
COMPLETE key -> shape manifest of the exact checkpoint files the reference
loads, and tests of the loaders against synthetic state dicts built from
those manifests (every key present, every shape real, including the keys
the loaders must tolerate and ignore).

Sources (documented, not fetched):

* ``INCEPTION_V3_SD``: torchvision ``inception_v3`` /
  ``Inception_V3_Weights.IMAGENET1K_V1`` — file
  ``inception_v3_google-0cc3c7bd.pth`` (the 8-hex filename suffix is
  torchvision's SHA256-prefix convention, pinned below).  Architecture
  per ``torchvision/models/inception.py`` (BasicConv2d = conv + BN;
  Mixed_5* = InceptionA, 6a = B, 6b..6e = C, 7a = D, 7b/7c = E;
  AuxLogits = InceptionAux; final ``fc`` 2048 -> 1000).  The reference
  loads exactly this model and replaces ``fc`` with Identity
  (the reference's ``utils/metrics.py:23-30``).
* ``ALEXNET_SD``: torchvision ``alexnet`` / ``AlexNet_Weights.IMAGENET1K_V1``
  — file ``alexnet-owt-7be5be79.pth``; LPIPS taps ``features.*`` only but
  the real file also carries ``classifier.{1,4,6}``.
* ``LPIPS_ALEX_LIN_SD``: richzhang/PerceptualSimilarity v0.1 ``alex.pth``
  (lpips pip package ``lpips/weights/v0.1/alex.pth``) — five learned 1x1
  linear layers named ``lin{i}.model.1.weight`` over the relu1..relu5 tap
  channel widths.  The reference loads it via ``lpips.LPIPS(net='alex')``
  (the reference's ``utils/metrics.py:100``).

Each manifest maps ``state_dict`` key -> torch tensor shape (OIHW for conv
weights).  ``*.bn.num_batches_tracked`` entries are scalar int64 counters
(shape ``()``) that converters must ignore.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

# torchvision's filename convention embeds the first 8 hex chars of the
# file's SHA256; verifying a dropped file against these is free.
INCEPTION_V3_FILE = "inception_v3_google-0cc3c7bd.pth"
INCEPTION_V3_SHA256_PREFIX = "0cc3c7bd"
ALEXNET_FILE = "alexnet-owt-7be5be79.pth"
ALEXNET_SHA256_PREFIX = "7be5be79"
LPIPS_ALEX_FILE = "lpips/weights/v0.1/alex.pth"  # no hash convention upstream

Shape = Tuple[int, ...]


def _bconv(prefix: str, cout: int, cin: int, kh: int, kw: int) -> Dict[str, Shape]:
    """BasicConv2d entries exactly as torchvision serializes them."""
    return {
        f"{prefix}.conv.weight": (cout, cin, kh, kw),
        f"{prefix}.bn.weight": (cout,),
        f"{prefix}.bn.bias": (cout,),
        f"{prefix}.bn.running_mean": (cout,),
        f"{prefix}.bn.running_var": (cout,),
        f"{prefix}.bn.num_batches_tracked": (),
    }


def _inception_v3_manifest() -> Dict[str, Shape]:
    m: Dict[str, Shape] = {}
    # Stem.
    m.update(_bconv("Conv2d_1a_3x3", 32, 3, 3, 3))
    m.update(_bconv("Conv2d_2a_3x3", 32, 32, 3, 3))
    m.update(_bconv("Conv2d_2b_3x3", 64, 32, 3, 3))
    m.update(_bconv("Conv2d_3b_1x1", 80, 64, 1, 1))
    m.update(_bconv("Conv2d_4a_3x3", 192, 80, 3, 3))
    # InceptionA: Mixed_5b/5c/5d.
    for name, cin, pool in (("Mixed_5b", 192, 32), ("Mixed_5c", 256, 64),
                            ("Mixed_5d", 288, 64)):
        m.update(_bconv(f"{name}.branch1x1", 64, cin, 1, 1))
        m.update(_bconv(f"{name}.branch5x5_1", 48, cin, 1, 1))
        m.update(_bconv(f"{name}.branch5x5_2", 64, 48, 5, 5))
        m.update(_bconv(f"{name}.branch3x3dbl_1", 64, cin, 1, 1))
        m.update(_bconv(f"{name}.branch3x3dbl_2", 96, 64, 3, 3))
        m.update(_bconv(f"{name}.branch3x3dbl_3", 96, 96, 3, 3))
        m.update(_bconv(f"{name}.branch_pool", pool, cin, 1, 1))
    # InceptionB: Mixed_6a.
    m.update(_bconv("Mixed_6a.branch3x3", 384, 288, 3, 3))
    m.update(_bconv("Mixed_6a.branch3x3dbl_1", 64, 288, 1, 1))
    m.update(_bconv("Mixed_6a.branch3x3dbl_2", 96, 64, 3, 3))
    m.update(_bconv("Mixed_6a.branch3x3dbl_3", 96, 96, 3, 3))
    # InceptionC: Mixed_6b..6e (c7 = 128/160/160/192).
    for name, c7 in (("Mixed_6b", 128), ("Mixed_6c", 160),
                     ("Mixed_6d", 160), ("Mixed_6e", 192)):
        m.update(_bconv(f"{name}.branch1x1", 192, 768, 1, 1))
        m.update(_bconv(f"{name}.branch7x7_1", c7, 768, 1, 1))
        m.update(_bconv(f"{name}.branch7x7_2", c7, c7, 1, 7))
        m.update(_bconv(f"{name}.branch7x7_3", 192, c7, 7, 1))
        m.update(_bconv(f"{name}.branch7x7dbl_1", c7, 768, 1, 1))
        m.update(_bconv(f"{name}.branch7x7dbl_2", c7, c7, 7, 1))
        m.update(_bconv(f"{name}.branch7x7dbl_3", c7, c7, 1, 7))
        m.update(_bconv(f"{name}.branch7x7dbl_4", c7, c7, 7, 1))
        m.update(_bconv(f"{name}.branch7x7dbl_5", 192, c7, 1, 7))
        m.update(_bconv(f"{name}.branch_pool", 192, 768, 1, 1))
    # InceptionAux (present in the published file; converter must ignore).
    m.update(_bconv("AuxLogits.conv0", 128, 768, 1, 1))
    m.update(_bconv("AuxLogits.conv1", 768, 128, 5, 5))
    m["AuxLogits.fc.weight"] = (1000, 768)
    m["AuxLogits.fc.bias"] = (1000,)
    # InceptionD: Mixed_7a.
    m.update(_bconv("Mixed_7a.branch3x3_1", 192, 768, 1, 1))
    m.update(_bconv("Mixed_7a.branch3x3_2", 320, 192, 3, 3))
    m.update(_bconv("Mixed_7a.branch7x7x3_1", 192, 768, 1, 1))
    m.update(_bconv("Mixed_7a.branch7x7x3_2", 192, 192, 1, 7))
    m.update(_bconv("Mixed_7a.branch7x7x3_3", 192, 192, 7, 1))
    m.update(_bconv("Mixed_7a.branch7x7x3_4", 192, 192, 3, 3))
    # InceptionE: Mixed_7b/7c.
    for name, cin in (("Mixed_7b", 1280), ("Mixed_7c", 2048)):
        m.update(_bconv(f"{name}.branch1x1", 320, cin, 1, 1))
        m.update(_bconv(f"{name}.branch3x3_1", 384, cin, 1, 1))
        m.update(_bconv(f"{name}.branch3x3_2a", 384, 384, 1, 3))
        m.update(_bconv(f"{name}.branch3x3_2b", 384, 384, 3, 1))
        m.update(_bconv(f"{name}.branch3x3dbl_1", 448, cin, 1, 1))
        m.update(_bconv(f"{name}.branch3x3dbl_2", 384, 448, 3, 3))
        m.update(_bconv(f"{name}.branch3x3dbl_3a", 384, 384, 1, 3))
        m.update(_bconv(f"{name}.branch3x3dbl_3b", 384, 384, 3, 1))
        m.update(_bconv(f"{name}.branch_pool", 192, cin, 1, 1))
    # Classifier head (replaced with Identity by the reference, but present
    # in the published file; converter must ignore).
    m["fc.weight"] = (1000, 2048)
    m["fc.bias"] = (1000,)
    return m


INCEPTION_V3_SD: Dict[str, Shape] = _inception_v3_manifest()

# torchvision alexnet — LPIPS taps features.{0,3,6,8,10}; classifier keys
# are in the published file and must be tolerated.
ALEXNET_SD: Dict[str, Shape] = {
    "features.0.weight": (64, 3, 11, 11), "features.0.bias": (64,),
    "features.3.weight": (192, 64, 5, 5), "features.3.bias": (192,),
    "features.6.weight": (384, 192, 3, 3), "features.6.bias": (384,),
    "features.8.weight": (256, 384, 3, 3), "features.8.bias": (256,),
    "features.10.weight": (256, 256, 3, 3), "features.10.bias": (256,),
    "classifier.1.weight": (4096, 9216), "classifier.1.bias": (4096,),
    "classifier.4.weight": (4096, 4096), "classifier.4.bias": (4096,),
    "classifier.6.weight": (1000, 4096), "classifier.6.bias": (1000,),
}

# richzhang v0.1 alex.pth — learned non-negative 1x1 linears over the
# relu1..relu5 tap widths (64, 192, 384, 256, 256).
LPIPS_ALEX_LIN_SD: Dict[str, Shape] = {
    f"lin{i}.model.1.weight": (1, c, 1, 1)
    for i, c in enumerate((64, 192, 384, 256, 256))
}


def synthetic_state_dict(manifest: Dict[str, Shape], seed: int = 0,
                         torch_tensors: bool = False) -> Dict:
    """Random state dict with EXACTLY the manifest's keys and shapes.

    ``running_var`` / ``bn.weight`` entries are kept positive (valid BN);
    ``num_batches_tracked`` entries are int64 scalars, as in the real file.
    """
    rs = np.random.RandomState(seed)
    sd = {}
    for key, shape in manifest.items():
        if key.endswith("num_batches_tracked"):
            v = np.asarray(1000, np.int64)
        elif key.endswith(("running_var",)) or key.endswith("bn.weight"):
            v = (rs.rand(*shape) + 0.5).astype(np.float32)
        elif key.startswith("lin") and key.endswith(".weight"):
            # lpips lin layers are trained under a non-negativity clamp
            # (richzhang/PerceptualSimilarity lpips.py) — keep that true.
            v = rs.rand(*shape).astype(np.float32)
        else:
            v = (rs.randn(*shape) * 0.1).astype(np.float32)
        if torch_tensors:
            import torch
            # as_tensor keeps 0-d scalars 0-d (ascontiguousarray would
            # promote the num_batches_tracked counters to shape (1,)).
            v = torch.as_tensor(v)
        sd[key] = v
    return sd


# Keys the FID feature extractor actually consumes: every manifest entry
# except the classifier/aux heads (the reference replaces fc with Identity,
# metrics.py:29, so fc/AuxLogits-stripped exports are legitimate) and the
# num_batches_tracked counters.
INCEPTION_V3_REQUIRED: Dict[str, Shape] = {
    k: s for k, s in INCEPTION_V3_SD.items()
    if not k.startswith(("AuxLogits.", "fc."))
    and not k.endswith("num_batches_tracked")
}
ALEXNET_REQUIRED: Dict[str, Shape] = {
    k: s for k, s in ALEXNET_SD.items() if k.startswith("features.")
}


def check_state_dict(sd: Dict, manifest: Dict[str, Shape],
                     required: Dict[str, Shape] | None = None,
                     label: str = "state dict") -> None:
    """Raise with a readable diff if ``sd`` does not carry the manifest.

    Checks run BEFORE conversion so a weight drop that is the wrong file
    (different model, truncated download, renamed keys) fails loudly with
    the exact missing/mismatched keys instead of a KeyError deep in the
    converter.  ``required`` (default: all of ``manifest``) is the subset
    whose PRESENCE is mandatory — heads the converter ignores may be
    legitimately stripped; extra keys are always allowed.  Every key that
    IS present and known to the manifest is shape-checked.
    """
    need = manifest if required is None else required
    missing = [k for k in need if k not in sd]
    if missing:
        raise ValueError(
            f"{label}: {len(missing)} required keys missing "
            f"(first 5: {missing[:5]}) — wrong or truncated checkpoint?")
    bad = []
    for k, shape in manifest.items():
        if k not in sd:
            continue
        v = sd[k]
        got = tuple(v.shape) if hasattr(v, "shape") else np.shape(v)
        if tuple(got) != tuple(shape):
            bad.append((k, tuple(got), tuple(shape)))
    if bad:
        k, got, want = bad[0]
        raise ValueError(
            f"{label}: {len(bad)} keys with wrong shapes — e.g. {k}: "
            f"got {got}, manifest says {want}")


def verify_file_sha256(path, expected_prefix: str) -> bool:
    """True iff the file's SHA256 starts with ``expected_prefix`` —
    torchvision's filename convention, checked at weight-drop time."""
    import hashlib
    import pathlib
    h = hashlib.sha256(pathlib.Path(path).read_bytes()).hexdigest()
    return h.startswith(expected_prefix.lower())
