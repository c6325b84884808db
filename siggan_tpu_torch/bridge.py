"""Weight bridge between the JAX package's generator trees and the port.

The JAX package keeps the generator as two trees of arrays:
``g_params`` = {fc: {w (in, out), b}, fc_bn: {scale, offset},
blocks: [{w (4, 4, Cin, Cout) HWIO, bn: {scale, offset}}],
final: {w (3, 3, C, img_c) HWIO, b}, embed (classes, latent) if any} and
``g_bn`` = {fc_bn: {mean, var}, blocks: [{mean, var}]}. Here they are plain
numpy arrays in those layouts; the port's ``Generator`` stores PyTorch
layouts: Linear (out, in), ConvT (Cin, Cout, kh, kw), conv OIHW.

The fc output is reshaped to (N, 4, 4, C0) in HWC order on both sides (the
port keeps NHWC activations), so the 4096 fc columns and the fc BN vectors
need no permutation: only the weight's (in, out) -> (out, in) transpose.

``flatten``/``unflatten`` give the trees as one flat mapping keyed by tree
path (``fc/w``, ``blocks/0/w``, ``bn/blocks/0/mean``, ...), the layout of the
port's ``generator.npz``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from siggan_tpu_torch.core.config import ModelConfig
from siggan_tpu_torch.models.generator import Generator


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def from_jax(g_params: Dict, g_bn: Dict, cfg: ModelConfig, device=None) -> Generator:
    """JAX-layout trees (numpy arrays) -> a port ``Generator`` on ``device``."""
    model = Generator(cfg, device)
    with torch.no_grad():
        model.fc.weight.copy_(_t(g_params["fc"]["w"]).t())
        model.fc.bias.copy_(_t(g_params["fc"]["b"]))
        bns = [(model.fc_bn, g_params["fc_bn"], g_bn["fc_bn"])]
        for blk, p, st in zip(model.blocks, g_params["blocks"], g_bn["blocks"]):
            blk.weight.copy_(_t(p["w"]).permute(2, 3, 0, 1))
            bns.append((blk.bn, p["bn"], st))
        for bn, p, st in bns:
            bn.scale.copy_(_t(p["scale"]))
            bn.offset.copy_(_t(p["offset"]))
            bn.mean.copy_(_t(st["mean"]))
            bn.var.copy_(_t(st["var"]))
        model.final.weight.copy_(_t(g_params["final"]["w"]).permute(3, 2, 0, 1))
        model.final.bias.copy_(_t(g_params["final"]["b"]))
        if model.embed is not None:
            model.embed.copy_(_t(g_params["embed"]))
    return model


def to_jax(model: Generator) -> Tuple[Dict, Dict]:
    """A port ``Generator`` -> (g_params, g_bn) in JAX layouts (numpy)."""
    np_ = lambda t: t.detach().float().cpu().numpy().copy()  # noqa: E731

    def bn_pair(bn):
        return ({"scale": np_(bn.scale), "offset": np_(bn.offset)},
                {"mean": np_(bn.mean), "var": np_(bn.var)})

    fc_bn_p, fc_bn_s = bn_pair(model.fc_bn)
    params = {"fc": {"w": np_(model.fc.weight.t()), "b": np_(model.fc.bias)},
              "fc_bn": fc_bn_p, "blocks": [],
              "final": {"w": np_(model.final.weight.permute(2, 3, 1, 0)),
                        "b": np_(model.final.bias)}}
    state = {"fc_bn": fc_bn_s, "blocks": []}
    for blk in model.blocks:
        p, s = bn_pair(blk.bn)
        params["blocks"].append({"w": np_(blk.weight.permute(2, 3, 0, 1)), "bn": p})
        state["blocks"].append(s)
    if model.embed is not None:
        params["embed"] = np_(model.embed)
    return params, state


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}/", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}/", out)
    else:
        out[prefix[:-1]] = np.asarray(tree, dtype=np.float32)


def flatten(g_params: Dict, g_bn: Dict) -> Dict[str, np.ndarray]:
    """Trees -> {path: array}; BN running state goes under ``bn/``."""
    out: Dict[str, np.ndarray] = {}
    _flatten(g_params, "", out)
    _flatten(g_bn, "bn/", out)
    return out


def _unflatten(items: Dict[str, np.ndarray]):
    root: Dict = {}
    for path, arr in items.items():
        node = root
        *parents, leaf = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = arr

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


def unflatten(flat: Dict[str, np.ndarray]) -> Tuple[Dict, Dict]:
    """{path: array} -> (g_params, g_bn), the inverse of ``flatten``."""
    params = {k: v for k, v in flat.items() if not k.startswith("bn/")}
    state = {k[3:]: v for k, v in flat.items() if k.startswith("bn/")}
    return _unflatten(params), _unflatten(state)
