"""Weight bridge between the JAX package's trees and the port's modules.

The JAX package keeps the generator as two trees of arrays:
``g_params`` = {fc: {w (in, out), b}, fc_bn: {scale, offset},
blocks: [{w (4, 4, Cin, Cout) HWIO, bn: {scale, offset}}],
final: {w (3, 3, C, img_c) HWIO, b}, embed (classes, latent) if any} and
``g_bn`` = {fc_bn: {mean, var}, blocks: [{mean, var}]}; the discriminator
as ``d_params`` = {blocks: [{w (4, 4, Cin, Cout) HWIO, b}], fc: {w (8192,
1), b}, class_embed (classes, 8192) and aux: {w (8192, classes), b} where
the heads are} and ``d_state`` = {blocks: [{u (Cout,)}], fc: {u (1,)},
class_embed: {u (8192,)}, aux: {u (classes,)}} with spectral norm (empty
dicts without), kept in the port as each site's ``u`` buffer; an EMA
shadow ``g_ema`` = {params, bn} as the generator's two trees
(``ema_to_jax``/``ema_from_jax``); an Adam state as
{count, m, v} with m and v shaped like the parameter tree. Here they are
plain numpy arrays in those layouts; the port's modules store PyTorch
layouts: Linear (out, in), ConvT (Cin, Cout, kh, kw), conv OIHW.

The G fc output and D's head input are NHWC maps flattened in HWC order on
both sides, so their columns need no permutation: only (in, out) -> (out,
in) transposes. Moments follow their parameters' layouts.

The eval networks' JAX trees map to the port modules' state dicts:
``inception_from_jax`` (conv ``w`` HWIO -> OIHW, BN ``scale``/``offset``/
``mean``/``var`` -> ``weight``/``bias``/``running_mean``/``running_var``,
branch ``bNAME`` -> torchvision's ``branchNAME``, ``bpool`` ->
``branch_pool``) and ``lpips_from_jax`` (the AlexNet convs and the (C,)
linear weights).

The verifier's trees (``verify/models.py``): ``params`` = {conv: [{w
(k, k, Cin, Cout) HWIO, b}] x 3, bn: [{scale, offset}] x 3, fc1, fc2, cls1,
cls2: {w (in, out), b}} and ``state`` = {bn: [{mean, var}] x 3}, the layout
of a verifier pickle (``verify/train.py::save_verifier``), map to the port's
``Verifier`` (``verifier_from_jax``/``verifier_to_jax``); fc1's rows are the
NHWC map's (h, w, c) order on both sides.

``flatten``/``unflatten`` give the trees as one flat mapping keyed by tree
path (``fc/w``, ``blocks/0/w``, ``bn/blocks/0/mean``, ...), the layout of the
port's ``generator.npz``; ``discriminator.npz`` keeps D's state under
``state/`` (``state/blocks/0/u``, ...).
"""

from __future__ import annotations

from typing import Dict, Iterator, Sequence, Tuple

import numpy as np
import torch

from siggan_tpu_torch.core.config import ModelConfig
from siggan_tpu_torch.core.state import new_count, new_lr
from siggan_tpu_torch.models.discriminator import Discriminator
from siggan_tpu_torch.models.generator import Generator
from siggan_tpu_torch.verify.models import Verifier


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


# Layout of each port parameter as a permutation of its JAX array's axes
# (port = jax.permute(*perm)); parameters not listed keep the JAX layout.
_G_PERMS = {"fc.weight": (1, 0), "blocks.*.weight": (2, 3, 0, 1),
            "final.weight": (3, 2, 0, 1)}
_D_PERMS = {"fc.weight": (1, 0), "blocks.*.weight": (3, 2, 0, 1), "aux.weight": (1, 0)}


def _verifier_path(name: str) -> Tuple[str, Tuple[int, ...] | None]:
    """A ``Verifier`` parameter name -> (JAX tree path, perm)."""
    parts = name.split(".")
    if parts[0] == "blocks":
        i, leaf = parts[1], parts[2]
        if leaf in ("scale", "offset"):
            return f"bn/{i}/{leaf}", None
        return f"conv/{i}/{leaf[0]}", ((3, 2, 0, 1) if leaf == "weight" else None)
    return f"{parts[0]}/{parts[1][0]}", ((1, 0) if parts[1] == "weight" else None)


def _entries(model) -> Iterator[Tuple[str, torch.nn.Parameter, Tuple[int, ...]]]:
    """(JAX tree path, parameter, perm) in ``model.parameters()`` order."""
    if isinstance(model, Verifier):
        for name, p in model.named_parameters():
            path, perm = _verifier_path(name)
            yield path, p, perm
        return
    perms = _D_PERMS if isinstance(model, Discriminator) else _G_PERMS
    for name, p in model.named_parameters():
        parts = name.split(".")
        key = ".".join("*" if q.isdigit() else q for q in parts)
        path = "/".join({"weight": "w", "bias": "b"}.get(q, q) for q in parts)
        yield path, p, perms.get(key)


def _to_port(a, perm) -> torch.Tensor:
    t = _t(a)
    return t if perm is None else t.permute(*perm)


def _to_jax(t: torch.Tensor, perm) -> np.ndarray:
    t = t.detach().float().cpu()
    if perm is not None:
        t = t.permute(*np.argsort(perm))
    return t.numpy().copy()


def params_to_jax(model) -> Dict:
    """Parameter tree of a port ``Generator`` or ``Discriminator``."""
    return _unflatten({path: _to_jax(p, perm) for path, p, perm in _entries(model)})


def load_params(model, params: Dict) -> None:
    """Copy a JAX-layout parameter tree into ``model``'s parameters."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(params, "", flat)
    with torch.no_grad():
        for path, p, perm in _entries(model):
            p.copy_(_to_port(flat[path], perm))


def from_jax(g_params: Dict, g_bn: Dict, cfg: ModelConfig, device=None) -> Generator:
    """JAX-layout trees (numpy arrays) -> a port ``Generator`` on ``device``."""
    model = Generator(cfg, device)
    load_params(model, g_params)
    with torch.no_grad():
        for bn, st in zip([model.fc_bn] + [b.bn for b in model.blocks],
                          [g_bn["fc_bn"]] + list(g_bn["blocks"])):
            bn.mean.copy_(_t(st["mean"]))
            bn.var.copy_(_t(st["var"]))
    return model


def to_jax(model: Generator) -> Tuple[Dict, Dict]:
    """A port ``Generator`` -> (g_params, g_bn) in JAX layouts (numpy)."""
    np_ = lambda t: t.detach().float().cpu().numpy().copy()  # noqa: E731
    state = {"fc_bn": {"mean": np_(model.fc_bn.mean), "var": np_(model.fc_bn.var)},
             "blocks": [{"mean": np_(b.bn.mean), "var": np_(b.bn.var)}
                        for b in model.blocks]}
    return params_to_jax(model), state


def ema_to_jax(g_ema: Generator) -> Dict:
    """A port EMA shadow -> the JAX ``g_ema`` tree {params, bn}."""
    params, bn = to_jax(g_ema)
    return {"params": params, "bn": bn}


def ema_from_jax(g_ema: Dict, cfg: ModelConfig, device=None) -> Generator:
    """A JAX ``g_ema`` tree {params, bn} -> a port shadow ``Generator``
    (no gradients)."""
    model = from_jax(g_ema["params"], g_ema["bn"], cfg, device)
    for p in model.parameters():
        p.requires_grad_(False)
    return model


def _d_vectors(model: Discriminator):
    """(``d_state`` key, block index or None, u or None) per spectral-norm
    site: each block, the head, then the class embedding and the aux head
    where the model has them with spectral norm."""
    out = [("blocks", i, b.u) for i, b in enumerate(model.blocks)] + [("fc", None, model.fc.u)]
    if model.class_embed_u is not None:
        out.append(("class_embed", None, model.class_embed_u))
    if model.aux is not None and model.aux.u is not None:
        out.append(("aux", None, model.aux.u))
    return out


def load_d_state(model: Discriminator, d_state: Dict) -> None:
    """Copy a JAX ``d_state`` (spectral-norm ``u`` per site) into the
    model's ``u`` buffers; a model without spectral norm takes none."""
    with torch.no_grad():
        for key, i, u in _d_vectors(model):
            if u is not None:
                st = d_state[key] if i is None else d_state[key][i]
                u.copy_(_t(st["u"]))


def d_from_jax(d_params: Dict, cfg: ModelConfig, device=None,
               d_state: Dict | None = None) -> Discriminator:
    """JAX-layout ``d_params`` (and ``d_state`` for a spectral-norm model)
    -> a port ``Discriminator`` on ``device``."""
    model = Discriminator(cfg, device)
    load_params(model, d_params)
    if cfg.use_spectral_norm:
        if d_state is None:
            raise ValueError("a spectral-norm discriminator needs its d_state")
        load_d_state(model, d_state)
    return model


def d_to_jax(model: Discriminator) -> Tuple[Dict, Dict]:
    """A port ``Discriminator`` -> (d_params, d_state) in JAX layouts:
    d_state = {blocks: [{u (Co,)}], fc: {u (1,)}} with spectral norm, plus
    class_embed: {u (8192,)} and aux: {u (num_classes,)} where the heads
    are; else empty dicts."""
    np_ = lambda t: t.detach().float().cpu().numpy().copy()  # noqa: E731
    state: Dict = {"blocks": [], "fc": {}}
    for key, i, u in _d_vectors(model):
        st = {} if u is None else {"u": np_(u)}
        if i is None:
            state[key] = st
        else:
            state[key].append(st)
    return params_to_jax(model), state


def tensors_to_jax(model, ts: Sequence[torch.Tensor]) -> Dict:
    """Tensors shaped like ``model.parameters()`` (gradients, moments) ->
    the JAX-layout tree of the model's parameters (f32 numpy)."""
    return _unflatten({path: _to_jax(t, perm)
                       for (path, _, perm), t in zip(_entries(model), ts)})


def opt_to_jax(opt_state: Dict, model) -> Dict:
    """A port Adam state -> {count, m, v} with the count an int32 (read
    from its device tensor) and m, v as JAX-layout trees (f32 numpy; cast
    to the moment dtype on the JAX side)."""
    return {"count": np.int32(int(opt_state["count"])),
            "m": tensors_to_jax(model, opt_state["m"]),
            "v": tensors_to_jax(model, opt_state["v"])}


def opt_from_jax(state: Dict, model, moment_dtype: torch.dtype) -> Dict:
    """{count, m, v} (JAX layouts) -> a port Adam state for ``model``'s
    parameters, moments in ``moment_dtype``, the count an int32 tensor on
    the parameters' device and the applied-LR record 0 (the JAX state
    keeps none)."""
    dev = next(model.parameters()).device
    out: Dict = {"count": new_count(int(np.asarray(state["count"])), dev), "m": [], "v": [],
                 "lr": new_lr(dev)}
    for k in ("m", "v"):
        flat: Dict[str, np.ndarray] = {}
        _flatten(state[k], "", flat)
        out[k] = [_to_port(flat[path], perm).to(p.device, moment_dtype).contiguous()
                  for path, p, perm in _entries(model)]
    return out


def verifier_from_jax(params: Dict, state: Dict, device=None) -> Verifier:
    """JAX-layout verifier trees (numpy arrays; a pickle's ``params`` and
    ``bn``) -> a port ``Verifier`` on ``device`` (eval mode)."""
    model = Verifier(int(np.asarray(params["fc2"]["b"]).shape[0]))
    load_params(model, params)
    with torch.no_grad():
        for blk, st in zip(model.blocks, state["bn"]):
            blk.mean.copy_(_t(st["mean"]))
            blk.var.copy_(_t(st["var"]))
    return model.to(device).eval()


def verifier_to_jax(model: Verifier) -> Tuple[Dict, Dict]:
    """A port ``Verifier`` -> (params, state) in JAX layouts (numpy)."""
    np_ = lambda t: t.detach().float().cpu().numpy().copy()  # noqa: E731
    return params_to_jax(model), {"bn": [{"mean": np_(b.mean), "var": np_(b.var)}
                                         for b in model.blocks]}


def _bconv_sd(prefix: str, p: Dict) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.conv.weight": _t(p["w"]).permute(3, 2, 0, 1).contiguous(),
            f"{prefix}.bn.weight": _t(p["scale"]), f"{prefix}.bn.bias": _t(p["offset"]),
            f"{prefix}.bn.running_mean": _t(p["mean"]),
            f"{prefix}.bn.running_var": _t(p["var"])}


def inception_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """The JAX package's InceptionV3 tree (``eval/inception.py::
    init_params``, numpy arrays) -> a state dict of the port's
    ``eval/inception.py::InceptionV3`` (torchvision's key names)."""
    sd: Dict[str, torch.Tensor] = {}
    for name, node in params.items():
        if "w" in node:   # a stem conv
            sd.update(_bconv_sd(name, node))
            continue
        for branch, p in node.items():
            tv = "branch_pool" if branch == "bpool" else "branch" + branch[1:]
            sd.update(_bconv_sd(f"{name}.{tv}", p))
    return sd


def lpips_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """The JAX package's LPIPS tree ({convs: [{w HWIO, b}], lins: [(C,)]})
    -> a state dict of the port's ``eval/lpips.py::LPIPS``."""
    sd: Dict[str, torch.Tensor] = {}
    for i, (conv, lin) in enumerate(zip(params["convs"], params["lins"])):
        sd[f"convs.{i}.weight"] = _t(conv["w"]).permute(3, 2, 0, 1).contiguous()
        sd[f"convs.{i}.bias"] = _t(conv["b"])
        sd[f"lins.{i}"] = _t(lin).reshape(-1)
    return sd


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}/", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}/", out)
    else:
        out[prefix[:-1]] = np.asarray(tree, dtype=np.float32)


def flatten(params: Dict, state: Dict, state_prefix: str = "bn/") -> Dict[str, np.ndarray]:
    """Trees -> {path: array}; the state (G's BN running statistics by
    default) goes under ``state_prefix``."""
    out: Dict[str, np.ndarray] = {}
    _flatten(params, "", out)
    _flatten(state, state_prefix, out)
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


def unflatten(flat: Dict[str, np.ndarray], state_prefix: str = "bn/") -> Tuple[Dict, Dict]:
    """{path: array} -> (params, state), the inverse of ``flatten``."""
    n = len(state_prefix)
    params = {k: v for k, v in flat.items() if not k.startswith(state_prefix)}
    state = {k[n:]: v for k, v in flat.items() if k.startswith(state_prefix)}
    return _unflatten(params), _unflatten(state)
