"""Configuration tree: the same dataclasses and JSON sidecar schema as the
JAX package's ``core/config.py``, kept as the port's own copy.

A checkpoint's ``config.json`` written by either package loads in the other:
field names, defaults and the unknown-key-tolerant ``from_dict`` are the
same. Knobs that only steer the JAX training graph (``g_final_cvjp``,
``packed_io``, ``rng_impl``, ...) are carried for schema compatibility; the
port reads ``use_pallas`` as "run the hand-written generator kernel".
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


def _asdict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj):
        return {f.name: _asdict(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    return obj


@dataclass(frozen=True)
class ModelConfig:
    """Generator/discriminator architecture knobs."""

    latent_dim: int = 100
    image_size: int = 64           # 64 or 128
    image_channels: int = 1
    base_features: int = 256       # generator stem width at 4x4
    num_classes: int = 0           # 0 = unconditional
    # How G consumes the class label (num_classes > 0): "full" (conditional
    # BN affine + embedding added to z), "bn_only", "embed_only", "concat"
    # (one-hot appended to z) or "none" (G ignores y).
    g_conditioning: str = "full"
    d_projection: bool = True
    aux_classifier: bool = False
    use_spectral_norm: bool = False
    d_dgrad_phases: bool = False
    d_conv1_matmul: bool = False
    g_final_cvjp: bool = True
    g_pack_pallas: bool = True
    g_convt_cvjp: bool = True
    dropout: float = 0.25
    leaky_slope: float = 0.2
    g_activation: str = "relu"     # "relu" | "leaky_relu"

    def __post_init__(self):
        valid = ("full", "bn_only", "embed_only", "concat", "none")
        if self.g_conditioning not in valid:
            raise ValueError(f"g_conditioning must be one of {valid}, "
                             f"got {self.g_conditioning!r}")
        if self.g_activation not in ("relu", "leaky_relu"):
            raise ValueError("g_activation must be 'relu' or 'leaky_relu', "
                             f"got {self.g_activation!r}")
        if self.aux_classifier and self.num_classes == 0:
            raise ValueError("aux_classifier requires num_classes > 0 "
                             "(set num_classes / pass --num_classes)")


@dataclass(frozen=True)
class OptimConfig:
    g_lr: float = 2e-4
    d_lr: float = 2e-4
    beta1: float = 0.5
    beta2: float = 0.999
    gradient_clip_value: Optional[float] = None
    lr_schedule: str = "constant"
    lr_decay_start_frac: float = 0.5
    lr_end_frac: float = 0.0
    lr_total_steps: int = 0
    moment_dtype: str = "bfloat16"


@dataclass(frozen=True)
class MeshConfig:
    data_axis: str = "data"
    model_axis: str = "model"
    num_data: int = -1
    num_model: int = 1


@dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    batch_size: int = 64
    epochs: int = 200
    label_smoothing: float = 0.9
    n_critic: int = 1
    share_fakes: bool = False
    fuse_g_forwards: bool = False
    diffaugment: str = ""
    seed: int = 42
    rng_impl: str = "rbg"
    # Generation: the non-kernel path runs its convolutions in this dtype.
    compute_dtype: str = "bfloat16"
    log_grad_norms: bool = False
    packed_io: bool = True
    # Port meaning: serve the 64 px unconditional generator through the
    # hand-written CUDA kernel (ops/kernels/generator_fwd.py).
    use_pallas: bool = False
    sample_interval: int = 5
    checkpoint_interval: int = 10
    fixed_noise_samples: int = 64
    fid_interval: int = 0
    fid_samples: int = 512
    ema_decay: float = 0.0
    aux_weight: float = 0.0
    aux_d_on_fakes: bool = False
    class_balanced_fakes: bool = True
    mode_collapse_threshold: float = 0.1
    mode_collapse_window: int = 50
    data_dir: str = ""
    checkpoint_dir: str = "./checkpoints"
    sample_dir: str = "./samples"
    log_dir: str = "./logs"
    augment: bool = True
    augment_bulk: bool = True
    hflip: bool = False
    prefetch: int = 2
    resident_data: bool = True
    resident_max_mb: int = 4096
    scan_steps: int = 0
    profile_dir: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return _asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TrainConfig":
        # Unknown keys are dropped at every level, so a sidecar written by a
        # build with extra or renamed fields still loads.
        def known_only(dc_cls, sub: Dict[str, Any]) -> Dict[str, Any]:
            names = {f.name for f in dataclasses.fields(dc_cls)}
            return {k: v for k, v in sub.items() if k in names}

        d = dict(d)
        model = ModelConfig(**known_only(ModelConfig, d.pop("model", {})))
        optim = OptimConfig(**known_only(OptimConfig, d.pop("optim", {})))
        mesh = MeshConfig(**known_only(MeshConfig, d.pop("mesh", {})))
        d = known_only(cls, d)
        return cls(model=model, optim=optim, mesh=mesh, **d)

    @classmethod
    def from_json(cls, s: str) -> "TrainConfig":
        return cls.from_dict(json.loads(s))

    def replace(self, **kw: Any) -> "TrainConfig":
        return dataclasses.replace(self, **kw)
