"""Configuration dataclasses of the port: field for field those of
rnr_tpu/config.py (same names, same defaults), kept here so that the port
imports nothing of `rnr_tpu`.

`from_dict` rebuilds a config from `dataclasses.asdict` of either
package's RNRConfig or DNRConfig, which is how a test carries a JAX
config across.
`to_dict`, `save_config` and `load_config` are rnr_tpu's: the training
driver snapshots its config to `params.json`, and either package reads
the other's (the same JSON; `load_config` keeps the fields of the class
and ignores keys it does not know, as rnr_tpu's does).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any


@dataclasses.dataclass(frozen=True)
class TextureConfig:
    texture_size: int = 512
    texture_num_ch: int = 24
    mipmap_level: int = 4
    init_tex: bool = False
    fix_tex: bool = False
    apply_sh: bool = True


@dataclasses.dataclass(frozen=True)
class LightingConfig:
    sh_lmax: int = 10
    num_sample: int = 4096
    num_lighting: int = 1
    lighting_idx: int | None = None
    lighting_relight_idx: int | None = None
    fix_lighting: bool = False
    init_lighting: bool = True
    lp_recon_h: int = 256
    lp_recon_w: int = 512


@dataclasses.dataclass(frozen=True)
class RaysConfig:
    num_azi: int = 6
    num_polar: int = 2
    interval_polar_specular: float = 5.0
    interval_polar_diffuse: float = 10.0
    lt_max_val: float = 2.0
    direct_sh_shading: bool = True
    rays_dtype: str = "float32"
    sh_kernel: str = "auto"
    sh_fan_fuse: bool = True
    fan_impl: str = "elementwise"


@dataclasses.dataclass(frozen=True)
class GCNTrainConfig:
    in_channels: int = 6
    kernel_size: int = 16
    block_type: str = "res"
    conv_type: str = "edge"
    act_type: str = "relu"
    norm_type: str | None = None
    use_bias: bool = True
    n_filters: int = 64
    n_blocks: int = 20
    epsilon: float = 0.2
    stochastic: bool = True
    out_channels: int = 512
    knn_approx: bool = True
    knn_recall: float = 0.9
    graph_refresh_every: int = 1
    strat_min_dilation: int = 3
    stratum_width: int = 16
    compute_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class RenderNetConfig:
    nf0: int = 64
    num_down_unet: int = 5
    norm: str = "batch"
    compute_dtype: str = "bfloat16"
    remat: bool | str = False
    fuse_mode: str = "dense"
    pad_mode: str = "reflect"
    conv_backend: str = "auto"


@dataclasses.dataclass(frozen=True)
class LossConfig:
    loss_lighting_weight: float = 1.0
    loss_lighting_uncovered_weight: float = 0.1
    loss_rays_lt_chrom_weight: float = 1.0
    loss_alb_weight: float = 1.0
    border_crop: int = 5


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-3
    batch_size: int = 1
    max_epoch: int = 2000
    max_iter: int | None = None
    sampling_pattern: str = "all"
    sampling_pattern_val: str = "all"
    val_freq: int = 1000
    log_freq: int = 100
    ckp_freq: int = 5000
    img_size: int = 512
    img_gamma: float = 1.0


@dataclasses.dataclass(frozen=True)
class RNRConfig:
    texture: TextureConfig = TextureConfig()
    lighting: LightingConfig = LightingConfig()
    rays: RaysConfig = RaysConfig()
    gcn: GCNTrainConfig = GCNTrainConfig()
    render_net: RenderNetConfig = RenderNetConfig()
    loss: LossConfig = LossConfig()
    train: TrainConfig = TrainConfig()
    use_gcn: bool = True

    @property
    def num_ray_specular(self) -> int:
        return self.rays.num_azi * self.rays.num_polar + 1

    @property
    def num_ray_diffuse(self) -> int:
        return self.rays.num_azi * self.rays.num_polar + 1

    @property
    def num_ray_total(self) -> int:
        return self.num_ray_specular + self.num_ray_diffuse

    @property
    def render_net_in_channels(self) -> int:
        # rays_dir (3 per ray) + normal(3) + view_dir(3) + neural texture
        return self.num_ray_total * 3 + 6 + self.texture.texture_num_ch

    @property
    def render_net_out_channels(self) -> int:
        return 3 * self.num_ray_total

    @classmethod
    def from_dict(cls, d: dict) -> "RNRConfig":
        return from_dict(cls, d)


@dataclasses.dataclass(frozen=True)
class DNRConfig:
    texture: TextureConfig = TextureConfig(texture_num_ch=30, apply_sh=True)
    render_net: RenderNetConfig = RenderNetConfig()
    loss: LossConfig = LossConfig()
    train: TrainConfig = TrainConfig()
    sh_start_ch: int = 3


_NESTED = {"texture": TextureConfig, "lighting": LightingConfig,
           "rays": RaysConfig, "gcn": GCNTrainConfig,
           "render_net": RenderNetConfig, "loss": LossConfig,
           "train": TrainConfig}


def from_dict(cls, d: dict, strict: bool = True) -> Any:
    """Build `cls` from a (nested) dict; keys it lacks take the defaults,
    unknown keys raise, or are dropped when not `strict`."""
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown and strict:
        raise ValueError(f"{cls.__name__}: unknown fields {sorted(unknown)}")
    kwargs = {}
    for name in names & set(d):
        v = d[name]
        sub = _NESTED.get(name) if cls in (RNRConfig, DNRConfig) else None
        kwargs[name] = (from_dict(sub, v, strict)
                        if sub and isinstance(v, dict) else v)
    return cls(**kwargs)


def to_dict(cfg: Any) -> dict:
    return dataclasses.asdict(cfg)


def save_config(cfg: Any, path: str) -> None:
    with open(path, "w") as f:
        json.dump(to_dict(cfg), f, indent=2, default=str)


def load_config(cls, path: str) -> Any:
    """A config of class `cls` from a `params.json` written by either
    package's save_config; keys `cls` does not know are dropped."""
    with open(path) as f:
        return from_dict(cls, json.load(f), strict=False)
