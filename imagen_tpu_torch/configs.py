"""Config classes; counterpart of `imagen_tpu/configs.py`.

The same pydantic v2 models, fields, defaults and JSON shape as the JAX
package's: extra keys pass through (`extra='allow'`) to the constructors,
`model_dump()` gives the dict JAX's gives, and `.create(device=...)` builds
the model on `device` (None: the card), attaching `_config` to an imagen so
its checkpoints describe it. A JAX `imagen_params` dict therefore builds the
port's cascade, and the reverse.

Multi-device layouts (`ParallelConfig`, `apply_parallel`, a trainer
config's `parallel` block) are not ported: they raise NotImplementedError
(ROADMAP.md queue 1, item 7).
"""
from __future__ import annotations

from enum import Enum
from typing import Any, List, Optional, Tuple, Union

from pydantic import BaseModel, ConfigDict, field_validator, model_validator

from imagen_tpu_torch.models.t5 import DEFAULT_T5_NAME, get_encoded_dim

PARALLEL_NOT_PORTED = ('multi-device layouts (meshes, FSDP, sharded optimizer states) are not '
                       'ported yet (ROADMAP.md queue 1, item 7)')


def ListOrTuple(inner_type):
    return Union[List[inner_type], Tuple[inner_type]]


def SingleOrList(inner_type):
    return Union[inner_type, ListOrTuple(inner_type)]


class NoiseSchedule(Enum):
    cosine = 'cosine'
    linear = 'linear'


class AllowExtraBaseModel(BaseModel):
    model_config = ConfigDict(extra='allow', use_enum_values=True)


class NullUnetConfig(BaseModel):
    is_null: bool

    def create(self, device=None):
        from imagen_tpu_torch.models.unet2d import NullUnet
        return NullUnet(device=device)


class UnetConfig(AllowExtraBaseModel):
    dim: int
    dim_mults: ListOrTuple(int)
    text_embed_dim: int = get_encoded_dim(DEFAULT_T5_NAME)
    cond_dim: Optional[int] = None
    channels: int = 3
    attn_dim_head: int = 32
    attn_heads: int = 16

    def create(self, device=None):
        from imagen_tpu_torch.models.unet2d import Unet
        return Unet(**_tuplify(self.model_dump()), device=device)


class Unet3DConfig(AllowExtraBaseModel):
    dim: int
    dim_mults: ListOrTuple(int)
    text_embed_dim: int = get_encoded_dim(DEFAULT_T5_NAME)
    cond_dim: Optional[int] = None
    channels: int = 3
    attn_dim_head: int = 32
    attn_heads: int = 16

    def create(self, device=None):
        from imagen_tpu_torch.models.unet3d import Unet3D
        return Unet3D(**_tuplify(self.model_dump()), device=device)


def _tuplify(d):
    """Lists from JSON -> tuples, as the JAX configs hand them to the modules."""
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def _create_imagen(config, klass, device):
    from imagen_tpu_torch.models.unet2d import NullUnet, Unet
    from imagen_tpu_torch.models.unet3d import Unet3D
    decoder_kwargs = config.model_dump()
    unets_kwargs = decoder_kwargs.pop('unets')
    unet_klass = Unet3D if decoder_kwargs.pop('video', False) else Unet
    unets = [NullUnet(device=device) if isinstance(unet, NullUnetConfig)
             else unet_klass(**_tuplify(kwargs), device=device)
             for unet, kwargs in zip(config.unets, unets_kwargs)]
    imagen = klass(tuple(unets), **_tuplify(decoder_kwargs), device=device)
    imagen._config = config.model_dump().copy()
    return imagen


class _CascadeConfig(AllowExtraBaseModel):
    @model_validator(mode='after')
    def check_image_sizes(self):
        if len(self.image_sizes) != len(self.unets):
            raise ValueError(
                f'image sizes length {len(self.image_sizes)} must match the '
                f'number of unets {len(self.unets)}')
        return self


class ImagenConfig(_CascadeConfig):
    unets: ListOrTuple(Union[UnetConfig, Unet3DConfig, NullUnetConfig])
    image_sizes: ListOrTuple(int)
    video: bool = False
    timesteps: SingleOrList(int) = 1000
    noise_schedules: SingleOrList(NoiseSchedule) = 'cosine'
    text_encoder_name: str = DEFAULT_T5_NAME
    channels: int = 3
    loss_type: str = 'l2'
    cond_drop_prob: float = 0.5

    def create(self, device=None):
        """The `Imagen` on `device` (None: the card), with `_config` attached."""
        from imagen_tpu_torch.diffusion.imagen import Imagen
        return _create_imagen(self, Imagen, device)


class ElucidatedImagenConfig(_CascadeConfig):
    unets: ListOrTuple(Union[UnetConfig, Unet3DConfig, NullUnetConfig])
    image_sizes: ListOrTuple(int)
    video: bool = False
    text_encoder_name: str = DEFAULT_T5_NAME
    channels: int = 3
    cond_drop_prob: float = 0.5
    num_sample_steps: SingleOrList(int) = 32
    sigma_min: SingleOrList(float) = 0.002
    sigma_max: SingleOrList(float) = 80
    sigma_data: SingleOrList(float) = 0.5
    rho: SingleOrList(float) = 7
    P_mean: SingleOrList(float) = -1.2
    P_std: SingleOrList(float) = 1.2
    S_churn: SingleOrList(float) = 80
    S_tmin: SingleOrList(float) = 0.05
    S_tmax: SingleOrList(float) = 50
    S_noise: SingleOrList(float) = 1.003

    def create(self, device=None):
        """The `ElucidatedImagen` on `device` (None: the card), with `_config`."""
        from imagen_tpu_torch.diffusion.elucidated import ElucidatedImagen
        return _create_imagen(self, ElucidatedImagen, device)


# --- multi-device layouts: not ported ---------------------------------------------------------

class ParallelConfig:
    """The JAX package's declarative mesh layout; not ported (item 7)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(PARALLEL_NOT_PORTED)


def apply_parallel(trainer_kwargs: dict) -> dict:
    """Trainer kwargs without a 'parallel' block pass unchanged; a block raises."""
    if trainer_kwargs.get('parallel') is not None:
        raise NotImplementedError(PARALLEL_NOT_PORTED)
    trainer_kwargs.pop('parallel', None)
    return trainer_kwargs


class ImagenTrainerConfig(AllowExtraBaseModel):
    imagen: dict
    elucidated: bool = False
    video: bool = False
    use_ema: bool = True
    lr: SingleOrList(float) = 1e-4
    eps: SingleOrList(float) = 1e-8
    beta1: float = 0.9
    beta2: float = 0.99
    max_grad_norm: Optional[float] = None
    weight_decay: SingleOrList(float) = 0.0
    group_wd_params: bool = True
    warmup_steps: SingleOrList(Optional[int]) = None
    cosine_decay_max_steps: SingleOrList(Optional[int]) = None
    parallel: Optional[Any] = None

    @field_validator('parallel')
    @classmethod
    def no_parallel(cls, v):
        if v is not None:
            raise NotImplementedError(PARALLEL_NOT_PORTED)
        return v

    def create(self, device=None):
        """The `ImagenTrainer` over the cascade of `imagen` (built on `device`,
        None: the card); the extra keys go to the trainer."""
        from imagen_tpu_torch.trainer import ImagenTrainer
        trainer_kwargs = apply_parallel(self.model_dump())
        imagen_config = trainer_kwargs.pop('imagen')
        elucidated = trainer_kwargs.pop('elucidated')
        video = trainer_kwargs.pop('video')
        klass = ElucidatedImagenConfig if elucidated else ImagenConfig
        imagen = klass(**{**imagen_config, 'video': video}).create(device=device)
        return ImagenTrainer(imagen, **trainer_kwargs)
