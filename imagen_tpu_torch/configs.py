"""Config classes; counterpart of `imagen_tpu/configs.py`.

The same pydantic v2 models, fields, defaults and JSON shape as the JAX
package's: extra keys pass through (`extra='allow'`) to the constructors,
`model_dump()` gives the dict JAX's gives, and `.create(device=...)` builds
the model on `device` (None: the card), attaching `_config` to an imagen so
its checkpoints describe it. A JAX `imagen_params` dict therefore builds the
port's cascade, and the reverse.

A trainer config's `parallel` block (`ParallelConfig`: `{"data": 8,
"fsdp": true}`) lays the trainer out on a mesh of the process group's ranks
(`parallel/mesh.py`); every rank builds it under `torchrun`.
"""
from __future__ import annotations

from enum import Enum
from typing import List, Optional, Tuple, Union

from pydantic import BaseModel, ConfigDict, model_validator

from imagen_tpu_torch.models.t5 import DEFAULT_T5_NAME, get_encoded_dim

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


# --- multi-device layouts -------------------------------------------------------------------

class ParallelConfig(BaseModel):
    """The declarative mesh layout, the config-file face of `parallel/mesh.py`:
    `{"trainer": {"parallel": {"data": 8, "fsdp": true}}}` gives data
    parallelism and ZeRO-3 without mesh code.

    - data: ranks on the 'data' axis (None: the world size / `model`)
    - model: ranks on the 'model' axis (the large weights' output features
      cut over it, gathered before use)
    - fsdp: ZeRO-3, params, moments and EMA cut 1/data a rank (True, or the
      least leaf size in elements that is cut)
    - shard_optimizer_states: ZeRO-1, only the optimizer moments cut
    """
    data: Optional[int] = None
    model: int = 1
    fsdp: Union[bool, int] = False
    shard_optimizer_states: Union[bool, int] = False

    def create_mesh(self, device=None):
        """The mesh over the process group's ranks, on `device` (None: the card)."""
        from imagen_tpu_torch.parallel.mesh import create_mesh
        return create_mesh(data=self.data, model=self.model, device=device)

    def trainer_kwargs(self, device=None):
        return dict(mesh=self.create_mesh(device), fsdp=self.fsdp,
                    shard_optimizer_states=self.shard_optimizer_states)


def apply_parallel(trainer_kwargs: dict, device=None) -> dict:
    """Pop a 'parallel' block (a dict or a ParallelConfig) out of trainer
    kwargs and expand it into mesh, fsdp and shard_optimizer_states: the one
    place the block maps to ImagenTrainer kwargs (`ImagenTrainerConfig.create`
    and the CLI's train command)."""
    parallel = trainer_kwargs.pop('parallel', None)
    if parallel is None:
        return trainer_kwargs
    if not isinstance(parallel, ParallelConfig):
        parallel = ParallelConfig(**parallel)
    trainer_kwargs.update(parallel.trainer_kwargs(device))
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
    parallel: Optional[ParallelConfig] = None

    def create(self, device=None):
        """The `ImagenTrainer` over the cascade of `imagen` (built on `device`,
        None: the card, where the mesh of a `parallel` block lies too); the
        extra keys go to the trainer."""
        from imagen_tpu_torch.trainer import ImagenTrainer
        trainer_kwargs = self.model_dump()
        trainer_kwargs['parallel'] = self.parallel
        trainer_kwargs = apply_parallel(trainer_kwargs, device)
        imagen_config = trainer_kwargs.pop('imagen')
        elucidated = trainer_kwargs.pop('elucidated')
        video = trainer_kwargs.pop('video')
        klass = ElucidatedImagenConfig if elucidated else ImagenConfig
        imagen = klass(**{**imagen_config, 'video': video}).create(device=device)
        return ImagenTrainer(imagen, **trainer_kwargs)
