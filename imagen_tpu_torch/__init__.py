"""PyTorch + CUDA port of imagen_tpu: the 64->256 text-to-image cascade, its
serving path and its training step (DDPM and EDM, Adam or Adafactor), and
text-to-video serving and training with `Unet3D` (DDPM and EDM)."""
from imagen_tpu_torch.version import __version__

from imagen_tpu_torch.models.unet2d import (
    Unet,
    NullUnet,
    BaseUnet64,
    SRUnet256,
    SRUnet1024,
)
from imagen_tpu_torch.models.unet3d import Unet3D

from imagen_tpu_torch.diffusion.imagen import Imagen
from imagen_tpu_torch.diffusion.elucidated import ElucidatedImagen
from imagen_tpu_torch.ops.edm_math import Hparams
from imagen_tpu_torch.serving import ImagenServer
from imagen_tpu_torch.trainer import ImagenTrainer
from imagen_tpu_torch.ema import EMAConfig
