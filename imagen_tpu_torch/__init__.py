"""PyTorch + CUDA port of imagen_tpu: the 64->256 text-to-image cascade, its
serving path and its training (DDPM and EDM, Adam or Adafactor, dataloaders,
validation and checkpoint folders), text-to-video serving and training with
`Unet3D` (DDPM and EDM), configs, self-describing checkpoints (the port's and
the JAX package's), T5 text encoding, training on several GPUs (data
parallelism, ZeRO-1, FSDP and a 'model' axis over torch.distributed, with
sharded checkpoints) and the command line."""
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

from imagen_tpu_torch.configs import (
    UnetConfig,
    Unet3DConfig,
    NullUnetConfig,
    ImagenConfig,
    ElucidatedImagenConfig,
    ImagenTrainerConfig,
    ParallelConfig,
)

from imagen_tpu_torch.utils.load import load_imagen_from_checkpoint
