"""U-Net and its building blocks."""
from imagen_tpu_torch.models.unet2d import (
    Unet,
    NullUnet,
    BaseUnet64,
    SRUnet256,
    SRUnet1024,
)
