"""Cascaded diffusion samplers."""
from imagen_tpu_torch.diffusion.imagen import Imagen, unet_forward_with_cond_scale
