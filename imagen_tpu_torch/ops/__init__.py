"""Tensor ops and the hand-written CUDA kernels of the port."""
from imagen_tpu_torch.ops.diffusion_math import (
    GaussianDiffusionContinuousTimes,
    beta_linear_log_snr,
    alpha_cosine_log_snr,
    log_snr_to_alpha_sigma,
)
from imagen_tpu_torch.ops import edm_math
from imagen_tpu_torch.ops.tensor_utils import (
    log,
    l2norm,
    right_pad_dims_to,
    masked_mean,
    resize_image_to,
    cast_uint8_images_to_float,
    normalize_neg_one_to_one,
    unnormalize_zero_to_one,
    prob_mask_like,
)
