"""The port's `Unet3D` with self-conditioning and cond images against the
JAX package, fp32.

Two cases of `test_torch_self_cond.py`'s forward check: `self_cond=True`
with `cond_images_channels=3` and low-res conditioning, and cond images
with two preceding prompt frames, which the (b, h, w, c) cond images
cover too; each plain and as the guided doubled batch.
"""
import pytest

from test_torch_self_cond import check_forward


@pytest.mark.parametrize('case', ['3d', '3d_prompt_frames'])
def test_unet3d_forward_with_self_cond_and_cond_images_matches_jax(case):
    check_forward(case)
