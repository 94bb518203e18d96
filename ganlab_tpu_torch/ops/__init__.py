"""Ops of the PyTorch port (NCHW activations, OIHW conv weights)."""

from ganlab_tpu_torch.ops.equalized import (
    equalized_conv2d,
    equalized_conv2d_folded,
    equalized_conv2d_up2,
    equalized_dense,
    he_constant,
    leaky_relu,
    rounded,
)
from ganlab_tpu_torch.ops.minibatch_stddev import minibatch_stddev
from ganlab_tpu_torch.ops.normalization import adain, instance_norm, pixel_norm
from ganlab_tpu_torch.ops.upfirdn import (
    blur2d,
    blur_downsample_2x,
    downsample_avg_2x,
    compose_up2_kernel,
    fade_in,
    up2_conv2d,
    up2_conv2d_hybrid,
    upsample_blur_2x,
    upsample_nearest_2x,
)
