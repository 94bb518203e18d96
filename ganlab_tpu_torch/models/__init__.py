"""Model zoo of the PyTorch port: ResNet-GAN, ProGAN, StyleGAN and StyleGAN2
pairs."""

from ganlab_tpu_torch.models import stylegan, stylegan2
from ganlab_tpu_torch.models.layers import (
    ConstInput,
    EqualConv,
    EqualDense,
    NoiseInjection,
    StyleAffine,
)
from ganlab_tpu_torch.models.progan import ProDiscriminator, ProGenerator
from ganlab_tpu_torch.models.resnetgan import (
    ResNetDiscriminator,
    ResNetGenerator,
)
from ganlab_tpu_torch.models.stylegan import (
    MappingNetwork,
    StyleGenerator,
    SynthesisNetwork,
)
from ganlab_tpu_torch.models.stylegan2 import StyleGAN2Generator

_GENERATORS = {"resnetgan": ResNetGenerator, "progan": ProGenerator,
               "stylegan": StyleGenerator, "stylegan2": StyleGAN2Generator}


def _family(model_cfg) -> str:
    name = model_cfg.model
    if name not in _GENERATORS:
        raise ValueError(f"unknown model {name!r}")
    return name


def is_style(model_cfg) -> bool:
    """Whether the family's generator maps z to w (mapping + synthesis):
    its callers mix styles, draw noise, truncate and keep a w-average."""
    return model_cfg.model in ("stylegan", "stylegan2")


def noise_shapes(model_cfg, res_log2: int) -> list:
    """(H, W) of each explicit noise map of a style family's synthesis at
    2^res_log2, in the order its ``noises=`` takes them: StyleGAN has two
    4x4 maps, StyleGAN2 one."""
    family = stylegan2 if model_cfg.model == "stylegan2" else stylegan
    return family.noise_shapes(res_log2)


def build_generator(model_cfg):
    """The generator of a ModelConfig."""
    return _GENERATORS[_family(model_cfg)](model_cfg)


def build_models(model_cfg):
    """The (generator, discriminator) pair of a ModelConfig, as
    ``ganlab_tpu.models.build_models`` pairs them: the ResNet D with the
    ResNet G, the ProGAN D (average-pool blocks) with the ProGAN G, and the
    ProGAN D with blur + downsample blocks (residual ones where
    ``model.d_resnet``) with the StyleGAN and StyleGAN2 Gs."""
    name = _family(model_cfg)
    g = _GENERATORS[name](model_cfg)
    if name == "resnetgan":
        return g, ResNetDiscriminator(model_cfg)
    return g, ProDiscriminator(model_cfg, blur_resample=is_style(model_cfg))
