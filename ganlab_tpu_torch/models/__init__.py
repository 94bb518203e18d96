"""Model zoo of the PyTorch port: ResNet-GAN, ProGAN and StyleGAN pairs."""

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

_GENERATORS = {"resnetgan": ResNetGenerator, "progan": ProGenerator,
               "stylegan": StyleGenerator}


def _family(model_cfg) -> str:
    name = model_cfg.model
    if name == "stylegan2":
        raise NotImplementedError(
            "model 'stylegan2' is not ported to PyTorch yet (ROADMAP.md A.5)")
    if name not in _GENERATORS:
        raise ValueError(f"unknown model {name!r}")
    return name


def is_style(model_cfg) -> bool:
    """Whether the family's generator maps z to w (mapping + synthesis):
    its callers mix styles, draw noise, truncate and keep a w-average."""
    return model_cfg.model in ("stylegan", "stylegan2")


def build_generator(model_cfg):
    """The generator of a ModelConfig."""
    return _GENERATORS[_family(model_cfg)](model_cfg)


def build_models(model_cfg):
    """The (generator, discriminator) pair of a ModelConfig, as
    ``ganlab_tpu.models.build_models`` pairs them: the ResNet D with the
    ResNet G, the ProGAN D (average-pool blocks) with the ProGAN G, and the
    ProGAN D with blur + downsample blocks with the StyleGAN G."""
    name = _family(model_cfg)
    g = _GENERATORS[name](model_cfg)
    if name == "resnetgan":
        return g, ResNetDiscriminator(model_cfg)
    return g, ProDiscriminator(model_cfg, blur_resample=name == "stylegan")
