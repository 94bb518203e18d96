"""Model zoo of the PyTorch port (the StyleGAN family's G and D so far)."""

from ganlab_tpu_torch.models.layers import (
    ConstInput,
    EqualConv,
    EqualDense,
    NoiseInjection,
    StyleAffine,
)
from ganlab_tpu_torch.models.progan import ProDiscriminator
from ganlab_tpu_torch.models.stylegan import (
    MappingNetwork,
    StyleGenerator,
    SynthesisNetwork,
)


def _require_stylegan(model_cfg) -> None:
    if model_cfg.model != "stylegan":
        raise NotImplementedError(
            f"model {model_cfg.model!r} is not ported to PyTorch yet "
            "(only 'stylegan'; ROADMAP.md A.9)")


def build_generator(model_cfg) -> StyleGenerator:
    """The generator of a ModelConfig (the StyleGAN family only, so far)."""
    _require_stylegan(model_cfg)
    return StyleGenerator(model_cfg)


def build_models(model_cfg) -> tuple[StyleGenerator, ProDiscriminator]:
    """The (generator, discriminator) pair of a ModelConfig, as
    ``ganlab_tpu.models.build_models`` builds it for 'stylegan'."""
    _require_stylegan(model_cfg)
    return (StyleGenerator(model_cfg),
            ProDiscriminator(model_cfg, blur_resample=True))
