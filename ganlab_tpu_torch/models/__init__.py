"""Model zoo of the PyTorch port (StyleGAN generator so far)."""

from ganlab_tpu_torch.models.layers import (
    ConstInput,
    EqualConv,
    EqualDense,
    NoiseInjection,
    StyleAffine,
)
from ganlab_tpu_torch.models.stylegan import (
    MappingNetwork,
    StyleGenerator,
    SynthesisNetwork,
)


def build_generator(model_cfg) -> StyleGenerator:
    """The generator of a ModelConfig (the StyleGAN family only, so far)."""
    if model_cfg.model != "stylegan":
        raise NotImplementedError(
            f"model {model_cfg.model!r} is not ported to PyTorch yet "
            "(only 'stylegan')")
    return StyleGenerator(model_cfg)
