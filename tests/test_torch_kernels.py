"""The hand-written kernels' wrappers (ganlab_tpu_torch/ops/kernels).

Here on the CPU: a launching wrapper refuses a CPU tensor (it never falls
back to the plain version). On a CUDA card (``-m gpu``): each kernel
against its plain version, float32 within 1e-5 and bfloat16 within
2**-6 relative (about 2 bf16 ulps). This file imports no JAX, so it runs
on a GPU host that has only PyTorch:

    python -m pytest tests/test_torch_kernels.py -m gpu
"""

import pytest
import torch

from ganlab_tpu_torch.ops.kernels.adain import adain_ref, adain_triton
from ganlab_tpu_torch.ops.kernels.pixelnorm import (
    pixel_norm_ref,
    pixel_norm_triton,
)
from ganlab_tpu_torch.ops.kernels.resample import (
    upsample_blur_2x_cuda,
    upsample_blur_2x_ref,
)


@pytest.mark.parametrize("launch,args", [
    (pixel_norm_triton, lambda: (torch.ones(2, 8),)),
    (adain_triton, lambda: (torch.ones(2, 3, 4, 4), torch.ones(2, 3),
                            torch.ones(2, 3))),
    (upsample_blur_2x_cuda, lambda: (torch.ones(1, 2, 4, 4),)),
], ids=["pixelnorm", "adain", "upsample_blur_2x"])
def test_kernel_wrappers_refuse_cpu_tensors(launch, args):
    """A launching wrapper never computes a plain version itself."""
    before = launch.launches
    with pytest.raises(ValueError, match="CUDA"):
        launch(*args())
    assert launch.launches == before


# -- on the card: each kernel against its plain version ----------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_on_card(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)

    def r(*s):
        return torch.randn(s, generator=g, device=cuda).to(dtype)

    tol = 1e-5 if dtype == torch.float32 else 2 ** -6
    with torch.inference_mode():
        for x in (r(32, 512), r(3, 100)):
            torch.testing.assert_close(pixel_norm_triton(x),
                                       pixel_norm_ref(x), rtol=tol, atol=tol)
        for shape in ((2, 8, 4, 4), (2, 3, 33, 31), (1, 2, 64, 64)):
            x, s, b = r(*shape), r(*shape[:2]), r(*shape[:2])
            want = adain_ref(x, s, b)
            torch.testing.assert_close(adain_triton(x, s, b), want,
                                       rtol=tol,
                                       atol=tol * want.abs().max().item())
            x = r(*shape)
            torch.testing.assert_close(upsample_blur_2x_cuda(x),
                                       upsample_blur_2x_ref(x),
                                       rtol=tol, atol=tol)
