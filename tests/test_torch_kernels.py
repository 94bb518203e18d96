"""The hand-written kernels' wrappers (ganlab_tpu_torch/ops/kernels).

Here on the CPU: a launching wrapper refuses a CPU tensor (it never falls
back to the plain version). On a CUDA card (``-m gpu``): each kernel
against its plain version, float32 within 1e-5 and bfloat16 within
2**-6 relative (about 2 bf16 ulps), each resample kernel on its vector and
its element path (bit-identical), AdaIN on each of its paths (they sum in
different orders, so each is held to the plain version, not to another
path's bits), mbstd on its vector and element paths with the batch held
in registers and read twice, pixelnorm at widths that do and do not fill 16-byte vectors; each
autograd Function's gradient, and the second derivative through the
resample and mbstd Functions, against autograd through the plain versions
on the card, in float32 within 1e-5 of the scale; the resample kernels at
every StyleGAN2 shape (``chip_smoke.sg2_launch_units``) and a
path-length-shaped second derivative through them. This file imports no
JAX, so it runs on a GPU host that has only PyTorch:

    python -m pytest tests/test_torch_kernels.py -m gpu
"""

import pytest
import torch

from ganlab_tpu_torch.ops.kernels.adain import (
    adain_cuda,
    adain_path,
    adain_ref,
)
from ganlab_tpu_torch.ops.kernels.pixelnorm import (
    pixel_norm_cuda,
    pixel_norm_nchw_cuda,
    pixel_norm_nchw_path,
    pixel_norm_nchw_ref,
    pixel_norm_ref,
)
from ganlab_tpu_torch.ops.kernels.mbstd import (
    minibatch_stddev_cuda,
    minibatch_stddev_path,
    minibatch_stddev_ref,
)
from ganlab_tpu_torch.ops.kernels.resample import (
    blur_downsample_2x_cuda,
    blur_downsample_2x_path,
    blur_downsample_2x_ref,
    upsample_blur_2x_cuda,
    upsample_blur_2x_path,
    upsample_blur_2x_ref,
)


@pytest.mark.parametrize("launch,args", [
    (pixel_norm_cuda, lambda: (torch.ones(2, 8),)),
    (pixel_norm_nchw_cuda, lambda: (torch.ones(2, 8, 4, 4),)),
    (adain_cuda, lambda: (torch.ones(2, 3, 4, 4), torch.ones(2, 3),
                            torch.ones(2, 3))),
    (upsample_blur_2x_cuda, lambda: (torch.ones(1, 2, 4, 4),)),
    (blur_downsample_2x_cuda, lambda: (torch.ones(1, 2, 4, 4),)),
    (minibatch_stddev_cuda, lambda: (torch.ones(4, 2, 4, 4),)),
], ids=["pixelnorm", "pixelnorm_nchw", "adain", "upsample_blur_2x",
        "blur_downsample_2x", "minibatch_stddev"])
def test_kernel_wrappers_refuse_cpu_tensors(launch, args):
    """A launching wrapper never computes a plain version itself."""
    before = launch.launches
    with pytest.raises(ValueError, match="CUDA"):
        launch(*args())
    assert launch.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(2, 5, 3, 4), (3, 16, 4, 4), (2, 1, 2, 2)],
                         ids=lambda v: "x".join(map(str, v)))
def test_nchw_pixelnorm_library_call_is_the_same_function(shape, dtype):
    """The one PyTorch call ``chip_smoke.py`` times beside the NCHW
    pixelnorm (a local response norm over a window of 2C - 1 channels)
    computes the plain version: 1e-5 relative in float32, 1e-12 in
    float64."""
    import chip_smoke

    x = _randn(shape, dtype, 4, "cpu") * 2.5
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(chip_smoke._pixelnorm_nchw_library(x),
                               pixel_norm_nchw_ref(x), rtol=tol, atol=tol)


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
            torch.testing.assert_close(pixel_norm_cuda(x),
                                       pixel_norm_ref(x), rtol=tol, atol=tol)
        for shape in ((2, 8, 4, 4), (2, 3, 33, 31), (1, 2, 64, 64)):
            x, s, b = r(*shape), r(*shape[:2]), r(*shape[:2])
            want = adain_ref(x, s, b)
            torch.testing.assert_close(adain_cuda(x, s, b), want,
                                       rtol=tol,
                                       atol=tol * want.abs().max().item())
            x = r(*shape)
            torch.testing.assert_close(upsample_blur_2x_cuda(x),
                                       upsample_blur_2x_ref(x),
                                       rtol=tol, atol=tol)
            x = r(*shape[:2], 2 * shape[2], 2 * shape[3])
            torch.testing.assert_close(blur_downsample_2x_cuda(x),
                                       blur_downsample_2x_ref(x),
                                       rtol=tol, atol=tol)
        for shape in ((32, 512, 4, 4), (4, 3, 5, 7), (3, 1, 1, 1)):
            x = r(*shape)
            torch.testing.assert_close(minibatch_stddev_cuda(x),
                                       minibatch_stddev_ref(x),
                                       rtol=tol, atol=tol)


def _tol(dtype):
    return 1e-5 if dtype == torch.float32 else 2 ** -6


def _randn(shape, dtype, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device).to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gain", [1.0, 0.25])
@pytest.mark.parametrize("shape,path", [
    ((2, 3, 16, 32), "vector"),      # 4 or 8 lanes a row, rows share a warp
    ((3, 5, 7, 24), "vector"),       # a lane count that does not divide 32
    ((1, 2, 5, 264), "vector"),      # more than a warp of vectors in a row
    ((2, 2, 9, 8), "vector"),        # one bf16 vector a row, odd height
    ((2, 3, 33, 31), "element"),     # width no multiple of a vector
    ((2, 8, 4, 2), "element"),       # width below a vector
], ids=lambda v: v if isinstance(v, str) else "x".join(map(str, v)))
def test_upsample_blur_paths_on_card(cuda, shape, path, gain, dtype):
    """Both paths of the up+blur kernel against the plain version, and
    against each other on the same values at an unaligned pointer."""
    tol = _tol(dtype)
    with torch.inference_mode():
        x = _randn(shape, dtype, 3, cuda)
        out = upsample_blur_2x_cuda(x, gain)
        assert upsample_blur_2x_path(x, out) == path
        torch.testing.assert_close(out, upsample_blur_2x_ref(x, gain),
                                   rtol=tol, atol=tol)
        xu = _unaligned_copy(x)
        out_u = upsample_blur_2x_cuda(xu, gain)
        assert upsample_blur_2x_path(xu, out_u) == "element"
        assert torch.equal(out, out_u)
        y = _randn((*shape[:2], 2 * shape[2], 2 * shape[3]), dtype, 4, cuda)
        torch.testing.assert_close(blur_downsample_2x_cuda(y, gain),
                                   blur_downsample_2x_ref(y, gain),
                                   rtol=tol, atol=tol)


def _unaligned_copy(x):
    return torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:] \
        .view(x.shape).copy_(x)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gain", [1.0, 4.0])
@pytest.mark.parametrize("shape,path", [
    ((2, 3, 32, 64), "vector"),      # 4 or 8 lanes a row, rows share a warp
    ((3, 5, 14, 48), "vector"),      # a lane count that does not divide 32
    ((1, 2, 10, 528), "vector"),     # more than a warp of vectors in a row
    ((2, 2, 18, 16), "vector"),      # one bf16 vector a row, odd height
    ((2, 3, 66, 62), "element"),     # output width no multiple of a vector
    ((2, 8, 8, 4), "element"),       # output width below a vector
], ids=lambda v: v if isinstance(v, str) else "x".join(map(str, v)))
def test_blur_downsample_paths_on_card(cuda, shape, path, gain, dtype):
    """Both paths of the blur+down kernel against the plain version, and
    against each other on the same values at an unaligned pointer."""
    tol = _tol(dtype)
    with torch.inference_mode():
        x = _randn(shape, dtype, 6, cuda)
        out = blur_downsample_2x_cuda(x, gain)
        assert blur_downsample_2x_path(x, out) == path
        torch.testing.assert_close(out, blur_downsample_2x_ref(x, gain),
                                   rtol=tol, atol=tol * gain)
        xu = _unaligned_copy(x)
        out_u = blur_downsample_2x_cuda(xu, gain)
        assert blur_downsample_2x_path(xu, out_u) == "element"
        assert torch.equal(out, out_u)


def _adain_want(x, s, b, planes):
    """What AdaIN must give: the plain version, or on constant planes the
    bias itself (x - mean is 0). The plain version's mean is the sum times
    1/HW, one ulp off where HW is no power of two (1000x1048), and
    rsqrt(var + eps) = 1e4 makes that ~1e-3 of the output."""
    if planes == "constant":
        return b[:, :, None, None].expand_as(x)
    return adain_ref(x, s, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("planes", ["random", "constant", "large mean"])
@pytest.mark.parametrize("shape,path", [
    ((4, 8, 4, 4), "warp"),          # several planes a warp
    ((2, 3, 32, 32), "warp"),        # the largest plane a warp holds
    ((2, 3, 5, 7), "loop"),          # H*W no multiple of a vector
    ((3, 5, 33, 31), "loop"),
    ((2, 3, 48, 48), "block"),       # a block whose last vectors are ragged
    ((1, 2, 128, 128), "block"),
    ((1, 2, 256, 256), {torch.float32: "cluster"}),  # 16-bit types: a block
    ((1, 2, 512, 512), "cluster"),
    # 16 blocks, part of each slice in shared memory
    ((1, 2, 1024, 1024), "cluster"),
    ((1, 2, 724, 728), "cluster"),   # vectors that 16 blocks split unevenly
    ((1, 2, 1000, 1048), "cluster"),
    ((1, 1, 2048, 2048), "split"),   # too large for a cluster
    # float32: 4096 slices that end ragged; 16-bit types: a cluster
    ((1, 2, 1000, 2100), ({torch.float32: "split"}, "cluster")),
], ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple)
    and isinstance(v[0], int) else None)
def test_adain_paths_on_card(cuda, shape, path, planes, dtype):
    """Each path of the AdaIN kernel against the plain version, also from
    an unaligned pointer (the loop path), on random planes, constant
    planes (the output is the bias, bit for bit) and planes whose mean is
    far above their spread (where a one-pass variance fails)."""
    if isinstance(path, tuple):
        path = path[0].get(dtype, path[1])
    elif isinstance(path, dict):
        path = path.get(dtype, "block")
    tol = {torch.float32: 1e-5, torch.bfloat16: 2 ** -6,
           torch.float16: 2 ** -9}[dtype]
    with torch.inference_mode():
        noise = _randn(shape, torch.float32, 7, cuda)
        x = {"random": 0.5 + 2 * noise, "large mean": 1000 + 16 * noise,
             "constant": torch.full(shape, 1.5, device=cuda)}[planes]
        x = x.to(dtype)
        s = (1 + _randn(shape[:2], torch.float32, 9, cuda)).to(dtype)
        b = _randn(shape[:2], dtype, 10, cuda)
        want = _adain_want(x, s, b, planes)
        atol = tol * want.abs().max().item()
        out = adain_cuda(x, s, b)
        assert adain_path(x, out).split()[0] == path
        torch.testing.assert_close(out, want, rtol=0, atol=atol)
        xu = _unaligned_copy(x)
        out_u = adain_cuda(xu, s, b)
        assert adain_path(xu, out_u) == "loop"
        torch.testing.assert_close(out_u, want, rtol=0, atol=atol)
        if planes == "constant":
            assert torch.equal(out, b[:, :, None, None].expand_as(out))
            assert torch.equal(out_u, out)


@pytest.mark.gpu
@pytest.mark.parametrize("planes", ["random", "constant", "large mean"])
@pytest.mark.parametrize("dtype,shape", [
    (torch.float32, (1, 1, 4608, 4096)),     # 72 MiB: 1152 slices
    (torch.bfloat16, (1, 1, 8192, 4608)),    # 72 MiB: 1152 slices
], ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else None)
def test_adain_split_large_planes_on_card(cuda, dtype, shape, planes):
    """Planes above 64 MiB take the split path with more slices than one
    round of staged partials holds, against the plain version (float32
    1e-5, bf16 2**-6 of the scale); constant planes give the bias bit for
    bit. (No unaligned copy: its loop path gives the plane to one block.)"""
    tol = {torch.float32: 1e-5, torch.bfloat16: 2 ** -6}[dtype]
    with torch.inference_mode():
        noise = _randn(shape, torch.float32, 27, cuda)
        x = {"random": 0.5 + 2 * noise, "large mean": 1000 + 16 * noise,
             "constant": torch.full(shape, 1.5, device=cuda)}[planes]
        x = x.to(dtype)
        s = (1 + _randn(shape[:2], torch.float32, 28, cuda)).to(dtype)
        b = _randn(shape[:2], dtype, 29, cuda)
        want = _adain_want(x, s, b, planes)
        out = adain_cuda(x, s, b)
        assert adain_path(x, out) == "split 1152 x 512 x 8"
        torch.testing.assert_close(out, want, rtol=0,
                                   atol=tol * want.abs().max().item())
        if planes == "constant":
            assert torch.equal(out, b[:, :, None, None].expand_as(out))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("planes", ["random", "constant", "large mean"])
@pytest.mark.parametrize("shape,cuts", [
    ((1, 2, 1024, 1024), [dict(path="split", threads=t) for t in
                          (256, 512, 1024)]
     + [dict(path="cluster", cluster=16, threads=t) for t in
        (256, 512, 1024)]
     + [dict(path="loop")]),
    ((2, 3, 512, 512), [dict(path="cluster", cluster=c) for c in (4, 8, 16)]
     + [dict(path="split", threads=256)]),
    # 65884 vectors (bf16): ragged over 16 blocks and over slices of 2048
    ((1, 2, 724, 728), [dict(path="split", threads=256),
                        dict(path="cluster", cluster=16, threads=256)]),
], ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else None)
def test_adain_forced_paths_on_card(cuda, shape, cuts, planes, dtype):
    """The cluster and split paths forced at other cuts than the plan's,
    beside the loop path, against the plain version (float32 1e-5, bf16
    2**-6, f16 2**-9 of the scale); constant planes give the bias bit for
    bit. A cluster of 4 blocks cannot hold a 1024x1024 plane (its slices
    would need more than 224 KiB of shared memory): asking for it raises."""
    tol = {torch.float32: 1e-5, torch.bfloat16: 2 ** -6,
           torch.float16: 2 ** -9}[dtype]
    with torch.inference_mode():
        noise = _randn(shape, torch.float32, 17, cuda)
        x = {"random": 0.5 + 2 * noise, "large mean": 1000 + 16 * noise,
             "constant": torch.full(shape, 1.5, device=cuda)}[planes]
        x = x.to(dtype)
        s = (1 + _randn(shape[:2], torch.float32, 18, cuda)).to(dtype)
        b = _randn(shape[:2], dtype, 19, cuda)
        want = _adain_want(x, s, b, planes)
        atol = tol * want.abs().max().item()
        if shape[2] == 1024:
            with pytest.raises(ValueError):
                adain_cuda(x, s, b, path="cluster", cluster=4)
        for cut in cuts:
            out = adain_cuda(x, s, b, **cut)
            assert adain_path(x, out, **cut).split()[0] == cut["path"]
            torch.testing.assert_close(out, want, rtol=0, atol=atol)
            if planes == "constant":
                assert torch.equal(out, b[:, :, None, None].expand_as(out))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("c", [96, 500, 512, 4096])
def test_pixel_norm_widths_on_card(cuda, c, dtype):
    """Vector loads (96, 512), one element a load (500), a row too wide to
    stay in registers (4096), and rows at an unaligned pointer."""
    tol = 1e-5 if dtype == torch.float32 else \
        2 ** -6 if dtype == torch.bfloat16 else 2 ** -9
    with torch.inference_mode():
        x = _randn((7, c), dtype, 5, cuda)
        want = pixel_norm_ref(x)
        torch.testing.assert_close(pixel_norm_cuda(x), want,
                                   rtol=tol, atol=tol)
        torch.testing.assert_close(pixel_norm_cuda(_unaligned_copy(x)), want,
                                   rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,path", [
    ((32, 512, 4, 4), "vector held"),    # the training shape
    ((1, 512, 4, 4), "vector held"),     # N = 1: the variance is 0
    ((3, 511, 4, 4), "vector held"),     # an odd C
    ((33, 512, 4, 4), "vector reread"),  # a batch the registers cannot hold
    ((5, 2048, 4, 4), "vector held"),    # more chunks than threads
    ((3, 5, 3, 3), "element held"),      # H*W = 9
    ((33, 7, 3, 3), "element reread"),
    ((4, 3, 5, 7), "element held"),
], ids=lambda v: v.replace(" ", "-") if isinstance(v, str)
    else "x".join(map(str, v)))
def test_minibatch_stddev_paths_on_card(cuda, shape, path, dtype):
    """Both paths of the mbstd kernel, with the batch in registers and
    read twice, against the plain version (float32 1e-5, bfloat16 2**-6 of
    the output scale: the paths sum in other orders), also from an
    unaligned pointer (the element path) and with fewer blocks; a second
    call gives the same bits."""
    tol = _tol(dtype)
    with torch.inference_mode():
        x = (_randn(shape, torch.float32, 11, cuda) * 1.5 + 0.3).to(dtype)
        want = minibatch_stddev_ref(x)
        atol = tol * want.abs().max().item()
        out = minibatch_stddev_cuda(x)
        assert minibatch_stddev_path(x, out).startswith(path)
        torch.testing.assert_close(out, want, rtol=0, atol=atol)
        assert torch.equal(out, minibatch_stddev_cuda(x))
        assert torch.equal(out[:, :-1], x)
        xu = _unaligned_copy(x)
        out_u = minibatch_stddev_cuda(xu)
        assert minibatch_stddev_path(xu, out_u).startswith("element")
        torch.testing.assert_close(out_u, want, rtol=0, atol=atol)
        for cluster in (1, 2, 4):
            torch.testing.assert_close(
                minibatch_stddev_cuda(x, cluster=cluster), want, rtol=0,
                atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("shape,plan", [
    # the run kernel: planes under a tile, odd H*W
    ((16, 512, 4, 4), "vector pixels, vector channel groups, cached"),
    ((3, 1000, 4, 4), "vector pixels, vector channel groups, two reads"),
    ((2, 3, 4, 4), "vector pixels, single channel groups, cached"),
    ((2, 512, 7, 7), "element pixels, vector channel groups, cached"),
    ((3, 5, 1, 1), "element pixels, single channel groups, cached"),
    ((2, 600, 3, 5), "element pixels, vector channel groups, two reads"),
    # the tile kernel, also at C = 256, 512 and 1000 with H*W that ends
    # the last tile ragged (72 and 120 pixels)
    ((4, 256, 16, 16), "tile 128 B, vector channel groups"),
    ((2, 128, 32, 32), "tile 128 B, vector channel groups"),
    ((3, 1000, 4, 8), "tile 128 B, vector channel groups"),
    ((2, 3, 8, 8), "tile 128 B, single channel groups"),
    ((2, 256, 9, 8), "tile 128 B, vector channel groups"),
    ((3, 512, 10, 12), "tile 128 B, vector channel groups"),
    ((2, 1000, 6, 20), "tile 128 B, vector channel groups"),
], ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple)
    else v.split(",")[0].replace(" ", "-"))
def test_pixel_norm_nchw_on_card(cuda, shape, plan, dtype):
    """The channel kernels on each of their plans against the plain version
    (float32 1e-5, bf16 2**-6, f16 2**-9 of the scale), also from an
    unaligned pointer (element pixels), and bit for bit against the rows
    kernel on the same values transposed to (N*H*W, C), and against the
    run kernel forced on the same values."""
    tol = 1e-5 if dtype == torch.float32 else \
        2 ** -6 if dtype == torch.bfloat16 else 2 ** -9
    n, c, h, w = shape
    with torch.inference_mode():
        x = _randn(shape, dtype, 6, cuda) * 1.5
        want = pixel_norm_nchw_ref(x)
        out = pixel_norm_nchw_cuda(x)
        if dtype == torch.float32:    # the plans of float32 listed above
            assert pixel_norm_nchw_path(x, out).startswith(plan), \
                pixel_norm_nchw_path(x, out)
        atol = tol * want.abs().max().item()
        torch.testing.assert_close(out, want, rtol=0, atol=atol)
        rows = pixel_norm_cuda(
            x.permute(0, 2, 3, 1).reshape(-1, c).contiguous())
        assert torch.equal(out, rows.view(n, h, w, c).permute(0, 3, 1, 2))
        xu = _unaligned_copy(x)
        out_u = pixel_norm_nchw_cuda(xu)
        assert pixel_norm_nchw_path(xu, out_u).startswith("element")
        assert torch.equal(out_u, out)
        assert torch.equal(pixel_norm_nchw_cuda(x, tile=-1), out)


@pytest.mark.gpu
def test_pixel_norm_nchw_function_on_card(cuda):
    """``pixel_norm(x, dim=1)`` launches the channel kernel (never the
    rows kernel), and its gradient matches autograd through the plain
    version (float32, 1e-5 of the scale)."""
    from ganlab_tpu_torch import ops

    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(4, 64, 8, 8, generator=g, device=cuda,
                    requires_grad=True)
    rows0, nchw0 = pixel_norm_cuda.launches, pixel_norm_nchw_cuda.launches
    out = ops.pixel_norm(x, dim=1)
    assert pixel_norm_nchw_cuda.launches == nchw0 + 1
    assert pixel_norm_cuda.launches == rows0 + 1      # the shared count
    ct = torch.randn(out.shape, generator=g, device=cuda)
    (got,) = torch.autograd.grad(out, x, ct)
    (want,) = torch.autograd.grad(pixel_norm_nchw_ref(x), x, ct)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * want.abs().max().item())


def _plain_ops():
    from ganlab_tpu_torch.ops.kernels.adain import adain_ref
    return {"up": upsample_blur_2x_ref, "down": blur_downsample_2x_ref,
            "mbstd": minibatch_stddev_ref, "adain": adain_ref,
            "pixel_norm": pixel_norm_ref}


def _kernel_ops():
    from ganlab_tpu_torch import ops
    return {"up": ops.upsample_blur_2x, "down": ops.blur_downsample_2x,
            "mbstd": ops.minibatch_stddev, "adain": ops.adain,
            "pixel_norm": ops.pixel_norm}


@pytest.mark.gpu
def test_function_grads_match_plain_on_card(cuda):
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(1)

    def r(*s):
        return torch.randn(s, generator=g, device=cuda, requires_grad=True)

    cases = {"up": (r(4, 8, 8, 8),), "down": (r(4, 8, 16, 16),),
             "mbstd": (r(8, 16, 4, 4),),
             "adain": (r(4, 8, 8, 8), r(4, 8), r(4, 8)),
             "pixel_norm": (r(8, 64),)}
    kern, plain = _kernel_ops(), _plain_ops()
    for name, args in cases.items():
        ct = torch.randn(kern[name](*args).shape, generator=g, device=cuda)
        got = torch.autograd.grad(kern[name](*args), args, ct)
        want = torch.autograd.grad(plain[name](*args), args, ct)
        for a, b in zip(got, want):
            scale = b.abs().max().item()
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * scale)


@pytest.mark.gpu
def test_second_order_through_kernels_on_card(cuda):
    """R1's shape of derivative, grad(grad(f(x) c, x)^2, params), through
    up -> conv -> down -> conv -> down -> mbstd, kernels vs plain."""
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(8, 4, 8, 8, generator=g, device=cuda)
    w1 = torch.randn(6, 4, 3, 3, generator=g, device=cuda) * 0.3
    w2 = torch.randn(6, 6, 3, 3, generator=g, device=cuda) * 0.3
    w3 = torch.randn(7 * 16, generator=g, device=cuda) * 0.1
    params = [w.requires_grad_(True) for w in (w1, w2, w3)]

    def chain(ops, x):
        h = ops["up"](x)
        h = torch.nn.functional.leaky_relu(
            torch.nn.functional.conv2d(h, w1, padding=1), 0.2)
        h = ops["down"](h)
        h = torch.nn.functional.leaky_relu(
            torch.nn.functional.conv2d(h, w2, padding=1), 0.2)
        h = ops["mbstd"](ops["down"](h))
        return h.flatten(1) @ w3

    def r1(ops):
        xi = x.clone().requires_grad_(True)
        (gx,) = torch.autograd.grad(chain(ops, xi).sum(), xi,
                                    create_graph=True)
        return torch.autograd.grad(gx.square().sum(), params)

    for a, b in zip(r1(_kernel_ops()), r1(_plain_ops())):
        scale = b.abs().max().item()
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * scale)


def _stylegan2_shapes():
    """kernel -> the shapes a stylegan2-256 served batch of 32, a step at
    batch 8 and a path-length step (batch 4) give it (chip_smoke derives
    them from the model's structure)."""
    import chip_smoke
    from ganlab_tpu_torch.config import get_config

    shapes: dict = {}
    for unit in chip_smoke.sg2_launch_units(
            get_config("stylegan2-256").model).values():
        for name, by_shape in unit.items():
            shapes.setdefault(name, set()).update(by_shape)
    return shapes


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stylegan2_shapes_on_card(cuda, dtype):
    """The resample kernels at every shape of the StyleGAN2 path (the
    3-channel skip RGBs, the residual D's two blur+downs a block), with
    the gains their autograd Functions give them, against the plain
    versions."""
    tol = _tol(dtype)
    shapes = _stylegan2_shapes()
    assert (32, 3, 128, 128) in shapes["upsample_blur_2x"]
    assert (8, 3, 256, 256) in shapes["blur_downsample_2x"]
    with torch.inference_mode():
        for name, kern, ref, gains in (
                ("upsample_blur_2x", upsample_blur_2x_cuda,
                 upsample_blur_2x_ref, (1.0, 0.25)),
                ("blur_downsample_2x", blur_downsample_2x_cuda,
                 blur_downsample_2x_ref, (1.0, 4.0))):
            for i, shape in enumerate(sorted(shapes[name])):
                x = _randn(shape, dtype, i, cuda)
                for gain in gains:
                    want = ref(x, gain)
                    torch.testing.assert_close(
                        kern(x, gain), want, rtol=tol,
                        atol=tol * want.abs().max().item())


@pytest.mark.gpu
def test_path_length_second_order_through_kernels_on_card(cuda):
    """Path length's shape of derivative (the gradient with respect to the
    styles with its graph, then the gradient of the lengths' deviation
    with respect to every parameter) through up+blur and blur+down, the
    Functions against the plain versions, float32."""
    import chip_smoke

    torch.backends.cudnn.allow_tf32 = False
    kern, plain = _kernel_ops(), _plain_ops()
    got = chip_smoke.pl_second_order(kern["up"], kern["down"], cuda)
    want = chip_smoke.pl_second_order(plain["up"], plain["down"], cuda)
    for a, b in zip(got, want):
        scale = b.abs().max().item()
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * scale)
