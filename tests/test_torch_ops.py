"""PyTorch port ops vs the JAX package (ganlab_tpu_torch.ops).

The same seeded numpy inputs go through the JAX op (XLA, and the Pallas
kernel in interpret mode) and through the port's op on the CPU, which is
the kernel's plain PyTorch version; the port is NCHW, so tensors are
transposed at the boundary. Tolerances: float32 1e-5 (the same math in
another summation order); bfloat16 2 ulps of the output's scale (both
sides round once to bf16, the XLA op also rounds inside). The kernels
themselves are held against the plain versions in test_torch_kernels.py.
Gradients (jax.vjp against torch autograd through the port's autograd
Functions, same cotangent) use the float32 tolerance; the Functions'
own first and second derivatives are checked in float64 by
``torch.autograd.gradcheck`` / ``gradgradcheck`` (their defaults). The
resample ops' ``gain`` is held to ``gain *`` the JAX op within 1e-6 of the
output's scale in float32 (one more float32 multiply on either side).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganlab_tpu import ops as jops
from ganlab_tpu.ops import equalized as jeq
from ganlab_tpu.ops.pallas import (
    adain_pallas,
    blur_downsample_2x_pallas,
    minibatch_stddev_pallas,
    pixel_norm_pallas,
    upsample_blur_2x_pallas,
)
from ganlab_tpu_torch import ops as tops
from ganlab_tpu_torch.ops.kernels.adain import adain_ref
from ganlab_tpu_torch.ops.kernels.pixelnorm import pixel_norm_ref
from ganlab_tpu_torch.ops.kernels.resample import (
    BlurDownsample2x,
    UpsampleBlur2x,
    blur_downsample_2x_ref,
    upsample_blur_2x_ref,
)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def rand(*shape, seed=0, loc=0.0, scale=1.0):
    rs = np.random.RandomState(seed)
    return (loc + scale * rs.randn(*shape)).astype(np.float32)


def to_np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a.astype(jnp.float32))


def nchw(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a.transpose(0, 3, 1, 2))


def nhwc(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a.transpose(0, 2, 3, 1))


def assert_close(got, want, dtype: str):
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        scale = float(np.abs(want).max())
        ulp = 2.0 ** (math.floor(math.log2(scale)) - 7)
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * ulp)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("ref", ["xla", "pallas"])
@pytest.mark.parametrize("shape", [(4, 64), (2, 4, 4, 16)])
def test_pixel_norm(shape, ref, dtype):
    jd, td = DTYPES[dtype]
    x = rand(*shape, seed=1)
    xj = jnp.asarray(x, jd)
    want = jops.pixel_norm(xj) if ref == "xla" \
        else pixel_norm_pallas(xj, 1e-8, True)
    got = tops.pixel_norm(torch.from_numpy(x).to(td))
    assert got.dtype == td
    assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("c", [96, 500, 512])
def test_pixel_norm_ref_vs_pallas_widths(c, dtype):
    """The plain version against the Pallas kernel (interpret mode) at
    widths that are and are not a multiple of a 16-byte vector."""
    jd, td = DTYPES[dtype]
    x = rand(6, c, seed=30 + c)
    want = pixel_norm_pallas(jnp.asarray(x, jd), 1e-8, True)
    got = pixel_norm_ref(torch.from_numpy(x).to(td))
    assert got.dtype == td
    assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("ref", ["xla", "pallas"])
@pytest.mark.parametrize("shape", [(2, 4, 4, 8), (2, 16, 16, 4)])
def test_adain(shape, ref, dtype):
    jd, td = DTYPES[dtype]
    n, _, _, c = shape
    x = rand(*shape, seed=2, loc=0.5, scale=2.0)
    s = rand(n, c, seed=3, loc=1.0)
    b = rand(n, c, seed=4)
    xj, sj, bj = (jnp.asarray(a, jd) for a in (x, s, b))
    want = jops.adain(xj, sj, bj) if ref == "xla" \
        else adain_pallas(xj, sj, bj, 1e-8, True)
    got = tops.adain(*(torch.from_numpy(a).to(td) for a in (nchw(x), s, b)))
    assert got.dtype == td
    assert_close(nhwc(to_np(got)), want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,planes", [
    ((2, 5, 7, 3), "random"),        # H*W no multiple of a 16-byte vector
    ((3, 33, 31, 5), "random"),
    ((2, 48, 48, 3), "random"),      # a plane that fills no power of two
    ((2, 4, 4, 8), "constant"),      # variance 0, as StyleGAN's 4x4 at init
    ((2, 16, 16, 4), "constant"),
    ((2, 8, 8, 4), "large mean"),    # where E[x^2] - mean^2 would fail
    ((2, 48, 48, 3), "large mean"),
], ids=lambda v: v.replace(" ", "_") if isinstance(v, str)
    else "x".join(map(str, v)))
def test_adain_ref_vs_pallas_planes(shape, planes, dtype):
    """The plain version against the Pallas kernel (interpret mode) at odd
    plane sizes, on constant planes (the output is the bias) and on planes
    whose mean is far above their spread (1000 + 16 noise)."""
    jd, td = DTYPES[dtype]
    n, _, _, c = shape
    x = {"random": lambda: rand(*shape, seed=40, loc=0.5, scale=2.0),
         "constant": lambda: np.full(shape, 1.5, np.float32),
         "large mean": lambda: rand(*shape, seed=41, loc=1000.0, scale=16.0),
         }[planes]()
    s = rand(n, c, seed=42, loc=1.0)
    b = rand(n, c, seed=43)
    want = adain_pallas(*(jnp.asarray(a, jd) for a in (x, s, b)), 1e-8, True)
    got = adain_ref(*(torch.from_numpy(a).to(td) for a in (nchw(x), s, b)))
    assert got.dtype == td
    if planes == "large mean" and dtype == "float32":
        # the mean of values near 1000 is good to ~1e-4 in float32 on
        # either side: 1e-5 of the output's scale, not of each element
        want = to_np(want)
        np.testing.assert_allclose(nhwc(to_np(got)), want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()))
    else:
        assert_close(nhwc(to_np(got)), want, dtype)
    if planes == "constant":
        bias = torch.from_numpy(b).to(td)[:, :, None, None]
        assert torch.equal(got, bias.expand_as(got))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("ref", ["xla", "pallas"])
@pytest.mark.parametrize("shape", [(2, 4, 4, 8), (1, 5, 7, 3)])
def test_upsample_blur_2x(shape, ref, dtype):
    jd, td = DTYPES[dtype]
    x = rand(*shape, seed=5)
    xj = jnp.asarray(x, jd)
    want = jops.upsample_blur_2x(xj) if ref == "xla" \
        else upsample_blur_2x_pallas(xj, True)
    got = tops.upsample_blur_2x(torch.from_numpy(nchw(x)).to(td))
    assert got.dtype == td
    assert_close(nhwc(to_np(got)), want, dtype)


def test_instance_norm():
    x = rand(2, 6, 5, 3, seed=14, loc=0.5, scale=2.0)
    got = tops.instance_norm(torch.from_numpy(nchw(x)))
    want = jops.instance_norm(jnp.asarray(x))
    assert_close(nhwc(got.numpy()), want, "float32")


def test_upsample_nearest_2x():
    x = rand(2, 3, 5, 4, seed=6)
    got = tops.upsample_nearest_2x(torch.from_numpy(nchw(x)))
    want = jops.upsample_nearest_2x(jnp.asarray(x))
    np.testing.assert_array_equal(nhwc(got.numpy()), np.asarray(want))


@pytest.mark.parametrize("gain,lr_mult,bias", [
    (math.sqrt(2.0), 1.0, True), (math.sqrt(2.0), 0.01, True),
    (1.0, 1.0, False)])
def test_equalized_dense(gain, lr_mult, bias):
    x, w, b = rand(4, 16, seed=7), rand(16, 8, seed=8), rand(8, seed=9)
    want = jeq.equalized_dense(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(b) if bias else None,
                               gain=gain, lr_mult=lr_mult)
    got = tops.equalized_dense(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(b) if bias else None,
                               gain=gain, lr_mult=lr_mult)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k,gain,lr_mult", [
    (3, math.sqrt(2.0), 1.0), (1, 1.0, 1.0), (3, 1.0, 0.5)])
def test_equalized_conv2d(k, gain, lr_mult):
    x = rand(2, 6, 6, 4, seed=10)
    w = rand(k, k, 4, 5, seed=11)                      # HWIO
    b = rand(5, seed=12)
    want = jeq.equalized_conv2d(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b), gain=gain, lr_mult=lr_mult)
    got = tops.equalized_conv2d(
        torch.from_numpy(nchw(x)),
        torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))),
        torch.from_numpy(b), gain=gain, lr_mult=lr_mult)
    np.testing.assert_allclose(nhwc(got.numpy()), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_leaky_relu():
    x = rand(3, 17, seed=13)
    np.testing.assert_allclose(
        tops.leaky_relu(torch.from_numpy(x)).numpy(),
        np.asarray(jeq.leaky_relu(jnp.asarray(x))), rtol=1e-6, atol=0)


# -- training-path ops: blur+down, mbstd, and the autograd Functions ---------

def to_torch(a: np.ndarray, requires_grad=False) -> torch.Tensor:
    return torch.from_numpy(a.copy()).requires_grad_(requires_grad)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("ref", ["xla", "pallas"])
@pytest.mark.parametrize("shape", [(2, 8, 8, 4), (1, 6, 10, 3)])
def test_blur_downsample_2x(shape, ref, dtype):
    jd, td = DTYPES[dtype]
    x = rand(*shape, seed=15)
    xj = jnp.asarray(x, jd)
    want = jops.blur_downsample_2x(xj) if ref == "xla" \
        else blur_downsample_2x_pallas(xj, True)
    got = tops.blur_downsample_2x(torch.from_numpy(nchw(x)).to(td))
    assert got.dtype == td
    assert_close(nhwc(to_np(got)), want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [
    (2, 34, 30, 3), (3, 14, 48, 5), (1, 10, 528, 2), (2, 18, 16, 2),
    (2, 66, 62, 3)], ids=lambda v: "x".join(map(str, v)))
def test_blur_downsample_2x_ref_vs_pallas_shapes(shape, dtype):
    """The plain version against the Pallas kernel (interpret mode) at the
    shapes that exercise both paths of the CUDA kernel: output widths that
    are and are not a multiple of a 16-byte vector, rows wider than a
    warp's worth of vectors, odd heights."""
    jd, td = DTYPES[dtype]
    x = rand(*shape, seed=44)
    want = blur_downsample_2x_pallas(jnp.asarray(x, jd), True)
    got = blur_downsample_2x_ref(torch.from_numpy(nchw(x)).to(td))
    assert got.dtype == td
    assert_close(nhwc(to_np(got)), want, dtype)


@pytest.mark.parametrize("gain", [0.25, 4.0, 0.3])
@pytest.mark.parametrize("ref", ["xla", "pallas"])
@pytest.mark.parametrize("op", ["up", "down"])
def test_resample_ref_gain(op, ref, gain):
    """``*_ref(x, gain)`` is ``gain *`` the JAX function: float32, within
    1e-6 of the output's scale."""
    x = rand(2, 6, 8, 3, seed=31)
    xj = jnp.asarray(x)
    if op == "up":
        want = jops.upsample_blur_2x(xj) if ref == "xla" \
            else upsample_blur_2x_pallas(xj, True)
        got = upsample_blur_2x_ref(torch.from_numpy(nchw(x)), gain)
    else:
        want = jops.blur_downsample_2x(xj) if ref == "xla" \
            else blur_downsample_2x_pallas(xj, True)
        got = blur_downsample_2x_ref(torch.from_numpy(nchw(x)), gain)
    want = gain * np.asarray(want)
    np.testing.assert_allclose(nhwc(got.numpy()), want, rtol=0,
                               atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("ref", ["xla", "pallas"])
@pytest.mark.parametrize("shape", [(4, 4, 4, 8), (3, 2, 3, 5)])
def test_minibatch_stddev(shape, ref, dtype):
    jd, td = DTYPES[dtype]
    x = rand(*shape, seed=16, loc=0.3, scale=1.5)
    xj = jnp.asarray(x, jd)
    want = jops.minibatch_stddev(xj) if ref == "xla" \
        else minibatch_stddev_pallas(xj, 1e-8, True)
    got = tops.minibatch_stddev(torch.from_numpy(nchw(x)).to(td))
    assert got.dtype == td and got.shape[1] == shape[3] + 1
    assert_close(nhwc(to_np(got)), want, dtype)


@pytest.mark.parametrize("group", [2, 3])
def test_minibatch_stddev_grouped(group):
    x = rand(6, 4, 4, 5, seed=17)
    want = jops.minibatch_stddev(jnp.asarray(x), group)
    got = tops.minibatch_stddev(torch.from_numpy(nchw(x)), group)
    assert_close(nhwc(to_np(got)), want, "float32")


def test_downsample_avg_2x_and_blur2d():
    x = rand(2, 6, 8, 3, seed=18)
    xt = torch.from_numpy(nchw(x))
    assert_close(nhwc(to_np(tops.downsample_avg_2x(xt))),
                 jops.downsample_avg_2x(jnp.asarray(x)), "float32")
    assert_close(nhwc(to_np(tops.blur2d(xt))),
                 jops.blur2d(jnp.asarray(x)), "float32")


def _vjp_pair(jax_fn, torch_fn, xs_nhwc, out_shape_nhwc, seed):
    """jax.vjp and torch autograd of the same function on the same inputs
    and the same cotangent; 4-d arrays cross the boundary NHWC <-> NCHW."""
    ct = rand(*out_shape_nhwc, seed=seed)
    _, vjp = jax.vjp(jax_fn, *(jnp.asarray(a) for a in xs_nhwc))
    want = vjp(jnp.asarray(ct))
    xt = [to_torch(nchw(a) if a.ndim == 4 else a, True) for a in xs_nhwc]
    out = torch_fn(*xt)
    ctt = torch.from_numpy(nchw(ct) if ct.ndim == 4 else ct)
    got = torch.autograd.grad(out, xt, ctt)
    for g, w in zip(got, want):
        g = to_np(g)
        assert_close(nhwc(g) if g.ndim == 4 else g, w, "float32")


@pytest.mark.parametrize("ref", ["xla", "pallas"])
def test_resample_grads(ref):
    x = rand(2, 8, 6, 3, seed=19)
    up = (lambda a: jops.upsample_blur_2x(a)) if ref == "xla" \
        else (lambda a: upsample_blur_2x_pallas(a, True))
    down = (lambda a: jops.blur_downsample_2x(a)) if ref == "xla" \
        else (lambda a: blur_downsample_2x_pallas(a, True))
    _vjp_pair(up, tops.upsample_blur_2x, [x], (2, 16, 12, 3), 20)
    _vjp_pair(down, tops.blur_downsample_2x, [x], (2, 4, 3, 3), 21)


@pytest.mark.parametrize("ref", ["xla", "pallas"])
def test_minibatch_stddev_grad(ref):
    x = rand(4, 4, 4, 6, seed=22, scale=2.0)
    fn = jops.minibatch_stddev if ref == "xla" \
        else (lambda a: minibatch_stddev_pallas(a, 1e-8, True))
    _vjp_pair(fn, tops.minibatch_stddev, [x], (4, 4, 4, 7), 23)


@pytest.mark.parametrize("ref", ["xla", "pallas"])
def test_adain_and_pixel_norm_grads(ref):
    x = rand(2, 4, 4, 6, seed=24, loc=0.5, scale=2.0)
    s, b = rand(2, 6, seed=25, loc=1.0), rand(2, 6, seed=26)
    fa = jops.adain if ref == "xla" \
        else (lambda *a: adain_pallas(*a, 1e-8, True))
    _vjp_pair(fa, tops.adain, [x, s, b], x.shape, 27)
    z = rand(5, 16, seed=28)
    fp = jops.pixel_norm if ref == "xla" \
        else (lambda a: pixel_norm_pallas(a, 1e-8, True))
    _vjp_pair(fp, tops.pixel_norm, [z], z.shape, 29)


def _f64(*shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=torch.float64,
                       requires_grad=True)


@pytest.mark.parametrize("name", ["upsample_blur_2x", "blur_downsample_2x",
                                  "minibatch_stddev", "adain", "pixel_norm"])
def test_functions_gradcheck_float64(name):
    """First and second derivatives of each autograd Function (its plain
    forward on the CPU, its own backward) against finite differences, in
    float64 (the plain versions compute in float64 for float64 input)."""
    fn, args = {
        "upsample_blur_2x": (tops.upsample_blur_2x, lambda: (
            _f64(2, 2, 3, 4, seed=1),)),
        "blur_downsample_2x": (tops.blur_downsample_2x, lambda: (
            _f64(2, 2, 6, 4, seed=2),)),
        "minibatch_stddev": (tops.minibatch_stddev, lambda: (
            _f64(4, 3, 2, 2, seed=3),)),
        "adain": (tops.adain, lambda: (
            _f64(2, 3, 3, 3, seed=4), _f64(2, 3, seed=5),
            _f64(2, 3, seed=6))),
        "pixel_norm": (tops.pixel_norm, lambda: (_f64(3, 5, seed=7),)),
    }[name]
    inputs = args()
    assert torch.autograd.gradcheck(fn, inputs)
    assert torch.autograd.gradgradcheck(fn, inputs)


@pytest.mark.parametrize("gain", [0.25, 4.0])
@pytest.mark.parametrize("fn,shape", [(UpsampleBlur2x, (2, 2, 3, 4)),
                                      (BlurDownsample2x, (2, 2, 6, 4))],
                         ids=["upsample_blur_2x", "blur_downsample_2x"])
def test_resample_functions_gradcheck_gain(fn, shape, gain):
    """First and second derivatives of the resample Functions with a gain,
    in float64 against finite differences."""
    inputs = (_f64(*shape, seed=8),)
    assert torch.autograd.gradcheck(lambda x: fn.apply(x, gain), inputs)
    assert torch.autograd.gradgradcheck(lambda x: fn.apply(x, gain), inputs)


def _graph_nodes(fn) -> list[str]:
    seen, stack, names = set(), [fn], []
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.append(type(node).__name__)
        stack.extend(nxt for nxt, _ in node.next_functions)
    return names


@pytest.mark.parametrize("fn,other,shape", [
    (BlurDownsample2x, "UpsampleBlur2xBackward", (1, 2, 6, 4)),
    (UpsampleBlur2x, "BlurDownsample2xBackward", (1, 2, 3, 4))],
    ids=["blur_downsample_2x", "upsample_blur_2x"])
def test_resample_backward_has_no_separate_multiply(fn, other, shape):
    """The factor between the two adjoints rides in the other Function's
    gain: the backward graph is that Function alone, with no Mul node."""
    x = _f64(*shape, seed=9)
    y = fn.apply(x)
    ct = torch.ones_like(y).requires_grad_(True)   # a leaf, as R1's is not
    (g,) = torch.autograd.grad(y, x, ct, create_graph=True)
    names = _graph_nodes(g.grad_fn)
    assert names == [other, "AccumulateGrad"], names
    want = {BlurDownsample2x: lambda a: 0.25 * upsample_blur_2x_ref(a),
            UpsampleBlur2x: lambda a: 4.0 * blur_downsample_2x_ref(a)}[fn]
    torch.testing.assert_close(g.detach(), want(ct.detach()))
