"""The arithmetic of the kernels' large-plane paths, emulated on the CPU.

The CUDA kernels run only on the card. These plain emulations check two
things of their large-plane designs against the JAX package on the same
seeded numpy inputs; they run no code of the port, and the kernels' own
bits are held by the card tests and ``chip_smoke.py``:

* AdaIN (``csrc/adain.cu``): the combination of partial statistics. The
  split path's emulation cuts each plane into slices, takes each slice's
  mean and M2 with numpy sums, and combines them in slice order by Chan's
  formula in delta form, then ``(x - mean) * rsqrt(M2 / HW + eps) * s +
  b``; the cluster path's emulation adds one numpy sum a block in rank
  order. Neither follows the kernels' order inside a slice (registers,
  staged chunks, warp shuffle, block sum). Against the JAX ``adain`` (XLA)
  and ``adain_pallas`` in interpret mode: float32 within 1e-5 of the
  output's scale; constant planes give the bias bit for bit.
* The NCHW pixelnorm's tile kernel (``csrc/pixelnorm.cu``): that its
  swizzled shared-memory layout maps no two entries of a 128-byte tile to
  one slot. The tile is written and read back through the same layout, so
  the sums equal the rows kernel's order bit for bit unless two entries
  collide; they are also held within 1e-5 of the JAX ``pixel_norm``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganlab_tpu import ops as jops
from ganlab_tpu.ops.pallas import adain_pallas

F32 = np.float32
EPS = 1e-8


def _rand(shape, seed, loc=0.0, scale=1.0):
    rs = np.random.RandomState(seed)
    return (loc + scale * rs.randn(*shape)).astype(F32)


# -- AdaIN ---------------------------------------------------------------------

def _apply(x, mean, m2, hw, s, b):
    """(x - mean) * a + b with a = rsqrt(M2 / HW + eps) * s, in float32."""
    r = F32(1.0) / np.sqrt(F32(m2) / F32(hw) + F32(EPS), dtype=F32)
    return (x - F32(mean)) * F32(r * F32(s)) + F32(b)


def adain_split(x, s, b, slice_elems):
    """The split path on planes of (N, C, HW) float32: per slice of
    ``slice_elems`` elements (the last one ragged) the mean and M2, then
    the plane's mean and M2 by Chan's formula in slice order."""
    n, c, hw = x.shape
    out = np.empty_like(x)
    for i in range(n):
        for j in range(c):
            plane = x[i, j]
            parts = []
            for lo in range(0, hw, slice_elems):
                sl = plane[lo:lo + slice_elems]
                mb = F32(sl.sum(dtype=F32) / F32(sl.size))
                parts.append((F32(sl.size), mb,
                              np.square(sl - mb, dtype=F32).sum(dtype=F32)))
            na, mean, m2 = parts[0]
            for nb, mb, m2b in parts[1:]:
                nn = F32(na + nb)
                delta = F32(mb - mean)
                mean = F32(mean + F32(delta * nb) / nn)
                m2 = F32(m2 + F32(m2b + F32(F32(delta * delta) * na * nb)
                                  / nn))
                na = nn
            out[i, j] = _apply(plane, mean, m2, hw, s[i, j], b[i, j])
    return out


def adain_cluster(x, s, b, blocks):
    """The cluster path's sums: the plane cut into
    ``blocks`` contiguous slices, each block's sum added in rank order,
    for the mean and then for the squared deviations."""
    n, c, hw = x.shape
    per = -(-hw // blocks)
    out = np.empty_like(x)
    for i in range(n):
        for j in range(c):
            plane = x[i, j]
            slices = [plane[r * per:(r + 1) * per] for r in range(blocks)]
            total = F32(0)
            for sl in slices:
                total = F32(total + sl.sum(dtype=F32))
            mean = F32(total / F32(hw))
            m2 = F32(0)
            for sl in slices:
                m2 = F32(m2 + np.square(sl - mean, dtype=F32).sum(dtype=F32))
            out[i, j] = _apply(plane, mean, m2, hw, s[i, j], b[i, j])
    return out


def _planes(kind, shape, seed):
    return {"random": lambda: _rand(shape, seed, 0.5, 2.0),
            "constant": lambda: np.full(shape, 1.5, F32),
            "large mean": lambda: _rand(shape, seed, 1000.0, 16.0)}[kind]()


def _jax_adain(x_nchw, s, b):
    """Both JAX versions on the NHWC transpose, back to (N, C, HW)."""
    n, c, h, w = x_nchw.shape
    xj = jnp.asarray(x_nchw.transpose(0, 2, 3, 1))
    outs = (jops.adain(xj, jnp.asarray(s), jnp.asarray(b)),
            adain_pallas(xj, jnp.asarray(s), jnp.asarray(b), EPS, True))
    return [np.asarray(o).transpose(0, 3, 1, 2).reshape(n, c, h * w)
            for o in outs]


@pytest.mark.parametrize("planes", ["random", "constant", "large mean"])
@pytest.mark.parametrize("shape,slice_elems", [
    ((2, 3, 13, 11), 32),      # 143 elements: 4 full slices and a ragged one
    ((1, 2, 24, 24), 64),      # slices that divide the plane
    ((2, 2, 20, 20), 7),       # many slices, the last of 1 element
    ((1, 3, 9, 8), 1000),      # one slice: the plane itself
], ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_adain_split_path_matches_jax(shape, slice_elems, planes):
    n, c, h, w = shape
    x = _planes(planes, shape, 11)
    s, b = _rand((n, c), 12, 1.0), _rand((n, c), 13)
    got = adain_split(x.reshape(n, c, h * w), s, b, slice_elems)
    for want in _jax_adain(x, s, b):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()))
    if planes == "constant":
        # each slice's mean is v and its M2 is 0, so delta stays 0
        assert np.array_equal(got, np.broadcast_to(b[:, :, None], got.shape))


@pytest.mark.parametrize("planes", ["random", "constant", "large mean"])
@pytest.mark.parametrize("shape,blocks", [
    ((2, 3, 16, 16), 16),      # slices that divide the plane
    ((1, 2, 13, 11), 16),      # 143 elements over 16 blocks: ragged
], ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_adain_cluster_sums_match_jax(shape, blocks, planes):
    """Against both JAX versions and a float64 numpy AdaIN, 1e-5 of the
    output's scale; on the planes of 1000 + 16 noise against the float64
    one alone: there the JAX float32 mean of a 16x16 plane is itself off
    by up to ~8 ulps of 1000 (1.05e-5 of the scale at this seed), the
    emulation's by under one."""
    n, c, h, w = shape
    x = _planes(planes, shape, 21)
    s, b = _rand((n, c), 22, 1.0), _rand((n, c), 23)
    got = adain_cluster(x.reshape(n, c, h * w), s, b, blocks)
    x64 = x.reshape(n, c, h * w).astype(np.float64)
    mean = x64.mean(2, keepdims=True)
    var = np.square(x64 - mean).mean(2, keepdims=True)
    exact = (x64 - mean) / np.sqrt(var + EPS) * s[:, :, None] + b[:, :, None]
    wants = [exact] + ([] if planes == "large mean" else _jax_adain(x, s, b))
    for want in wants:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()))
    if planes == "constant":
        assert np.array_equal(got, np.broadcast_to(b[:, :, None], got.shape))


# -- pixelnorm over NCHW channels ----------------------------------------------

def _butterfly(lanes):
    """The xor butterfly over 32 lanes (last axis); every lane ends with
    the same bits, lane 0 is returned."""
    idx = np.arange(32)
    for d in (16, 8, 4, 2, 1):
        lanes = (lanes + lanes[..., idx ^ d]).astype(F32)
    return lanes[..., 0]


def rows_order_sumsq(rows, nc):
    """The rows kernel's per-row sum of squares of (R, C): lane l sums the
    groups l, l + 32, ... of nc channels each in order, then the
    butterfly."""
    r, c = rows.shape
    lanes = np.zeros((r, 32), F32)
    for lane in range(32):
        for i in range(lane, c // nc, 32):
            for e in range(nc):
                v = rows[:, nc * i + e]
                lanes[:, lane] = (lanes[:, lane] + v * v).astype(F32)
    return _butterfly(lanes)


def tile_order_sumsq(x, nc, itemsize):
    """The tile kernel's per-pixel sums of squares of x (N, C, HW): each
    tile of 128 bytes of every plane written into the swizzled layout as
    the load phase does, then warp q / lane l reading vector (plane NC*i +
    e, column q) back through the same layout."""
    v = 16 // itemsize
    qp = 8                     # 16-byte vectors of a plane in a tile
    n, c, hw = x.shape
    groups = c // nc

    def at(r, q):
        return r * qp + (q ^ ((r // nc) & (qp - 1)))

    out = np.full((n, hw), np.nan, F32)
    for img in range(n):
        for p0 in range(0, hw, qp * v):
            nq = min(qp, (hw - p0) // v)
            smem = np.full((c * qp, v), np.nan, F32)
            for r in range(c):
                for q in range(nq):
                    smem[at(r, q)] = x[img, r, p0 + q * v:p0 + (q + 1) * v]
            for q in range(nq):
                lanes = np.zeros((v, 32), F32)
                for lane in range(32):
                    for i in range(lane, groups, 32):
                        for e in range(nc):
                            f = smem[at(nc * i + e, q)]
                            lanes[:, lane] = (lanes[:, lane] + f * f) \
                                .astype(F32)
                out[img, p0 + q * v:p0 + (q + 1) * v] = _butterfly(lanes)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,h,w", [
    (256, 9, 8),               # 72 pixels: a full tile and a ragged one
    (512, 4, 8),               # 32 pixels: one tile, ragged in bf16
    (1000, 6, 4),              # C = 1000, 24 pixels: one ragged tile
    (24, 8, 12),               # fewer than 32 groups
    (3, 4, 8),                 # channel groups of one (C * itemsize % 16)
], ids=lambda v: str(v))
def test_nchw_tile_order_is_the_rows_order(c, h, w, dtype):
    itemsize = 4 if dtype == "float32" else 2
    nc = 16 // itemsize if (c * itemsize) % 16 == 0 else 1
    x = _rand((2, c, h, w), 31, 0.0, 1.7)
    if dtype == "bfloat16":      # the values a bf16 tensor holds
        x = torch.from_numpy(x).bfloat16().float().numpy()
    hw = h * w
    got = tile_order_sumsq(x.reshape(2, c, hw), nc, itemsize)
    rows = x.transpose(0, 2, 3, 1).reshape(-1, c)
    want = rows_order_sumsq(rows, nc).reshape(2, hw)
    assert np.array_equal(got, want)
    y = x.reshape(2, c, hw) / np.sqrt(got[:, None, :] / F32(c) + F32(EPS),
                                      dtype=F32)
    ref = np.asarray(jops.pixel_norm(jnp.asarray(x.transpose(0, 2, 3, 1))))
    np.testing.assert_allclose(y.reshape(2, c, h, w).transpose(0, 2, 3, 1),
                               ref, rtol=1e-5, atol=1e-5)
