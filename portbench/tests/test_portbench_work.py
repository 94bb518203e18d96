"""The work counts, by hand, and the whole-cycle window."""

import json

import pytest

from conftest import PORTBENCH, load

from portbench.work import flops, ops

M256 = {"resolution": 256, "img_channels": 3, "latent_dim": 512,
        "fmap_base": 8192, "fmap_max": 512, "fmap_min": 1,
        "mapping_layers": 8}
M1024 = dict(M256, resolution=1024)
PEAKS = json.load(open(PORTBENCH / "peaks.json"))["NVIDIA H100 80GB HBM3"]


def test_g_block_by_hand():
    # the 256^2 block: 3x3 convs 128 -> 64 and 64 -> 64 over 256^2
    by_hand = 9 * 65536 * (128 * 64 + 64 * 64)
    assert flops.g_block_macs(M256, 8) == by_hand
    assert by_hand == pytest.approx(7.25e9, rel=1e-3)
    # 512^2 (64 -> 32, 32 -> 32) and 1024^2 (32 -> 16, 16 -> 16) the same
    assert flops.g_block_macs(M1024, 9) == by_hand
    assert flops.g_block_macs(M1024, 10) == by_hand


def test_g_forward_totals():
    assert flops.g_forward_macs(M256) / 1e9 == pytest.approx(28.14, abs=0.01)
    assert flops.g_forward_macs(M1024) - flops.g_forward_macs(M256) \
        == 2 * flops.g_block_macs(M256, 8) \
        + 3 * 1024 ** 2 * 16 - 3 * 256 ** 2 * 64 \
        + 4 * 512 * (32 + 16)
    assert flops.g_forward_macs(M1024) / 1e9 == pytest.approx(42.67,
                                                             abs=0.01)


def test_train_step_flops():
    g = flops.g_forward_macs(M256) + 2 * flops.mapping_macs(M256)
    d = flops.d_forward_macs(M256)
    assert flops.train_step_flops(M256, 32, False) == 2 * 32 * (4 * g + 8 * d)
    assert flops.train_step_flops(M256, 32, True) == 2 * 32 * (4 * g + 14 * d)


def test_adain_bytes_match_the_kernel_table():
    """A served stylegan-256 batch of 32: 14 AdaIN launches, bound
    0.61431 ms in PERF.md's kernel table (bytes once / 3.35 TB/s; the
    table leaves out the two (B, C) styles, a 0.01% part)."""
    s = ops.least_seconds(M256, [["adain", "forward"]], "serve", 32, False,
                          2, PEAKS)
    assert s * 1e3 == pytest.approx(0.61431, rel=2e-4)


def test_blur_down_kernel_bytes_match_the_kernel_table():
    """The blur + 2x down kernel over an R1-off stylegan-256 step at batch
    32: 24 launches (D forward x 3, G's upsample backward), bound 1.46801
    ms in the kernel table."""
    kf = json.load(open(PORTBENCH / "kernels" / "blur_down.json"))
    s = ops.least_seconds(M256, kf["passes"], "train", 32, False, 2, PEAKS)
    assert s * 1e3 == pytest.approx(1.46801, rel=1e-3)


def test_pass_counts_match_launch_counts():
    """Kernel launches a stylegan-256 step R1-off / R1-on (PERF.md's
    kernel table): up+blur 30 / 42, blur+down 24 / 36, mbstd 3 / 4."""
    L = 8
    for r1, up, down, mb in ((False, 30, 24, 3), (True, 42, 36, 4)):
        c = ops.pass_counts("train", r1)
        up_n = (L - 2) * (c[("g", "forward")] + c[("d", "backward")])
        down_n = (L - 2) * (c[("d", "forward")] + c[("g", "backward")]
                            + c[("d", "double_backward")])
        assert (up_n, down_n, c[("d", "forward")]) == (up, down, mb)


def test_whole_cycle_window():
    train = load("portbench_driver_train", PORTBENCH / "drivers" / "train.py")
    # cycles of 14.2 s in a 51 s window: three, never a fourth
    n, t, longest = 0, 0.0, 0.0
    while train.another_cycle(n, 2, t, longest, 51.0):
        t += 14.2
        longest = 14.2
        n += 1
    assert n == 3 and t <= 51.0
    # the minimum holds even when a cycle outlasts the window
    assert train.another_cycle(1, 2, 60.0, 60.0, 10.0)
    assert not train.another_cycle(2, 2, 60.0, 60.0, 10.0)
    # the window's work: every cycle one R1 step and 15 off steps
    kfs = {p.stem: json.load(open(p))
           for p in (PORTBENCH / "kernels").glob("*.json")}
    w = train.window_work(M256, 32, 16, 3, kfs, 2, PEAKS)
    assert w["model_flops"] == 3 * (flops.train_step_flops(M256, 32, True)
                                    + 15 * flops.train_step_flops(M256, 32,
                                                                  False))
    one = train.window_work(M256, 32, 16, 1, kfs, 2, PEAKS)
    for k, v in w["least_s"].items():
        assert v == pytest.approx(3 * one["least_s"][k])
