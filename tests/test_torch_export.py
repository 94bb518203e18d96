"""The exported sampler (``ganlab_tpu_torch/export.py``) and the kernels'
``torch.library`` operators it holds.

As ``tests/test_export.py`` for the JAX artifact: a tiny ``stylegan-256``
trained two steps through the port's ``Trainer`` on the CPU, exported
for the CPU alone; the artifact's images against ``BatchSampler``'s for
the same seed and batch size (at most one level apart and more than 99%
equal, the JAX test's limit; here they agree bit for bit), index
stability, ``generate_from_z`` with padding and psi as an input,
``meta.json`` and the refusal of an unknown ``format_version``, the
default platforms on a host without a card, ``cli export`` (also its
warning on an untrained workdir). The operators: each one's fake
implementation under ``torch.library.opcheck`` on the CPU registration,
shapes under ``FakeTensorMode``, and the exported graph calling them.
Each call's result, on the exported sampler and on ``BatchSampler`` (the
two share one result path), is C-contiguous, bit-equal to the sampler's
own device output, and the caller's own. On a card (``gpu`` marker): a
``cuda`` program launches the kernels, counted by their wrappers; on
either sampler a one-batch result is page-locked, and a dropped one's
block serves the next request.
"""

import json
import zipfile

import numpy as np
import pytest
import torch

from ganlab_tpu_torch.config import get_config
from ganlab_tpu_torch.export import (
    _NOISE_STREAM,
    FORMAT_VERSION,
    ExportedSampler,
    export_sampler,
)
from ganlab_tpu_torch.ops.kernels import adain, mbstd, pixelnorm, resample
from ganlab_tpu_torch.serve import BatchSampler
from ganlab_tpu_torch.utils.latents import stream_latents, stream_seed

torch.set_num_threads(1)

SETS = {"model.resolution": 16, "model.fmap_base": 128,
        "model.fmap_max": 16, "model.latent_dim": 16,
        "model.mapping_layers": 2, "run.compute_dtype": "float32",
        "schedule.progressive": False, "schedule.batch_schedule": {16: 4},
        "data.dataset": "synthetic"}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny stylegan trained 2 steps with a saved checkpoint."""
    from ganlab_tpu_torch.train import Trainer

    cfg = get_config("stylegan-256", **dict(SETS, **{
        "run.total_steps": 2, "run.log_every": 0, "run.sample_every": 0,
        "run.checkpoint_every": 0, "schedule.total_kimg": 1.0,
        "loss.penalty_every": 1}))
    wd = str(tmp_path_factory.mktemp("export"))
    tr = Trainer(cfg, workdir=wd, device="cpu")
    tr.train()
    state = tr.state
    tr.close()
    return cfg, wd, state


@pytest.fixture(scope="module")
def artifact(trained, tmp_path_factory):
    cfg, _, state = trained
    path = str(tmp_path_factory.mktemp("artifact") / "sampler.ganlab.zip")
    export_sampler(cfg, state, path, batch_size=4, platforms=("cpu",))
    return path


def _live(trained):
    cfg, _, state = trained
    return BatchSampler(cfg, state=state, batch_size=4, device="cpu")


def _close_images(a, b):
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert (a == b).mean() > 0.99


def test_roundtrip_matches_batch_sampler(trained, artifact):
    a = _live(trained).generate(6, seed=7)
    b = ExportedSampler(artifact, device="cpu").generate(6, seed=7)
    assert b.shape == (6, 16, 16, 3) and b.dtype == np.uint8
    _close_images(a, b)
    assert np.array_equal(a, b)


def test_index_stable_and_deterministic(artifact):
    s = ExportedSampler(artifact, device="cpu")
    a = s.generate(3, seed=5)
    b = s.generate(6, seed=5)
    np.testing.assert_array_equal(a, b[:3])
    np.testing.assert_array_equal(
        b, ExportedSampler(artifact, device="cpu").generate(6, seed=5))
    assert not np.array_equal(b, s.generate(6, seed=6))


def test_generate_from_z_and_psi(trained, artifact):
    live = _live(trained)
    s = ExportedSampler(artifact, device="cpu")
    z = live.latents(6, seed=3)          # n not a multiple of batch
    a = live.generate_from_z(z, psi=0.3)
    b = s.generate_from_z(z, psi=0.3)
    _close_images(a, b)
    # psi is an input: one program serves every truncation
    c = s.generate_from_z(z, psi=1.0)
    assert not np.array_equal(b, c)
    _close_images(live.generate_from_z(z, psi=1.0), c)


def _program_images(s, zs, noise_seeds, n):
    """The sampler's own device output (``_forward``) for the padded latent
    batches ``zs``, each copied to the host as it is and made C-contiguous
    there, trimmed to ``n``."""
    out = [np.ascontiguousarray(
        s._forward(z, ns, s._default_psi).cpu().numpy())
        for z, ns in zip(zs, noise_seeds)]
    return np.concatenate(out, axis=0)[:n]


@pytest.mark.parametrize("kind,n", [
    pytest.param(kind, n, id=str(n) if kind == "exported" else f"{kind}-{n}")
    for kind in ("exported", "batch_sampler") for n in (3, 4, 7)])
def test_result_is_contiguous_and_the_callers_own(trained, artifact, kind,
                                                  n):
    """For n of batch - 1, batch and 2 batch - 1 (batch 4), through
    ``generate`` and ``generate_from_z`` of the exported sampler and of
    ``BatchSampler`` on the same state: the result is a C-contiguous uint8
    (n, H, W, 3), bit-equal to the sampler's own device output made
    contiguous, and an array kept over three later requests is left as it
    was (no buffer is reused under the caller)."""
    s = ExportedSampler(artifact, device="cpu") if kind == "exported" \
        else _live(trained)
    dim = SETS["model.latent_dim"]
    B, nb = s.batch_size, -(-n // s.batch_size)
    z = np.random.RandomState(n).randn(n, dim).astype(np.float32)
    padded = np.zeros((nb * B, dim), np.float32)
    padded[:n] = z
    calls = {
        "generate": (
            lambda: s.generate(n, seed=9),
            [stream_latents(B, dim, seed=9, start=b * B)
             for b in range(nb)],
            [stream_seed(9, _NOISE_STREAM, b) for b in range(nb)]),
        "generate_from_z": (
            lambda: s.generate_from_z(z, noise_seed=2),
            list(padded.reshape(nb, B, dim)),
            [stream_seed(2, b) for b in range(nb)]),
    }
    for name, (call, zs, noise_seeds) in calls.items():
        got = call()
        assert got.dtype == np.uint8 and got.shape == (n, 16, 16, 3), name
        assert got.flags["C_CONTIGUOUS"], name
        np.testing.assert_array_equal(got, _program_images(s, zs,
                                                           noise_seeds, n))
        kept = got.copy()
        for seed in range(3):
            s.generate(n, seed=100 + seed)
        np.testing.assert_array_equal(got, kept)


def test_meta_and_version_check(artifact, tmp_path):
    with zipfile.ZipFile(artifact) as zf:
        meta = json.loads(zf.read("meta.json"))
        names = sorted(zf.namelist())
    assert names == ["meta.json", "sampler_cpu.pt2"]
    assert {"format_version", "model", "resolution", "res_log2",
            "latent_dim", "batch_size", "default_psi",
            "platforms"} <= set(meta)
    assert meta["format_version"] == FORMAT_VERSION
    assert meta["resolution"] == 16 and meta["batch_size"] == 4
    assert meta["platforms"] == ["cpu"] and meta["model"] == "stylegan"
    assert meta["noise_shapes"] == [[4, 4], [4, 4], [8, 8], [8, 8],
                                    [16, 16], [16, 16]]
    bad = str(tmp_path / "bad.zip")
    with zipfile.ZipFile(artifact) as src, zipfile.ZipFile(bad, "w") as dst:
        for name in src.namelist():
            data = src.read(name)
            if name == "meta.json":
                data = json.dumps(dict(json.loads(data),
                                       format_version=99)).encode()
            dst.writestr(name, data)
    with pytest.raises(ValueError, match="version"):
        ExportedSampler(bad, device="cpu")
    with pytest.raises(ValueError, match="no program for cuda"):
        ExportedSampler(artifact, device="cuda")


def test_default_platforms_without_a_card(trained, tmp_path):
    """The default ("cuda", "cpu") exports the cpu program alone where no
    card is present, and says so."""
    if torch.cuda.is_available():
        pytest.skip("needs a host without a card")
    cfg, _, state = trained
    path = str(tmp_path / "multi.zip")
    with pytest.warns(UserWarning, match="no CUDA device"):
        export_sampler(cfg, state, path, batch_size=2)
    s = ExportedSampler(path, device="cpu")
    assert s.meta["platforms"] == ["cpu"]
    assert s.generate(2, seed=0).shape == (2, 16, 16, 3)


def _cli_args(wd, out):
    args = ["export", "--workdir", wd, "--out", out, "--batch", "4",
            "--platforms", "cpu", "--device", "cpu"]
    for k, v in SETS.items():
        args += ["--set", f"{k}={v}"]
    return args


def test_cli_export(trained, tmp_path, capsys):
    from ganlab_tpu_torch.cli import main

    _, wd, _ = trained
    out = str(tmp_path / "cli_artifact.zip")
    assert main(_cli_args(wd, out)) == 0
    text = capsys.readouterr().out
    assert "exported:" in text and "WARNING" not in text
    imgs = ExportedSampler(out, device="cpu").generate(2, seed=0)
    assert imgs.shape == (2, 16, 16, 3)
    # an untrained workdir exports a fresh generator, with the warning
    fresh = str(tmp_path / "fresh.zip")
    assert main(_cli_args(str(tmp_path / "empty"), fresh)) == 0
    assert "WARNING: no checkpoint found; exporting" in \
        capsys.readouterr().out


OPS = {
    "pixel_norm": (pixelnorm.PIXEL_NORM, lambda: (torch.randn(3, 8), 1e-8)),
    "pixel_norm_nchw": (pixelnorm.PIXEL_NORM_NCHW,
                        lambda: (torch.randn(2, 8, 4, 4), 1e-8)),
    "adain": (adain.ADAIN, lambda: (torch.randn(2, 8, 4, 4),
                                    torch.randn(2, 8), torch.randn(2, 8),
                                    1e-8)),
    "upsample_blur_2x": (resample.UPSAMPLE_BLUR_2X,
                         lambda: (torch.randn(2, 3, 5, 4), 0.5)),
    "blur_downsample_2x": (resample.BLUR_DOWNSAMPLE_2X,
                           lambda: (torch.randn(2, 3, 6, 4), 4.0)),
    "minibatch_stddev": (mbstd.MINIBATCH_STDDEV,
                         lambda: (torch.randn(4, 8, 4, 4), 1e-8)),
}
PLAIN = {"pixel_norm": pixelnorm.pixel_norm_ref,
         "pixel_norm_nchw": pixelnorm.pixel_norm_nchw_ref,
         "adain": adain.adain_ref,
         "upsample_blur_2x": resample.upsample_blur_2x_ref,
         "blur_downsample_2x": resample.blur_downsample_2x_ref,
         "minibatch_stddev": mbstd.minibatch_stddev_ref}


@pytest.mark.parametrize("name", list(OPS))
def test_operator_fake_and_cpu_implementations(name):
    """opcheck (schema, fake implementation against the CPU one, the
    dispatcher's checks); on a CPU tensor the operator is the plain
    version bit for bit, and under FakeTensorMode it gives the shape."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    op, make = OPS[name]
    args = make()
    assert op.name() == f"ganlab::{name}"
    torch.library.opcheck(op, args)
    assert torch.equal(op(*args), PLAIN[name](*args))
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                for a in args]
        out = op(*fake)
    assert out.shape == PLAIN[name](*args).shape


def test_exported_graph_calls_the_operators(trained):
    """The program holds the ganlab operators, not their plain versions'
    ATen calls: loaded on the card it launches the kernels."""
    from ganlab_tpu_torch.export import _Sampler
    from ganlab_tpu_torch.models import noise_shapes
    from ganlab_tpu_torch.sample import build_sample_fn

    cfg, _, state = trained
    module = _Sampler(state.g_ema, state.w_avg, build_sample_fn(cfg, 4))
    args = (torch.zeros(2, 16), [torch.zeros(2, 1, h, w)
                                 for h, w in noise_shapes(cfg.model, 4)],
            torch.tensor(0.7))
    with torch.no_grad():
        program = torch.export.export(module, args)
    called = {str(n.target) for n in program.graph.nodes
              if n.op == "call_function"}
    assert {"ganlab.pixel_norm.default", "ganlab.adain.default",
            "ganlab.upsample_blur_2x.default"} <= called


@pytest.mark.gpu
def test_cuda_program_launches_the_kernels(trained, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    cfg, _, state = trained
    path = str(tmp_path / "cuda.zip")
    export_sampler(cfg, state, path, batch_size=4, platforms=("cuda",))
    s = ExportedSampler(path)
    counts = (pixelnorm.pixel_norm_cuda, adain.adain_cuda,
              resample.upsample_blur_2x_cuda)
    before = [f.launches for f in counts]
    imgs = s.generate(4, seed=1)
    assert [f.launches - b for f, b in zip(counts, before)] == [1, 6, 2]
    live = BatchSampler(cfg, state=state, batch_size=4)
    _close_images(live.generate(4, seed=1), imgs)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["exported", "batch_sampler"])
def test_cuda_result_is_page_locked_and_its_block_reused(trained, tmp_path,
                                                         kind):
    """On the card, on either sampler, a one-batch request's array is
    page-locked and C-contiguous, bit-equal to the sampler's device output
    copied as it is and made contiguous on the host; arrays kept survive
    later requests, and once the caller drops them their blocks serve the
    next requests (torch's host cache pins no new block)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (page-locked memory is the card's)")
    cfg, _, state = trained
    if kind == "exported":
        path = str(tmp_path / "cuda.zip")
        export_sampler(cfg, state, path, batch_size=4, platforms=("cuda",))
        s = ExportedSampler(path)
    else:
        s = BatchSampler(cfg, state=state, batch_size=4)
    a = s.generate(4, seed=1)
    assert a.flags["C_CONTIGUOUS"] and torch.from_numpy(a).is_pinned()
    np.testing.assert_array_equal(a, _program_images(
        s, [stream_latents(4, SETS["model.latent_dim"], seed=1)],
        [stream_seed(1, _NOISE_STREAM, 0)], 4))
    kept = a.copy()
    held = [s.generate(4, seed=2 + i) for i in range(3)]
    np.testing.assert_array_equal(a, kept)
    assert all(torch.from_numpy(h).is_pinned() for h in held)
    del a, held
    before = torch.cuda.host_memory_stats()["num_host_alloc"]
    for i in range(3):
        assert torch.from_numpy(s.generate(4, seed=10 + i)).is_pinned()
    assert torch.cuda.host_memory_stats()["num_host_alloc"] == before
