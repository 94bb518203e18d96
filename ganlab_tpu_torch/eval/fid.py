"""Feature-space metrics of a generator: FID, KID, precision and recall.

Port of ``ganlab_tpu/eval/fid.py``. The statistics are numpy (float64), as
there, so the same features give the same scores:

FID(r, f) = ||mu_r - mu_f||^2 + Tr(S_r + S_f - 2 sqrtm(S_r S_f))

Features come from an extractor, an ``nn.Module`` that maps an NCHW batch
in [-1, 1] on its device to (N, D) features: ``InceptionExtractor``
(``eval/inception.py``: pool3, weights from ``$GANLAB_INCEPTION_WEIGHTS``)
or, without weights, ``RandomConvExtractor``, a deterministic random CNN
with the JAX package's numpy-seeded weights (relative trends only).
"""

from __future__ import annotations

import hashlib
import math
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

WEIGHTS_ENV = "GANLAB_INCEPTION_WEIGHTS"


def compute_statistics(features) -> tuple[np.ndarray, np.ndarray]:
    """(N, D) features -> (mu (D,), sigma (D, D)) with unbiased covariance."""
    feats = np.asarray(features, np.float64)
    mu = feats.mean(axis=0)
    sigma = np.cov(feats, rowvar=False)
    return mu, np.atleast_2d(sigma)


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """The FID formula, Tr sqrtm(S1 S2) by the symmetric PSD route:
    Tr sqrtm(S1 S2) = sum sqrt(eig(S1^1/2 S2 S1^1/2)), with eigenvalues
    that roundoff makes negative clipped at 0 (the covariances are
    rank-deficient when N < D). ``eps`` is kept for the API; clipping
    subsumes it."""
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    sigma1 = np.atleast_2d(np.asarray(sigma1, np.float64))
    sigma2 = np.atleast_2d(np.asarray(sigma2, np.float64))

    diff = mu1 - mu2
    w1, v1 = np.linalg.eigh((sigma1 + sigma1.T) / 2.0)
    root1 = (v1 * np.sqrt(np.clip(w1, 0.0, None))) @ v1.T
    inner = root1 @ sigma2 @ root1
    wm = np.linalg.eigvalsh((inner + inner.T) / 2.0)
    tr_covmean = float(np.sum(np.sqrt(np.clip(wm, 0.0, None))))
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * tr_covmean)


def compute_fid(real_features, fake_features) -> float:
    mu_r, s_r = compute_statistics(real_features)
    mu_f, s_f = compute_statistics(fake_features)
    return frechet_distance(mu_r, s_r, mu_f, s_f)


def compute_kid(real_features, fake_features, subset_size: int = 1000,
                num_subsets: int = 10, seed: int = 0) -> float:
    """Kernel Inception Distance (Binkowski et al. 2018): the unbiased
    MMD^2 with the kernel k(x, y) = (x.y/d + 1)^3, averaged over random
    subsets (numpy's generator seeded by ``seed``)."""
    rng = np.random.default_rng(seed)
    x = np.asarray(real_features, np.float64)
    y = np.asarray(fake_features, np.float64)
    d = x.shape[1]
    m = min(subset_size, x.shape[0], y.shape[0])

    vals = []
    for _ in range(num_subsets):
        xs = x[rng.choice(x.shape[0], m, replace=False)]
        ys = y[rng.choice(y.shape[0], m, replace=False)]
        k_xx = (xs @ xs.T / d + 1.0) ** 3
        k_yy = (ys @ ys.T / d + 1.0) ** 3
        k_xy = (xs @ ys.T / d + 1.0) ** 3
        np.fill_diagonal(k_xx, 0.0)
        np.fill_diagonal(k_yy, 0.0)
        mmd2 = (k_xx.sum() + k_yy.sum()) / (m * (m - 1)) \
            - 2.0 * k_xy.mean()
        vals.append(mmd2)
    return float(np.mean(vals))


def compute_precision_recall(real_features, fake_features,
                             k: int = 3) -> tuple[float, float]:
    """Improved precision and recall (Kynkaanniemi et al. 2019), k-NN
    manifolds: precision = share of fakes inside the real manifold,
    recall = share of reals inside the fake manifold."""
    def _pairwise(a, b):
        a2 = np.sum(a * a, axis=1)[:, None]
        b2 = np.sum(b * b, axis=1)[None, :]
        d2 = a2 + b2 - 2.0 * (a @ b.T)
        return np.sqrt(np.maximum(d2, 0.0))

    def _knn_radii(feats, k):
        d = _pairwise(feats, feats)
        np.fill_diagonal(d, np.inf)
        return np.partition(d, k - 1, axis=1)[:, k - 1]

    x = np.asarray(real_features, np.float64)
    y = np.asarray(fake_features, np.float64)
    r_real = _knn_radii(x, k)
    r_fake = _knn_radii(y, k)
    d_fr = _pairwise(y, x)
    precision = float(np.mean(np.any(d_fr <= r_real[None, :], axis=1)))
    recall = float(np.mean(np.any(d_fr.T <= r_fake[None, :], axis=1)))
    return precision, recall


def same_pad(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """Zero padding of TF/XLA's "SAME" for a k x k window at ``stride``:
    the total is split with the extra row/column at the end, so a stride-2
    3x3 conv on an even size pads (0, 1), not (1, 1)."""
    pads = []
    for n in (x.shape[3], x.shape[2]):          # F.pad order: W, then H
        total = max((math.ceil(n / stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class RandomConvExtractor(nn.Module):
    """Deterministic random-weight CNN features (tests, and a weights-free
    relative metric): 4 stride-2 3x3 convs with LeakyReLU(0.2), then the
    spatial mean and max -> ``dim`` features. The weights are the JAX
    package's, drawn by numpy from ``seed`` (HWIO there, OIHW here)."""

    name = "random_conv"
    pretrained = False

    def __init__(self, dim: int = 256, seed: int = 0):
        super().__init__()
        self.dim = dim
        rng = np.random.default_rng(seed)
        chans = [3, 32, 64, 128, dim // 2]
        for i, (cin, cout) in enumerate(zip(chans[:-1], chans[1:])):
            w = (rng.standard_normal((3, 3, cin, cout)).astype(np.float32)
                 * np.sqrt(2.0 / (9 * cin))).astype(np.float32)
            self.register_buffer(
                f"w{i}", torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))
        self.num_layers = len(chans) - 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, 3, H, W) in [-1, 1] -> (N, dim) float32."""
        x = x.float()
        for i in range(self.num_layers):
            x = F.conv2d(same_pad(x, 3, 2), getattr(self, f"w{i}"),
                         stride=2)
            x = torch.maximum(x, 0.2 * x)
        return torch.cat([x.mean(dim=(2, 3)), x.amax(dim=(2, 3))], dim=1)


def get_extractor(weights_path: str | None = None) -> nn.Module:
    """Pretrained Inception if weights are available, else random features."""
    path = weights_path or os.environ.get(WEIGHTS_ENV)
    if path and os.path.exists(path):
        from ganlab_tpu_torch.eval.inception import InceptionExtractor

        return InceptionExtractor(weights_path=path)
    return RandomConvExtractor()


@torch.inference_mode()
def extract(extractor: nn.Module, images: torch.Tensor) -> np.ndarray:
    """Features of an NCHW batch in [-1, 1], on the extractor's device, as
    a float32 numpy array."""
    dev = next(iter(extractor.buffers()), None)
    if dev is not None:
        images = images.to(dev.device)
    return extractor(images).float().cpu().numpy()


def real_batch(u8: np.ndarray, device) -> torch.Tensor:
    """A uint8 NHWC batch of a data source -> NCHW float32 in [-1, 1]."""
    x = torch.from_numpy(np.ascontiguousarray(u8)).to(device)
    return x.permute(0, 3, 1, 2).float() / 127.5 - 1.0


def evaluate_checkpoint_metrics(cfg, workdir: str, num_samples: int = 10000,
                                extractor=None, source=None,
                                batch: int = 64,
                                metrics: tuple = ("fid",),
                                cache_real: bool = True,
                                device="cuda") -> dict:
    """Feature-space metrics (``fid`` / ``kid`` / ``pr``) between G-EMA
    samples of the latest checkpoint and the dataset. The real features
    are cached under ``<workdir>/fid_cache`` (``_real_cache_path``), so
    another evaluation of the run pays only the generator's half."""
    real, fake = _collect_features(cfg, workdir, num_samples, extractor,
                                   source, batch, cache_real=cache_real,
                                   device=device)
    out = {}
    if "fid" in metrics:
        out["fid"] = compute_fid(real, fake)
    if "kid" in metrics:
        out["kid"] = compute_kid(real, fake)
    if "pr" in metrics:
        out["precision"], out["recall"] = compute_precision_recall(real,
                                                                   fake)
    return out


def evaluate_checkpoint_fid(cfg, workdir: str, num_samples: int = 10000,
                            extractor=None, source=None, batch: int = 64,
                            device="cuda") -> float:
    """FID between G-EMA samples of the latest checkpoint and the dataset."""
    real, fake = _collect_features(cfg, workdir, num_samples, extractor,
                                   source, batch, device=device)
    return compute_fid(real, fake)


def _real_cache_path(cfg, workdir: str, extractor, num_samples: int) -> str:
    """The key covers everything that changes the real features: the
    extractor and whether pretrained weights loaded, the dataset and its
    directory, the resolution, the sample count and the seed (the JAX
    package's key, so both packages name a cache alike)."""
    ident = (f"{getattr(extractor, 'name', 'extractor')}_"
             f"{'pre' if getattr(extractor, 'pretrained', False) else 'rand'}"
             f"_{cfg.data.dataset}_{cfg.data.data_dir or ''}")
    h = hashlib.sha1(ident.encode()).hexdigest()[:12]
    tag = f"{h}_{cfg.model.resolution}_n{num_samples}_s{cfg.run.seed}"
    return os.path.join(workdir, "fid_cache", f"real_{tag}.npz")


def _collect_features(cfg, workdir: str, num_samples: int, extractor,
                      source, batch: int, cache_real: bool = True,
                      step: int | None = None, psi: float = 1.0,
                      device="cuda"):
    """(real, fake) features for the metrics above. ``psi`` 1.0: the FID
    protocol samples without truncation. ``step`` picks a kept checkpoint
    (None: the latest)."""
    from ganlab_tpu_torch.data import make_source
    from ganlab_tpu_torch.sample import build_sample_fn
    from ganlab_tpu_torch.train.checkpoint import CheckpointManager
    from ganlab_tpu_torch.train.state import create_train_state
    from ganlab_tpu_torch.utils.latents import gen_latents

    extractor = (extractor or get_extractor()).to(device).eval()
    if not getattr(extractor, "pretrained", False):
        print("WARNING: no Inception weights "
              f"(set ${WEIGHTS_ENV}); FID uses random features, valid for "
              "relative comparison only", flush=True)

    state = create_train_state(cfg, seed=cfg.run.seed, device=device)
    ckpt = CheckpointManager(os.path.join(workdir, cfg.run.checkpoint_dir))
    try:
        if ckpt.restore(state, step=step) is None:
            raise FileNotFoundError(f"no checkpoint under {workdir}")
    finally:
        ckpt.close()

    cache_path = _real_cache_path(cfg, workdir, extractor, num_samples)
    real_cached = None
    if cache_real and os.path.exists(cache_path):
        real_cached = np.load(cache_path)["features"]
        print(f"real-feature cache hit: {cache_path}", flush=True)
    if real_cached is None:
        source = source or make_source(cfg.data, cfg.model.resolution,
                                       seed=cfg.run.seed + 99)

    sample = build_sample_fn(cfg, cfg.model.res_log2)
    gen = torch.Generator(device=state.device).manual_seed(cfg.run.seed + 7)
    fake_feats, real_feats = [], []
    done = 0
    while done < num_samples:
        b = min(batch, num_samples - done)
        z = gen_latents(gen, b, cfg.model.latent_dim)
        with torch.inference_mode():
            fake = sample(state.g_ema, state.w_avg, z, gen, psi, 1.0)
        fake_feats.append(extract(extractor, fake))
        if real_cached is None:
            real = source.batch(b, cfg.model.resolution)
            real_feats.append(extract(extractor, real_batch(real, device)))
        done += b

    if real_cached is None:
        real_cached = np.concatenate(real_feats)
        if cache_real:
            os.makedirs(os.path.dirname(cache_path), exist_ok=True)
            np.savez_compressed(cache_path, features=real_cached)
    return real_cached, np.concatenate(fake_feats)
