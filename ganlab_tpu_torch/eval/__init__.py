"""Evaluation of the port: FID, KID, precision/recall and PPL.

The statistics are numpy, as in the JAX package; the feature extractors
are ``nn.Module``s that run on the generator's device:

* ``InceptionExtractor``: pytorch-fid's InceptionV3 pool3 (2048-d), with
  torchvision ``state_dict`` names; weights from a file
  (``$GANLAB_INCEPTION_WEIGHTS``), nothing is downloaded.
* ``RandomConvExtractor``: a deterministic random-feature CNN for tests and
  relative trends when no weights are at hand.

Perceptual path length (``eval/ppl.py``) measures over the LPIPS distance
of a VGG16 (``eval/lpips.py``; weights from ``$GANLAB_LPIPS_WEIGHTS``, else
a deterministic random VGG16).
"""

from ganlab_tpu_torch.eval.fid import (
    RandomConvExtractor,
    compute_fid,
    compute_kid,
    compute_precision_recall,
    compute_statistics,
    evaluate_checkpoint_fid,
    evaluate_checkpoint_metrics,
    frechet_distance,
    get_extractor,
)
from ganlab_tpu_torch.eval.inception import InceptionExtractor
from ganlab_tpu_torch.eval.lpips import LPIPSDistance, lpips_distance
from ganlab_tpu_torch.eval.ppl import compute_ppl, evaluate_checkpoint_ppl
