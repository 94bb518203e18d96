"""Evaluation of the port: FID, KID and precision/recall of a generator.

The statistics are numpy, as in the JAX package; the feature extractors
are ``nn.Module``s that run on the generator's device:

* ``InceptionExtractor``: pytorch-fid's InceptionV3 pool3 (2048-d), with
  torchvision ``state_dict`` names; weights from a file
  (``$GANLAB_INCEPTION_WEIGHTS``), nothing is downloaded.
* ``RandomConvExtractor``: a deterministic random-feature CNN for tests and
  relative trends when no weights are at hand.
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
