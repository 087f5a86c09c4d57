"""Host-side utilities: running meters, pairwise distance metrics and the
score/label dict flattening."""

from shotvae_torch.utils import dist_metrics
from shotvae_torch.utils.meters import AverageMeter, MetricAccumulator
from shotvae_torch.utils.score_label import get_score_label_array_from_dict

__all__ = ["AverageMeter", "MetricAccumulator", "dist_metrics",
           "get_score_label_array_from_dict"]
