"""Score/label dict flattening. The port's own copy of
shotvae_tpu/utils/score_label.py:16-31 (the reference's
lib/utils/utils.py:8-21, which no driver imports): two key-aligned dicts of
lists (per-key scores, per-key labels, e.g. the crops of one image scored
apart) collapse into flat max-pooled arrays for sklearn-style metrics.
"""

from __future__ import annotations

import numpy as np


def get_score_label_array_from_dict(score_dict, label_dict):
    """Max-pool each key's score and label lists into aligned 1-D arrays.

    Keys are taken in ``score_dict``'s order and looked up in
    ``label_dict``: a key missing there raises ``KeyError`` (or, for a
    ``defaultdict``, makes an entry), as in the reference."""
    if len(score_dict) != len(label_dict):
        raise AssertionError("The score_dict and label_dict don't match")
    score = np.ones(len(score_dict))
    label = np.ones(len(label_dict))
    for idx, (key, scores) in enumerate(score_dict.items()):
        label[idx] = max(label_dict[key])
        score[idx] = max(scores)
    return score, label
