"""Dialog-dataset collator (legacy av_dialog_dataset path).

The port's copy of ``avsr_tpu/data/dialog_dataset.py``, over the port's own
modules (it imports nothing of the JAX package).

The reference ships a third collator variant
(src/dataset/av_dialog_dataset.py:279-306) that neither entry
point imports: a torchvision.io-based clone of the main avhubert collator
that (a) always decodes the full file (no start/end_time) and (b) prefers a
``.wav`` sidecar over embedded audio. Both behaviors are native to this
framework's media layer (data/media.py probes the wav sidecar among its
audio backends), so the port is a thin configuration of the main collator
rather than a duplicate pipeline.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from avsr_tpu_torch.data.collate import DataCollator


@dataclass
class DialogDataCollator(DataCollator):
    """DataCollator that ignores segment times: full-file dialog samples."""

    def __call__(self, features: List[Dict]) -> Dict[str, np.ndarray]:
        full = [
            {k: v for k, v in f.items() if k not in ("start_time", "end_time")}
            for f in features
        ]
        return super().__call__(full)
