"""Offline AV preprocessing: the port of ``avsr_tpu/frontends/``.

Face detection (``retinaface``, ``s3fd``), landmarks (``fan``), the mouth
crops (``video_process``), tracking and head pose (``tracker``,
``headpose``), active-speaker scores (``asd``, ``asd_trainer``) and the
ASD segmentation and speaker clustering the eval CLI reads
(``segmentation``, ``cluster``). The networks run on the card unless a
caller passes ``device="cpu"``; ``weights`` carries the JAX package's
variables across.
"""
