"""Training (counterpart of ``avsr_tpu/train``)."""
