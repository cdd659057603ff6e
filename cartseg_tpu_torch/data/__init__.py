"""Data: file pairing and splits, the host dataset, mixed-source
sampling, the prefetching loader and the on-device augmentation
(counterpart of cartseg_tpu/data)."""
