"""Data: file pairing and splits, the host dataset, the prefetching
loader and the on-device augmentation (counterpart of
cartseg_tpu/data)."""
