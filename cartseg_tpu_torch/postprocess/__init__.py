"""Mask post-processing (reference L6) and dataset plumbing (L8): the
cleaners on the device, and host file tooling."""

from cartseg_tpu_torch.postprocess.clean import (
    clean_mask, clean_mask_largest_component, post_clean,
    clean_tree, CleanConfig,
)
from cartseg_tpu_torch.postprocess.unpad import (
    unpad_mask_to_original, unpad_tree, make_overlay,
)
from cartseg_tpu_torch.postprocess.plumbing import (copy_matching_images,
                                                    copy_masks)

__all__ = [
    "clean_mask", "clean_mask_largest_component", "post_clean",
    "clean_tree", "CleanConfig",
    "unpad_mask_to_original", "unpad_tree", "make_overlay",
    "copy_matching_images", "copy_masks",
]
