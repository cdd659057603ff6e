"""Deployment and serving (counterpart of cartseg_tpu/serve):

  * export.py - a trained checkpoint compiled into a self-contained
    `torch.export` artifact (weights embedded, the threshold from the
    `.threshold.json` sidecar recorded in the manifest);
  * server.py - a micro-batching segmentation server over an artifact:
    letterbox -> device batch -> threshold -> inverse letterbox, with a
    Python API, a directory batch mode and a stdlib HTTP endpoint
    (POST /segment, PNG or JPEG in -> PNG mask out).
"""

from cartseg_tpu_torch.serve.export import (
    export_segmenter, load_segmenter, ServedSegmenter, validate_manifest,
)
from cartseg_tpu_torch.serve.server import MicroBatcher, SegmentationService

__all__ = [
    "export_segmenter", "load_segmenter", "ServedSegmenter",
    "validate_manifest", "MicroBatcher", "SegmentationService",
]
