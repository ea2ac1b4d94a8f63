"""Serving bundles: one program per (batch, seconds) bucket."""

from pytorch_end2end_speech_recognition_tpu_torch.serving.export import (  # noqa: F401
    ServingBundle,
    export_bundle,
    load_bundle,
)
