"""Models: the Conformer encoder, the transformer decoder and the ASR model."""
