"""Models: the Conformer encoder and the CTC ASR model."""
