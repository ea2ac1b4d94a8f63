"""Corpus converters (the port of the JAX package's `data/prep/`): a corpus
tree already on local disk -> JSONL manifests (`data/manifest.py`). They
download nothing."""
