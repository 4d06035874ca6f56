"""Dataset constants (a copy of the JAX package's ``data/constants.py``)."""

PRETRAINED_BERT_DIM = 768
PRETRAINED_MILAN_DIM = 1792
COCO_MAX_TEXT_LENGTH = 17
# Localized Narratives captions are much longer.
LN_MAX_TEXT_LENGTH = 64
