"""Training: the composite loss and the train step (port of
``repro/train``)."""
