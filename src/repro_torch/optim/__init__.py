"""AdamW and gradient compression over named tensors (port of
``repro.optim``)."""
