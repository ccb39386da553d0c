"""Training (port of ``repro/train/``): optimizers, the train state and its
steps, the int8 error-feedback all-reduce and the loop."""
