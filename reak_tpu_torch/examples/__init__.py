"""The port's example command lines (port of the repo's ``examples/``):
``python -m reak_tpu_torch.examples.<name>``, on the card unless
``--device`` says otherwise."""
