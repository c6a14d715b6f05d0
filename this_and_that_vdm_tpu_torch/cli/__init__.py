"""Entry points of the port: batch inference, evaluation, the weights
rehearsal and the sampler sweep (``python -m this_and_that_vdm_tpu_torch.cli.<name>``)."""
