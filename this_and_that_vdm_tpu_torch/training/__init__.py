"""EDM finetuning of the port (VL and VGL), counterpart of ``training/``."""
