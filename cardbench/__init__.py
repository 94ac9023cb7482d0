"""The benchmark of ``bbcat_dsp_torch`` on the card: see ``run.py``."""
